"""repro_torch's MobileNetV2 against the JAX package's, on the same
parameters (``init_mobilenetv2(PRNGKey(0))`` through ``repro_torch.convert``)
and the same batch of 2 images at 32 x 32.

Tolerances, with PSG off (fp32 everywhere, sums in other orders):

* logits within ``1e-4`` of their largest magnitude (measured 1.5e-5), the
  loss within ``1e-5`` relative (measured 1.5e-6), the eval-mode logits
  likewise (measured 7.2e-6);
* the BatchNorm running statistics within ``1e-4`` of each tensor's largest
  magnitude plus ``1e-6``: the running means of a BatchNorm that follows a
  conv of a normalized input are zero up to rounding (about 3e-8), and
  differ by as much again;
* every parameter gradient within ``GRAD_REL`` of its own norm (L2) plus
  ``GRAD_ABS``.  At batch 2 the BatchNorms normalize 32 positions at the
  4 x 4 stages, and the gradient is ill-conditioned in fp32: against the
  float64 gradient of the same network, the port's fp32 gradient is off by
  up to 1.3% of a tensor's norm and the JAX package's (jitted) by up to
  4%; the two differ by at most 4.5% (``blocks.0.bn1.scale``).  Each
  ``bn3.bias`` gradient is zero in exact arithmetic (a train-mode
  BatchNorm's input gradient sums to zero over the batch, and every block
  output reaches one) and is about 1e-6 of rounding in both packages: the
  absolute term.

With PSG on, each conv's ``(y, dx, dw)`` is held against ``jax.vjp`` of the
JAX package's ``psg.conv2d`` on its conv kernels (in interpret mode) at
every one of the 21 conv geometries, on the input and output gradient that
conv saw in a PSG step of the port: ``dw`` (the Eq. (2) signs) equal, ``y``
and ``dx`` within ``5e-5`` of their largest magnitude (fp32 sums of up to
1,280 terms in another order; measured at most 1.2e-5, the 64->384 conv's
dx, and 6e-7 elsewhere).  The JAX kernels sum the integer codes in fp32,
exact while the sum of ``|x||g|`` stays below 2**24; at 11 of the 21 sites
it does not, and the signs agree all the same (no element's sum falls
within that rounding of zero).  The JAX package's reference backend is no
per-element yardstick here: it compares the predictor with its threshold
in scaled floats, so a predictor exactly at ``tau`` (the 384->96 conv has
two) can fall on the other side, and it sums the full product in scaled
floats, so a sum that is exactly 0 can come out signed.

The whole network's signs are not comparable element by element at this
size: the 8-bit forward codes flip between the two summation orders, and
one flip reaches every later code, so that even a relative change of 1e-6
of the image moves most signs of the port's own gradient; with PSG off
the two packages' signs agree almost everywhere.  The whole-network PSG loss is held within
``PSG_LOSS_REL`` (measured 1.1%).

The trainer under ``--e2train full``'s config (SMD, SLU on with no gate to
drive, PSG with SWA): the chunked loop (K=4) equals the per-step loop bit
for bit; the energy report equals the JAX package's ledger on the same
history; checkpoints cross-load with the JAX package both ways; the
launcher and the Tab. 4 benchmark run on the CPU.
"""
import copy
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import paper_cnns as jpaper  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import mobilenet_cost as jmobilenet_cost  # noqa: E402
from repro.core.ledger import EnergyLedger as JLedger  # noqa: E402
from repro.core.smd import smd_schedule as jsmd_schedule  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim.swa import swa_init as jswa_init  # noqa: E402
from repro.training.train_step import TrainState as JTrainState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.paper_cnns import (cnn_model,  # noqa: E402
                                            mobilenet_conv_shapes)
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.core.cost import cnn_cost  # noqa: E402
from repro_torch.data.synthetic import GaussianImageTask, make_image_batch  # noqa: E402
from repro_torch.ft.checkpoint import (_flatten, restore_checkpoint,  # noqa: E402
                                       save_checkpoint, verify_checkpoint)
from repro_torch.launch import bench_cnn, train  # noqa: E402
from repro_torch.models.resnet import (MobileNetV2, depthwise,  # noqa: E402
                                       mobilenetv2_loss)
from repro_torch.tasks import get_task  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step)
from repro_torch.training.trainer import Trainer  # noqa: E402

BATCH = 2
PARAMS = 2_237_770
LOGIT_REL, LOSS_REL, BUF_REL, BUF_ABS = 1e-4, 1e-5, 1e-4, 1e-6
GRAD_REL, GRAD_ABS = 0.1, 1e-4
CONV_REL = 5e-5
PSG_LOSS_REL = 0.1
# the JAX package's conv kernels (in interpret mode) per conv, and its
# reference backend for the whole network, as its own tests run them
JKERNELS = jc.PSGConfig(enabled=True, fused_conv=True, backend="interpret")
JREF = jc.PSGConfig(enabled=True, fused_conv=True, backend="reference")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread each, as in ``test_torch_loop.py``: the trainer
    tests run many small steps beside a prefetch thread, and parallel test
    workers must not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_init():
    params, state = jax.jit(JR.init_mobilenetv2)(jax.random.PRNGKey(0))
    return _np(params), _np(state)


@pytest.fixture(scope="module")
def batch():
    r = np.random.RandomState(0)
    return {"image": r.randn(BATCH, 32, 32, 3).astype(np.float32),
            "label": r.randint(0, 10, (BATCH,)).astype(np.int32)}


def _port_model(jax_init):
    model = MobileNetV2()
    model.load_state_dict(convert.state_dict_from_jax(*jax_init))
    return model


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_ref(jax_init, batch):
    """One jitted call: train-mode loss, logits, new BatchNorm state and
    gradients with PSG off, and eval-mode logits with the new state."""
    params, state = jax_init

    @jax.jit
    def f(p, s, b):
        (loss, (_, new)), g = jax.value_and_grad(
            lambda p_: JR.mobilenetv2_loss(p_, s, b), has_aux=True)(p)
        logits, _ = JR.mobilenetv2_fwd(p, s, b["image"])
        ev, _ = JR.mobilenetv2_fwd(p, new, b["image"], train=False)
        return loss, logits, new, g, ev

    out = f(params, state, jax.tree.map(jnp.asarray, batch))
    return dict(zip(("loss", "logits", "state", "grads", "eval"), _np(out)))


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# parameters and cost
# ---------------------------------------------------------------------------


def test_convert_round_trips_every_leaf_in_jax_order(jax_init):
    params, state = jax_init
    model = _port_model(jax_init)
    for tree, named in ((params, dict(model.named_parameters())),
                        (state, dict(model.named_buffers()))):
        back = convert.jax_tree(named)
        assert isinstance(back["blocks"], list) and len(back["blocks"]) == 17
        jpaths, jleaves = zip(*jax.tree_util.tree_flatten_with_path(tree)[0])
        keys = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                for p in jpaths]
        paths, leaves = zip(*convert.leaves(back))
        assert list(paths) == keys          # "10" after "9", not after "1"
        for k, a, b in zip(keys, leaves, jleaves):
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    assert model.blocks[3].dw.shape == (9, 144)
    assert sum(p.numel() for p in model.parameters()) == PARAMS


def test_param_count_and_cost_equal_the_jax_package():
    t = cnn_cost(cnn_model("mobilenetv2", 0))
    j = jmobilenet_cost(jpaper.cnn_model("mobilenetv2", 0))
    assert t.param_count() == j.param_count() == PARAMS
    assert t.fwd_macs() == j.fwd_macs() == 90_697_728
    assert sum(p.numel() for p in MobileNetV2().parameters()) == PARAMS


def test_conv_geometries_are_the_36_sites():
    sites = mobilenet_conv_shapes(unique=False)
    unique = mobilenet_conv_shapes()
    assert (len(sites), len(unique)) == (36, 21)
    assert sites[0] == (128, 32, 3, 32, 3, 1)
    assert all(s.k == 1 and s.stride == 1 for s in sites[1:])
    assert sites[-1] == (128, 4, 320, 1280, 1, 1)
    layers = cnn_cost(cnn_model("mobilenetv2", 0)).layers
    convs = [l for l in layers if l.kind == "conv"]
    assert [s.hw * s.hw * s.k * s.k * s.cin * s.cout for s in sites] == \
        [l.macs for l in convs]


# ---------------------------------------------------------------------------
# PSG off: forward, backward and eval against the JAX package
# ---------------------------------------------------------------------------


def test_forward_backward_psg_off_match_jax(jax_init, batch, jax_ref):
    params, _ = jax_init
    model = _port_model(jax_init)
    tb = _torch(batch)
    logits, aux = copy.deepcopy(model)(tb["image"])
    loss, met = mobilenetv2_loss(model, tb)
    assert _rel(logits.detach(), jax_ref["logits"]) <= LOGIT_REL
    assert _rel(loss.detach(), jax_ref["loss"]) <= LOSS_REL
    assert float(met["slu_cost"]) == float(met["slu_exec_ratio"]) == 1.0
    assert aux["slu_executed"].numel() == 0
    want = convert.state_dict_from_jax(params, jax_ref["state"])
    for name, buf in model.named_buffers():
        ref = want[name].numpy()
        assert np.abs(buf.numpy() - ref).max() <= \
            BUF_REL * np.abs(ref).max() + BUF_ABS, name
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    jgrads = convert.state_dict_from_jax(jax_ref["grads"], jax_ref["state"])
    for name, g in zip(names, grads):
        ref = jgrads[name].numpy().astype(np.float64)
        err = np.linalg.norm(g.numpy() - ref)
        assert err <= GRAD_REL * np.linalg.norm(ref) + GRAD_ABS, name


def test_eval_logits_match_jax(jax_init, batch, jax_ref):
    params, _ = jax_init
    model = _port_model(jax_init)
    model.load_state_dict({**dict(model.named_parameters()),
                           **convert.state_dict_from_jax(params,
                                                         jax_ref["state"])})
    predict = get_task("cifar_cnn").make_predict(_full(4))
    logits = predict(model, _torch(batch))
    assert model.training
    assert _rel(logits, jax_ref["eval"]) <= LOGIT_REL


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_matches_jax(stride):
    r = np.random.RandomState(stride)
    x = r.randn(2, 8, 8, 5).astype(np.float32)
    w = r.randn(9, 5).astype(np.float32)
    gy = r.randn(2, 8 // stride, 8 // stride, 5).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b: JR._depthwise(b, a, stride),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = depthwise(xt, wt, stride)
    y.backward(torch.from_numpy(gy))
    for a, ref in ((y.detach(), jy), (xt.grad, jdx), (wt.grad, jdw)):
        assert a.shape == ref.shape
        assert _rel(a, ref) <= 1e-6


def test_relu6_gradient_at_its_kinks_matches_jax():
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jax.nn.relu6(a)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    F.relu6(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert xt.grad.tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# PSG on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def psg_sites(jax_init, batch):
    """``{geometry: (x, w, gy)}``: the input, weight and output gradient of
    the first conv at each geometry in one PSG step of the port, and the
    step's loss."""
    model = _port_model(jax_init)
    seen, hooks = [], []

    def hook(mod, args, out):
        entry = [args[0].detach().clone(), mod.w.detach().clone(), None]
        seen.append((mod.k, entry))
        out.register_hook(lambda g, e=entry: e.__setitem__(2, g.clone()))

    for mod in model.modules():
        if hasattr(mod, "k") and isinstance(getattr(mod, "w", None),
                                            torch.nn.Parameter):
            hooks.append(mod.register_forward_hook(hook))
    with tpsg.enable(PSGConfig(enabled=True), probe=tpsg.zero_probe()):
        loss, _ = mobilenetv2_loss(model, _torch(batch))
    loss.backward()
    for h in hooks:
        h.remove()
    assert len(seen) == 36
    sites = {}
    for k, (x, w, gy) in seen:
        sites.setdefault((x.shape[1], x.shape[3], w.shape[1], k), (x, w, gy))
    return sites, float(loss.detach())


GEOMETRIES = [(s.hw, s.cin, s.cout, s.k) for s in mobilenet_conv_shapes()]


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"{hw}x{ci}-{co}k{k}" for hw, ci, co, k in
                              GEOMETRIES])
def test_psg_conv_matches_jax_at_every_geometry(psg_sites, geometry):
    x, w, gy = psg_sites[0][geometry]
    k = geometry[3]

    def f(x_, w_, probe_):
        with jpsg.enable(JKERNELS, probe=probe_):
            return jpsg.conv2d(x_, w_, k=k, stride=1)

    @jax.jit
    def jvjp(x_, w_, g_):
        y, vjp = jax.vjp(f, x_, w_, jnp.zeros((2,)))
        return (y,) + vjp(g_)

    jy, jdx, jdw, _ = jvjp(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(gy.numpy()))
    xt = x.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    with tpsg.enable(PSGConfig(enabled=True), probe=tpsg.zero_probe()):
        y = tpsg.conv2d(xt, wt, k=k)
    y.backward(gy)
    assert _rel(y.detach(), jy) <= CONV_REL
    assert _rel(xt.grad, jdx) <= CONV_REL
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))


def test_psg_step_loss_matches_jax(jax_init, batch, psg_sites):
    params, state = jax_init

    @jax.jit
    def jloss(p, b):
        with jpsg.enable(JREF):
            return JR.mobilenetv2_loss(p, state, b)[0]

    want = float(jloss(params, jax.tree.map(jnp.asarray, batch)))
    assert abs(psg_sites[1] - want) <= PSG_LOSS_REL * abs(want)


# ---------------------------------------------------------------------------
# the trainer under --e2train full
# ---------------------------------------------------------------------------


def _full(steps):
    """``--e2train full`` on MobileNetV2 (psg at lr 0.03, SWA from half
    way), cut to batch 2 and ``steps``."""
    return train.experiment(0, 0, BATCH, steps, cnn="mobilenetv2")


def _mk():
    task = GaussianImageTask(snr=2.0)
    return lambda step, shard: make_image_batch(task, 0, step, shard, BATCH,
                                                "cpu")


def test_full_config_draws_no_uniforms_and_refuses_a_keep_mask():
    exp = _full(4)
    assert exp.e2.slu.enabled and exp.e2.psg.enabled and exp.e2.smd.enabled
    assert (exp.train.optimizer, exp.train.lr) == ("psg", 0.03)
    assert train.experiment(0, 0, 2, 4, e2=train.E2TRAIN["off"],
                            cnn="mobilenetv2").train.lr == 0.05
    assert get_task("cifar_cnn").slu_uniforms(exp, None).shape == (0,)
    state = init_train_state(exp, device="cpu")
    step = make_train_step(exp)
    assert step.host_inputs(state)[0] is None
    with pytest.raises(ValueError, match="keep mask"):
        step(state, _mk()(0, 0), keep=[True])


def test_chunked_matches_per_step_bitwise():
    steps = 12
    exp = _full(steps)
    a = Trainer(exp, init_train_state(exp, device="cpu"), _mk(),
                device="cpu")
    ha = a.run(steps)
    b = Trainer(exp, init_train_state(exp, device="cpu"), _mk(),
                device="cpu", chunk_steps=4)
    hb = b.run(steps)
    for key in ("step", "loss", "total_loss", "slu_executed"):
        assert [h[key] for h in ha] == [h[key] for h in hb], key
    assert (a.executed_steps, a.dropped_steps, a.state.step) == \
        (b.executed_steps, b.dropped_steps, b.state.step)
    assert a.dropped_steps > 0 and a.state.swa["count"] > 0
    for fn in ("named_parameters", "named_buffers"):
        pb = dict(getattr(b.state.model, fn)())
        for n, t in getattr(a.state.model, fn)():
            assert torch.equal(t, pb[n]), n
    for n, t in a.state.swa["avg"].items():
        assert torch.equal(t, b.state.swa["avg"][n]), n
    assert a.state.swa["count"] == b.state.swa["count"]


def _jax_exp(texp):
    tcfg = texp.train
    return jpaper.mobilenetv2(e2=jc.E2TrainConfig(
        smd=jc.SMDConfig(enabled=True, drop_prob=0.5),
        slu=jc.SLUConfig(enabled=True, alpha=1e-3),
        psg=jc.PSGConfig(enabled=True))).replace(train=jc.TrainConfig(
            global_batch=tcfg.global_batch, lr=tcfg.lr,
            optimizer=tcfg.optimizer, total_steps=tcfg.total_steps))


def test_trainer_with_injected_smd_schedule_matches_jax_ledger():
    steps = 6
    texp = _full(steps)
    jexp = _jax_exp(texp)
    mask = jsmd_schedule(jexp.e2.smd, jexp.train.seed, steps)
    assert 0 < mask.sum() < steps
    trainer = Trainer(texp, init_train_state(texp, device="cpu"), _mk(),
                      device="cpu", keep_schedule=mask)
    hist = trainer.run(steps)
    assert [h["step"] for h in hist] == list(np.flatnonzero(mask))
    assert all(h["slu_exec_ratio"] == 1.0 for h in hist)
    led = JLedger(jexp)
    for h in hist:
        led.record_step(h)
    led.executed_steps = trainer.executed_steps
    led.dropped_steps = trainer.dropped_steps
    want = led.report(steps=steps).to_dict()
    assert want["validated_against_hlo"] is None
    got = trainer.energy_report(steps=steps).to_dict()
    assert list(got) == list(want)
    assert got == want
    assert got["fwd_macs_per_example"] == 90_697_728


def _jax_state(texp, jax_init):
    """The JAX package's TrainState for ``texp`` from the JAX init."""
    params, state = jax_init
    jexp = _jax_exp(texp)
    return JTrainState(params=params,
                       opt=_np(jmake_optimizer(jexp.train).init(params)),
                       swa=_np(jswa_init(params)), step=np.int32(0),
                       model_state=state)


def _randomized(tree, seed):
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(r.randn(*np.shape(x)), np.asarray(x).dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(5, np.asarray(x).dtype), tree)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_load_with_the_jax_package(jax_init, writer):
    texp = _full(4)
    jlike = _jax_state(texp, jax_init)
    state = init_train_state(texp, device="cpu")
    flat = _flatten(convert.train_state_tree(state))
    jflat = jckpt._flatten(jlike)
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        assert (v.shape, v.dtype) == (jflat[k].shape, jflat[k].dtype), k
    assert "params::blocks::16::project::w" in flat
    with tempfile.TemporaryDirectory() as d:
        if writer == "port":
            convert.load_train_state(
                state, _randomized(convert.train_state_tree(state), 2))
            save_checkpoint(d, state, 3)
            assert jckpt.verify_checkpoint(d, 3) == (True, "ok")
            jtree, step = jckpt.restore_checkpoint(d, jlike)
            got, want = jckpt._flatten(jtree), _flatten(
                convert.train_state_tree(state))
        else:
            jckpt.save_checkpoint(d, _randomized(jlike, 1), 3)
            assert verify_checkpoint(d, 3) == (True, "ok")
            restored, step = restore_checkpoint(d, state)
            assert restored is state and state.step == 5
            with np.load(os.path.join(d, "step_00000003.npz")) as data:
                want = {k: data[k] for k in data.files}
            got = _flatten(convert.train_state_tree(state))
    assert step == 3 and set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launcher_trains_mobilenetv2_on_the_cpu(capsys):
    tr = train.run(["--task", "cifar_cnn", "--cnn", "mobilenetv2", "--batch",
                    "2", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.exp.model.name == "mobilenetv2"
    assert isinstance(tr.state.model, MobileNetV2)
    assert tr.executed_steps + tr.dropped_steps == 2 and tr.executed_steps
    assert "published widths" in out and "energy report: mobilenetv2" in out
    assert "held-out accuracy" in out


def test_bench_cnn_gives_the_reference_rows_on_the_cpu():
    rows = bench_cnn.run(fast=True, device="cpu", steps=2)
    names = [r.split(",", 2)[0] for r in rows]
    assert names == ["tab4/resnet14_smb", "tab4/resnet14_e2train",
                     "tab4/mobilenetv2_fwd"]
    fields = [dict(f.split("=", 1) for f in r.split(",", 2)[2].split(";"))
              for r in rows]
    energy = ["paper_composition", "comp_saving_assumed",
              "comp_saving_measured", "energy_saving_45nm"]
    assert list(fields[0]) == ["acc"] + energy
    assert list(fields[1]) == ["acc"] + energy + ["paper",
                                                  "measured_psg_fallback"]
    assert fields[1]["paper"] == "0.8027"
    assert 0.0 <= float(fields[1]["measured_psg_fallback"]) <= 1.0
    assert fields[2] == {"logits_finite": "True"}
    assert all(float(r.split(",")[1]) > 0 for r in rows)
