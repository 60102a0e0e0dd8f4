"""The ResNet's materialized im2col conv path and PSG-off training in
repro_torch, against the JAX package's.

* The patches are the JAX package's ``conv_general_dilated_patches``
  layout, channel-major (feature ``c*k*k + ki*k + kj``), bit for bit at
  every conv kind: a tap-major gather would train a different network from
  the same parameters.
* A depth-8 ResNet train step through the im2col convs under PSG (the PSG
  matmul kernels' plain versions here, the Pallas kernels by the
  interpreter there) and one with PSG off (plain products, ``sgdm``) go
  against the JAX step on the same parameters, batch and SLU decisions.
  Under PSG the tolerances are those of ``tests/test_torch_train.py``, for
  its reasons (8-bit codes flip at rounding boundaries between summation
  orders).  With PSG off nothing is quantized: every value is an fp32 sum
  in another order, so loss and updated parameters agree to ``rtol=1e-4,
  atol=1e-6`` (about 1e-6 relative per layer, through 8 layers and a
  step of lr 0.1).
* The CLI's ``--e2train`` and ``--fused-conv``, and the kernel
  microbenchmark CLI, on the CPU.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_cnns import cnn_model as jcnn_model  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model, resnet_conv_shapes  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import bench_kernels, train  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.training.train_step import make_train_step, train_state_for  # noqa: E402

SHAPES = resnet_conv_shapes(depth=14, width=4, batch=2)
SHAPES.append(SHAPES[0]._replace(hw=4, cin=5, cout=6, k=1, stride=1))
DEPTH, WIDTH, BATCH = 8, 8, 2
TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("s", SHAPES, ids=lambda s: f"{s.kind}_{s.hw}x{s.cin}"
                         f"-{s.cout}k{s.k}s{s.stride}")
def test_patches_bit_identical_to_jax(s):
    hp = s.hw + 2 * (s.k // 2)
    x = np.random.RandomState(s.hw + s.cin).randn(s.batch, hp, hp, s.cin) \
        .astype(np.float32)
    got = tref.conv_patches_ref(torch.from_numpy(x), s.k, s.stride).numpy()
    want = np.asarray(jref.conv_patches_ref(jnp.asarray(x), s.k, s.stride))
    assert got.shape == want.shape == (s.im2col[0], s.im2col[1])
    np.testing.assert_array_equal(got, want)


def test_patches_are_channel_major():
    x = torch.arange(3 * 3 * 2, dtype=torch.float32).reshape(1, 3, 3, 2)
    p = tref.conv_patches_ref(x, 3, 1)[0]
    # channel 0's nine taps, then channel 1's
    torch.testing.assert_close(p[:9], x[0, :, :, 0].reshape(-1))
    torch.testing.assert_close(p[9:], x[0, :, :, 1].reshape(-1))


def test_fused_conv_resolution_and_the_psg_off_conv():
    assert not tpsg.fused_conv_active(None)
    assert tpsg.fused_conv_active(tc.PSGConfig(enabled=True))
    assert tpsg.fused_conv_active(tc.PSGConfig(enabled=True, fused_conv=True))
    assert not tpsg.fused_conv_active(tc.PSGConfig(enabled=True,
                                                   fused_conv=False))
    r = np.random.RandomState(0)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    w = r.randn(27, 5).astype(np.float32)
    for k, stride in ((3, 1), (3, 2), (1, 2)):     # no config: PSG off
        ww = w[:k * k * 3]
        got = tpsg.conv2d(torch.from_numpy(x), torch.from_numpy(ww), k=k,
                          stride=stride)
        want = jpsg.conv2d(jnp.asarray(x), jnp.asarray(ww), k=k,
                           stride=stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _experiments(psg_on: bool):
    if psg_on:
        kw = dict(global_batch=BATCH, lr=0.03, optimizer="psg",
                  total_steps=4)
        je2 = jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True),
                               psg=jc.PSGConfig(enabled=True, fused_conv=False,
                                                backend="interpret",
                                                swa_start_frac=0.0))
        te2 = tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                               psg=tc.PSGConfig(enabled=True, fused_conv=False,
                                                swa_start_frac=0.0))
    else:
        kw = dict(global_batch=BATCH, lr=0.1, optimizer="sgdm",
                  total_steps=4)
        je2, te2 = jc.E2TrainConfig(), tc.E2TrainConfig()
    jexp = jc.Experiment(model=jcnn_model(f"resnet{DEPTH}", DEPTH,
                                          width=WIDTH),
                         e2=je2, train=jc.TrainConfig(**kw), task="cifar_cnn")
    texp = tc.Experiment(model=cnn_model(f"resnet{DEPTH}", DEPTH, width=WIDTH),
                         e2=te2, train=tc.TrainConfig(**kw), task="cifar_cnn")
    return jexp, texp


@pytest.mark.parametrize("psg_on", [True, False], ids=["im2col_psg", "psg_off"])
def test_resnet_step_matches_jax(psg_on):
    jexp, texp = _experiments(psg_on)
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    model = ResNet(DEPTH, 10, texp.e2, width=WIDTH)
    model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                              _np(jstate.model_state)))
    state = train_state_for(texp, model)
    r = np.random.RandomState(1)
    batch = {"image": r.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 10, (BATCH,)).astype(np.int32)}
    rng = jax.random.fold_in(jax.random.PRNGKey(jexp.train.seed), 0)
    with jpsg.enable(jexp.e2.psg if psg_on else None):
        _, aux, _ = JR.resnet_fwd(jstate.params, jstate.model_state,
                                  jnp.asarray(batch["image"]), DEPTH, jexp.e2,
                                  rng)
    keep = [bool(e) for e in np.asarray(aux["slu_executed"])]

    jnew, jmet = jmake(jexp)(jstate, jax.tree.map(jnp.asarray, batch))
    new, met = make_train_step(texp)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, keep=keep)
    assert set(met) == set(jmet)
    assert ("psg_fallback_ratio" in met) == psg_on
    want = state_dict_from_jax(_np(jnew.params), _np(jnew.model_state))
    if psg_on:
        for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                       err_msg=k)
        # tiles of the im2col products at these widths all fall back
        assert float(met["psg_fallback_ratio"]) == \
            float(jmet["psg_fallback_ratio"])
        for name, p in new.model.named_parameters():
            same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                              atol=1e-6)
            assert same.mean() >= 0.9, (name, same.mean())
    else:
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, atol=1e-6)
        for name, p in new.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    for name, b in new.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("preset", list(train.E2TRAIN))
def test_e2train_presets_follow_the_jax_cli(preset):
    exp = train.experiment(depth=8, width=4, batch=2, steps=2,
                           e2=train.E2TRAIN[preset])
    e2 = exp.e2
    want = {"off": (False, False, False), "full": (True, True, True),
            "smd": (True, False, False), "slu": (False, True, False),
            "psg": (False, False, True)}[preset]
    assert (e2.smd.enabled, e2.slu.enabled, e2.psg.enabled) == want
    if preset in ("full", "psg"):
        assert (exp.train.optimizer, exp.train.lr) == ("psg", 0.03)
    else:       # the paper's CIFAR training config
        assert (exp.train.optimizer, exp.train.lr) == ("sgdm", 0.1)
    assert (exp.train.global_batch, exp.train.total_steps) == (2, 2)
    lm = train.lm_experiment("qwen2_5_3b", smoke=True, steps=2,
                             e2=train.E2TRAIN[preset])
    base = reduce_experiment(get_experiment("qwen2_5_3b")).train
    assert lm.e2 == dataclasses.replace(train.E2TRAIN[preset], psg=dataclasses
                                        .replace(e2.psg, fused_conv=None))
    assert (lm.train.optimizer, lm.train.lr) == (
        ("psg", 0.03) if want[2] else (base.optimizer, base.lr))


@pytest.mark.parametrize("e2train,fused,conv", [("off", "off", "im2col"),
                                                ("psg", "off", "im2col"),
                                                ("slu", "on", "im2col"),
                                                ("full", "auto", "fused")])
def test_cli_e2train_and_fused_conv_on_the_cpu(capsys, e2train, fused, conv):
    trainer = train.run(["--depth", "8", "--width", "4", "--batch", "2",
                          "--steps", "2", "--device", "cpu", "--e2train",
                          e2train, "--fused-conv", fused])
    out = capsys.readouterr().out
    assert f"{conv} conv, --e2train {e2train}, kernel backend auto" in out
    assert trainer.exp.e2.psg.fused_conv == train.FUSED[fused]
    assert trainer.executed_steps + trainer.dropped_steps == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    if trainer.executed_steps:
        fb = trainer.measured_psg_fallback()
        assert (fb is None) == (e2train in ("off", "slu"))
        assert "measured PSG fallback" in out and "energy report" in out


@pytest.mark.parametrize("pin,warned", [("plain", True), ("reference", True),
                                       ("cuda", False)])
def test_cli_warns_on_a_pin_that_hides_the_kernels(capsys, pin, warned):
    exp = train.experiment(depth=8, width=4, batch=2, steps=2)
    for dev, want in (("cuda", warned), ("cpu", False)):
        trainer = types.SimpleNamespace(exp=exp, device=torch.device(dev))
        with dispatch.override_backend(pin):
            assert train.kernel_backend(trainer) == pin
        err = capsys.readouterr().err
        assert ("in place of the kernels" in err) == want, (dev, err)


def test_bench_kernels_cli_on_the_cpu(capsys):
    rows = bench_kernels.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    for family in ("kernel/psg_pallas,", "kernel/quantize,",
                   "kernel/psg_resnet74_im2col/body/2048x27x16,",
                   "kernel/psg_resnet74_im2col/strided/512x144x32,",
                   "kernel/psg_resnet74_im2col/down/512x16x32,",
                   "kernel/flash_attn,"):
        assert sum(r.startswith(family) for r in rows) == 1, family
        assert family in out
    assert len(rows) == 6
    for row in rows:
        name, us, derived = row.split(",", 2)
        assert float(us) > 0 and derived
    assert "bits=8" in rows[1] and "pred_mac_vs_fp32=0.0533" in rows[0]
    assert "fallback_tile_ratio=" in rows[2] and "hbm_bytes_ratio=" in rows[5]
    assert "byte_model=tpu_kernels_128x128" in rows[5]
