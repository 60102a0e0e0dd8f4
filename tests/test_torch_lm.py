"""repro_torch's dense-LM path against the JAX package's, on the same
parameters (``repro_torch.convert.lm_state_dict_from_jax``), batches and
step keys.

The JAX side runs PSG on its ``interpret`` backend with
``fused_attention=False`` (the materialized softmax, the only attention the
port has) and ``remat="none"``; the SLU decisions are the port's own
threefry draws, not injected.  Tolerances:

* layers and the forward in fp32: the same operations in another summation
  order, ``1e-5`` of the largest magnitude; in bf16 ``2e-2`` (a few bf16
  ulp), since each package rounds its bf16 intermediates at other places.
* one train step: the tolerances of ``test_torch_train.py`` and for the
  same reason: logit-level values (losses, SLU cost) at ``rtol=atol=1e-2``
  since an 8-bit code can flip at a rounding boundary between the two
  summation orders, and at least 90% of each updated parameter tensor equal
  to 1e-6, since an update is ``lr * (sign + wd * w)`` and differs only
  where a sign does.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import lm_cost as jlm_cost  # noqa: E402
from repro.core.ledger import EnergyLedger as JLedger  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.convert import lm_state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.cost import lm_cost  # noqa: E402
from repro_torch.core.slu import lm_uniforms  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import TransformerLM, lm_loss  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.tasks import get_task  # noqa: E402
from repro_torch.training.train_step import TrainState, make_train_step  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

LAYERS, BATCH, SEQ, STEPS = 3, 2, 16, 6
TOL = dict(rtol=1e-2, atol=1e-2)


def _configs(smd: bool = False, remat: str = "none"):
    """The reduced qwen2.5-3b experiment in both packages, three layers (the
    middle one SLU-gated), E2-Train full, SWA from step 0."""
    def cut(exp, e2):
        model = dataclasses.replace(exp.model, num_layers=LAYERS)
        train = dataclasses.replace(exp.train, optimizer="psg", lr=0.03,
                                    total_steps=STEPS, remat=remat)
        return exp.replace(model=model, e2=e2, train=train)

    jexp = cut(jreduce(jget("qwen2_5_3b")), jc.E2TrainConfig(
        smd=jc.SMDConfig(enabled=smd), slu=jc.SLUConfig(enabled=True),
        psg=jc.PSGConfig(enabled=True, fused_attention=False,
                         backend="interpret", swa_start_frac=0.0)))
    texp = cut(reduce_experiment(get_experiment("qwen2_5_3b")),
               tc.E2TrainConfig(smd=tc.SMDConfig(enabled=smd),
                                slu=tc.SLUConfig(enabled=True),
                                psg=tc.PSGConfig(enabled=True,
                                                 fused_attention=False,
                                                 swa_start_frac=0.0)))
    return jexp, texp


@pytest.fixture(scope="module")
def jstate():
    jexp, _ = _configs()
    return jinit(jax.random.PRNGKey(0), jexp)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(texp, jparams):
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(lm_state_dict_from_jax(_np(jparams)))
    return model


def _port_state(texp, jstate):
    model = _port_model(texp, jstate.params)
    params = dict(model.named_parameters())
    return TrainState(model, signsgd_init(params), swa_init(params), 0)


def _batch(step=0):
    return tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, step, 0, BATCH,
                              SEQ, "cpu")


def _close(a, ref, rel):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= rel * np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


@pytest.mark.parametrize("dtype,rel", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_jax(norm, dtype, rel):
    r = np.random.RandomState(0)
    x = (r.randn(2, 5, 64) * 3).astype(np.float32)
    scale = r.rand(64).astype(np.float32) + 0.5
    bias = r.randn(64).astype(np.float32)
    cfg = jc.ModelConfig("t", "dense", 1, 64, 4, 4, 96, 128, norm=norm)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = JL.apply_norm(p, jnp.asarray(x).astype(dtype), cfg)
    got = L.apply_norm(torch.from_numpy(scale), torch.from_numpy(bias),
                       torch.from_numpy(x).to(getattr(torch, dtype)), norm)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want.astype(jnp.float32), rel)


def test_rope_matches_jax():
    x = np.random.RandomState(1).randn(2, 7, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_sdpa_and_softmax_lowp_match_jax_both_ways(dtype, rel):
    """GQA (4 query heads over 2 kv heads), causal mask, bf16
    probabilities: outputs and the custom backward's dq/dk/dv.  The
    probabilities are bf16 in both dtypes, and one that lies at a rounding
    boundary takes the neighbouring bf16 value (2**-8 relative), so fp32
    inputs are held to 1e-3 here."""
    r = np.random.RandomState(2)
    q, k, v = (r.randn(2, 8, n, 16).astype(np.float32) for n in (4, 2, 2))
    g = r.randn(2, 8, 4, 16).astype(np.float32)
    cfg = jc.ModelConfig("t", "dense", 1, 64, 4, 2, 96, 128)

    def jf(q_, k_, v_):
        mask = JL.causal_mask(8, 8)[None, None]
        return JL._sdpa(q_, k_, v_, mask, cfg)

    jargs = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    jy, vjp = jax.vjp(jf, *jargs)
    jgrads = vjp(jnp.asarray(g).astype(dtype))
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
             for a in (q, k, v)]
    y = L._sdpa(*targs, L.causal_mask(8, 8))
    y.backward(torch.from_numpy(g).to(y.dtype))
    _close(y.detach().float().numpy(), jy.astype(jnp.float32), rel)
    for t, j in zip(targs, jgrads):
        _close(t.grad.float().numpy(), j.astype(jnp.float32), rel)


def test_mlp_matches_jax_both_ways():
    jexp, texp = _configs()
    jp = JL.init_mlp(jax.random.PRNGKey(3), jexp.model)
    mlp = L.MLP(texp.model, torch.Generator().manual_seed(0))
    for name, v in _np(jp).items():
        getattr(mlp, name).data = torch.tensor(v)
    x = np.random.RandomState(4).randn(2, 5, 64).astype(np.float32)
    g = np.random.RandomState(5).randn(2, 5, 64).astype(np.float32)
    jy, vjp = jax.vjp(lambda x_: JL.mlp_fwd(jp, x_, jexp.model), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = L.mlp_fwd(mlp, xt, texp.model)
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), jy, 1e-5)
    _close(xt.grad.numpy(), jdx, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_convert_loads_every_leaf(jstate):
    _, texp = _configs()
    model = _port_model(texp, jstate.params)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.size(x) for x in jax.tree.leaves(jstate.params))


def test_forward_loss_and_slu_decisions_match_jax_without_injection(jstate):
    jexp, texp = _configs()
    model = _port_model(texp, jstate.params)
    tb = _batch()
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    seen = set()
    for step in range(3):
        jrng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        key = rng.fold_in(rng.PRNGKey(0), step)
        with jpsg.enable(jexp.e2.psg):
            out = JT.lm_fwd(jstate.params, jb["tokens"], jexp.model, jexp.e2,
                            jrng, remat="none")
            jtotal, jmet = JT.lm_loss(jstate.params, jb, jexp.model, jexp.e2,
                                      jrng, remat="none")
        with tpsg.enable(texp.e2.psg, probe=tpsg.zero_probe()):
            logits, aux = model(tb["tokens"], key, remat="none")
            total, met = lm_loss(model, tb, key, remat="none")
        _close(logits.detach().numpy(), out.logits, 1e-5)
        np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                      np.asarray(out.slu_executed))
        np.testing.assert_allclose(aux["slu_keep_probs"].detach().numpy(),
                                   np.asarray(out.slu_keep_probs).ravel(),
                                   rtol=1e-5)
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        seen.add(tuple(aux["slu_executed"].ravel().tolist()))
    assert len(seen) > 1, "no SLU decision varied over the steps"


def test_one_train_step_matches_jax(jstate):
    jexp, texp = _configs()
    state = _port_state(texp, jstate)
    tb = _batch(0)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    jnew, jmet = jax.jit(jmake(jexp))(jstate, jb)
    new, met = make_train_step(texp)(state, tb)
    assert new.step == int(jnew.step) == 1
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio",
              "psg_fallback_ratio"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    assert float(met["grad_norm"]) == float(jmet["grad_norm"]) == 0.0
    want = lm_state_dict_from_jax(_np(jnew.params))
    for name, p in new.model.named_parameters():
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())
        np.testing.assert_array_equal(new.swa["avg"][name].numpy(),
                                      p.detach().numpy())


def test_remat_block_gives_the_gradients_of_remat_none_exactly(jstate):
    _, none_exp = _configs(remat="none")
    _, block_exp = _configs(remat="block")
    out = {}
    for exp in (none_exp, block_exp):
        state = _port_state(exp, jstate)
        new, met = make_train_step(exp)(state, _batch(1))
        out[exp.train.remat] = ({k: float(v) for k, v in met.items()},
                                dict(new.model.named_parameters()))
    (mn, pn), (mb, pb) = out["none"], out["block"]
    assert mn == mb
    for name in pn:
        assert torch.equal(pn[name], pb[name]), name


def test_trainer_with_smd_matches_the_jax_trainer():
    jexp, texp = _configs(smd=True)
    jtask, ttask = jsyn.MarkovLMTask(vocab=128), tsyn.MarkovLMTask(vocab=128)
    jtr = JTrainer(jexp, jinit(jax.random.PRNGKey(0), jexp),
                   lambda step, shard: jsyn.make_lm_batch(jtask, 0, step,
                                                          shard, BATCH, SEQ))
    jhist = jtr.run(STEPS)
    ttr = Trainer(
        texp, _port_state(texp, jinit(jax.random.PRNGKey(0), jexp)),
        lambda step, shard: tsyn.make_lm_batch(ttask, 0, step, shard, BATCH,
                                               SEQ, "cpu"), device="cpu")
    hist = ttr.run(STEPS)
    assert (ttr.executed_steps, ttr.dropped_steps) == \
        (jtr.executed_steps, jtr.dropped_steps)
    assert 0 < ttr.executed_steps < STEPS
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert ttr.state.step == int(jtr.state.step) == STEPS
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"], **TOL)
    assert all(np.isfinite(h["loss"]) for h in hist)

    led = JLedger(jexp)
    for h in hist:
        led.record_step(h)
    led.executed_steps, led.dropped_steps = ttr.executed_steps, \
        ttr.dropped_steps
    want = led.report(steps=STEPS).to_dict()
    assert want["validated_against_hlo"] is None
    got = ttr.energy_report(steps=STEPS).to_dict()
    assert list(got) == list(want)
    assert got == want


def test_slu_layout_is_one_block_units():
    """Generalizing the SLU keys to multi-block units keeps the dense LM's:
    two uniforms a layer, layer ``i``'s from ``fold_in(fold_in(key, i),
    0)`` split in two (the layout of the earlier slices), flags ``(L, 2)``
    and keep probabilities ``(2 L,)``."""
    _, texp = _configs()
    key = rng.fold_in(rng.PRNGKey(0), 3)
    want = [rng.uniform(r) for i in range(LAYERS)
            for r in rng.split(rng.fold_in(rng.fold_in(key, i), 0))]
    np.testing.assert_array_equal(lm_uniforms(key, texp.model),
                                  np.array(want, np.float32))
    model = TransformerLM(texp.model, texp.e2)
    with torch.no_grad():
        _, aux = model(_batch()["tokens"], key, remat="none")
    assert aux["slu_executed"].shape == (LAYERS, 2)
    assert aux["slu_keep_probs"].shape == (2 * LAYERS,)


@pytest.mark.parametrize("reduced", [False, True])
def test_lm_cost_table_equals_jax(reduced):
    jexp, texp = jget("qwen2_5_3b"), get_experiment("qwen2_5_3b")
    if reduced:
        jexp, texp = jreduce(jexp), reduce_experiment(texp)
    t, j = lm_cost(texp.model, 4096), jlm_cost(jexp.model, 4096)
    assert [dataclasses.astuple(x) for x in t.layers] == \
        [dataclasses.astuple(x) for x in j.layers]
    assert texp.model.param_count() == jexp.model.param_count()
    assert texp.model.padded_vocab == jexp.model.padded_vocab


def test_unported_options_raise():
    # remat="full" and sliding windows are ported: their positive cases are
    # in test_torch_dense_archs.py; MoE blocks, the encoder and frontends
    # in test_torch_encdec_moe.py; the SSM kinds in test_torch_ssm.py.  A
    # block kind neither package knows raises.
    _, texp = _configs()
    for change in (dict(block_unit=("rwkv",)),
                   dict(block_unit=("attn", "hyena", "attn"))):
        with pytest.raises(ValueError, match="unknown block kinds"):
            TransformerLM(dataclasses.replace(texp.model, **change))
    loss = get_task("lm").make_loss(texp)
    with pytest.raises(ValueError):
        loss(TransformerLM(texp.model, texp.e2), _batch(), None, keep=[True])
