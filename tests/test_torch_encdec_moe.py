"""repro_torch's encoder-decoder (whisper-small), VLM (phi-3-vision-4.2b)
and MoE models (deepseek-moe-16b, grok-1-314b) against the JAX package's,
on the same parameters (``repro_torch.convert``), batches, frontend
embeddings and step keys.

The JAX side runs PSG on its ``interpret`` backend with
``fused_attention=False`` and ``remat="none"``, as ``test_torch_lm.py``
and ``test_torch_dense_archs.py`` do, on their tolerances: ``1e-5`` of the
largest magnitude for fp32 forwards (the same fp32 operations in other
summation orders; the MoE's combine sums a token's k choices in another
order than the reference's one-hot einsum), with the softmax's
probabilities in fp32 in both packages where a forward is compared over
layers (a probability at a bf16 rounding boundary takes the neighbouring
value in the other package); ``rtol=atol=1e-2`` for the metrics of one PSG
train step and at least 90% of each updated parameter tensor equal to
1e-6 (8-bit codes flip at rounding boundaries between the two packages'
sums); the grouped PSG einsums' signs bit for bit and their probe within
``1e-6`` (fp32 sums of the experts' terms in another order).  Reduced grok
keeps its bf16 parameters.
"""
import dataclasses
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import lm_cost as jlm_cost  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.api import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim.swa import swa_init as jswa_init  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.cost import lm_cost  # noqa: E402
from repro_torch.core.slu import lm_uniforms  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.ft.checkpoint import (_flatten, restore_checkpoint,  # noqa: E402
                                       save_checkpoint, verify_checkpoint)
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.transformer import TransformerLM, lm_loss  # noqa: E402
from repro_torch.optim.sgd import sgd_init  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             init_train_state,
                                             make_train_step)
from repro_torch.training.trainer import Trainer  # noqa: E402

ARCHS = ["whisper_small", "phi_3_vision_4_2b", "deepseek_moe_16b",
         "grok_1_314b"]
LAYERS, BATCH, SEQ = 3, 2, 16
TOL = dict(rtol=1e-2, atol=1e-2)
CFG = tc.PSGConfig(enabled=True, fused_attention=False)
JCFG = jc.PSGConfig(enabled=True, backend="interpret", fused_attention=False)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as in ``test_torch_dense_archs.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, psg_on=True):
    """The reduced ``arch`` in both packages, three layers (the middle one
    SLU-gated), SLU on, PSG on (``psg`` at lr 0.03, SWA from step 0) or
    off (``sgdm`` at lr 0.01)."""
    opt = dict(optimizer="psg", lr=0.03) if psg_on else \
        dict(optimizer="sgdm", lr=0.01)

    def cut(exp, e2):
        model = dataclasses.replace(exp.model, num_layers=LAYERS)
        tr = dataclasses.replace(exp.train, total_steps=6, remat="none",
                                 **opt)
        return exp.replace(model=model, e2=e2, train=tr)

    jexp = cut(jreduce(jget(arch)), jc.E2TrainConfig(
        slu=jc.SLUConfig(enabled=True),
        psg=dataclasses.replace(JCFG, enabled=psg_on, swa_start_frac=0.0)))
    texp = cut(reduce_experiment(get_experiment(arch)), tc.E2TrainConfig(
        slu=tc.SLUConfig(enabled=True),
        psg=dataclasses.replace(CFG, enabled=psg_on, swa_start_frac=0.0)))
    return jexp, texp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_JSTATES = {}


def _jstate(arch, psg_on=True):
    if (arch, psg_on) not in _JSTATES:
        jexp, _ = _configs(arch, psg_on)
        st = jinit(jax.random.PRNGKey(0), jexp)
        _JSTATES[arch, psg_on] = st._replace(
            opt=jmake_optimizer(jexp.train).init(st.params),
            swa=jswa_init(st.params) if psg_on else None)
    return _JSTATES[arch, psg_on]


def _port_model(texp, jparams):
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(convert.lm_state_dict_from_jax(_np(jparams)))
    return model


def _batch(texp, step=0):
    b = tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, step, 0, BATCH,
                           SEQ, "cpu")
    return tsyn.with_frontend(b, texp.model, step)


def _jbatch(tb):
    return {k: jnp.asarray(v.numpy().astype(
        np.int32 if v.dtype == torch.int64 else np.float32))
        for k, v in tb.items()}


def _close(a, ref, rel):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= rel * np.max(np.abs(ref))


@pytest.fixture
def fp32_probabilities(monkeypatch):
    """The softmax without its bf16 rounding, in both packages (as in
    ``test_torch_dense_archs.py``)."""
    monkeypatch.setattr(JL, "_softmax_lowp",
                        lambda s: jax.nn.softmax(s, axis=-1))
    monkeypatch.setattr(L, "SoftmaxLowp", type("Softmax", (), {
        "apply": staticmethod(lambda s: torch.softmax(s, dim=-1))}))


# ---------------------------------------------------------------------------
# configs, cost, frontend draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_for_field(arch, reduced):
    assert arch in ARCH_IDS
    texp, jexp = get_experiment(arch), jget(arch)
    if reduced:
        texp, jexp = reduce_experiment(texp), jreduce(jexp)
    for part in ("model", "train"):
        t, j = getattr(texp, part), getattr(jexp, part)
        for name, v in dataclasses.asdict(t).items():
            assert v == getattr(j, name), (part, name)
    assert texp.model.param_dtype == ("bfloat16" if arch == "grok_1_314b"
                                      else "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_flops_and_param_counts_equal_jax(arch):
    for reduce_ in (False, True):
        texp, jexp = get_experiment(arch), jget(arch)
        if reduce_:
            texp, jexp = reduce_experiment(texp), jreduce(jexp)
        t, j = texp.model, jexp.model
        for seq in (16, 4096):
            assert [dataclasses.astuple(x) for x in lm_cost(t, seq).layers] \
                == [dataclasses.astuple(x) for x in jlm_cost(j, seq).layers]
            assert energy.model_fwd_flops(t, 2, seq) == \
                jenergy.model_fwd_flops(j, 2, seq)
        assert t.param_count() == j.param_count()


def test_transformer_refuses_only_the_ssm_kinds():
    """Every arch builds, the SSM kinds too since they were ported
    (``tests/test_torch_ssm.py``); what is refused now is a block kind
    neither package knows, or a depth its unit does not tile."""
    cfg = reduce_experiment(get_experiment("llama3_8b")).model
    for arch in ARCHS:
        TransformerLM(reduce_experiment(get_experiment(arch)).model)
    TransformerLM(dataclasses.replace(cfg, block_unit=("mamba",)))
    with pytest.raises(ValueError, match="unknown block kinds"):
        TransformerLM(dataclasses.replace(cfg, block_unit=("rwkv",)))
    with pytest.raises(ValueError, match="not divisible by unit"):
        TransformerLM(dataclasses.replace(cfg, num_layers=3,
                                          block_unit=("attn", "mamba")))


def test_moe_slu_layout_is_one_block_units():
    """Generalizing the SLU keys to multi-block units keeps the MoE's: two
    uniforms a layer, layer ``i``'s from ``fold_in(fold_in(key, i), 0)``
    split in two, and flags ``(L, 2)``."""
    _, texp = _configs("deepseek_moe_16b", False)
    model = _port_model(texp, _jstate("deepseek_moe_16b", False).params)
    key = rng.fold_in(rng.PRNGKey(0), 2)
    want = [rng.uniform(r) for i in range(LAYERS)
            for r in rng.split(rng.fold_in(rng.fold_in(key, i), 0))]
    np.testing.assert_array_equal(lm_uniforms(key, texp.model),
                                  np.array(want, np.float32))
    with torch.no_grad():
        _, aux = model(_batch(texp)["tokens"], key, remat="none")
    assert aux["slu_executed"].shape == (LAYERS, 2)
    assert aux["slu_keep_probs"].shape == (2 * LAYERS,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_draw_equals_jax_random_normal(dtype):
    """The launcher's frontend embeddings: JAX's ``normal(fold_in(PRNGKey(7),
    step), (B, F, d), dtype)``, bit for bit in bf16 (all 128 values of its
    8-bit uniform reached), within a few fp32 ulp in fp32 (numpy's log1p)."""
    cfg = dataclasses.replace(get_experiment("whisper_small").model,
                              frontend_tokens=40, d_model=64, dtype=dtype)
    for step in (0, 3):
        got = tsyn.host_frontend(cfg, step, 2)
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(7), step), (2, 40, 64),
            jnp.dtype(dtype))).astype(np.float32)
        assert got.dtype == getattr(torch, dtype) and got.shape == (2, 40, 64)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.float().numpy(), want)
            assert len(np.unique(want)) == 128
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE FFN and the grouped PSG einsums
# ---------------------------------------------------------------------------


def _moe_pair(case, psg_on):
    """(JAX params, port MoE, cfg, x) for a routing case of the reduced
    deepseek-moe-16b (4 experts, top-2, one shared expert, 4 x 16 tokens):
    ``balanced``; ``drops`` (``capacity_factor=0.5``, choices over
    capacity); ``ties_empty`` (one row of zeros, so every router
    probability ties, and expert 3's router column at -100, so it receives
    no token)."""
    cfg = reduce_experiment(get_experiment("deepseek_moe_16b")).model
    jcfg = jreduce(jget("deepseek_moe_16b")).model
    if case == "drops":
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    jp = _np(JM.init_moe(jax.random.PRNGKey(3), jcfg))
    r = np.random.RandomState(11)
    x = r.randn(4, 16, cfg.d_model).astype(np.float32)
    if case == "ties_empty":
        jp["router"] = jp["router"].copy()
        jp["router"][0, 3] = -50.0       # a feature every token carries...
        x[..., 0] = 5.0                  # ...keeps expert 3 out of every top-2
        x[1, 5] = 0.0
    m = M.MoE(cfg, torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in convert.port_named(jp).items()})
    return jp, m, cfg, jcfg, x


@pytest.mark.parametrize("psg_on", [False, True], ids=["psg_off", "psg_on"])
@pytest.mark.parametrize("case", ["balanced", "drops", "ties_empty"])
def test_moe_fwd_matches_jax(case, psg_on):
    jp, m, cfg, jcfg, x = _moe_pair(case, psg_on)
    with jpsg.enable(JCFG if psg_on else None):
        jy, jaux = JM.moe_fwd(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              jcfg)
    with tpsg.enable(CFG if psg_on else None, probe=tpsg.zero_probe()):
        y, aux = M.moe_fwd(m, torch.from_numpy(x), cfg)
    _close(y.detach().numpy(), jy, 1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    # the routing itself: the reference's choices, slots and drops
    probs = torch.softmax(torch.from_numpy(x).reshape(4, 16, -1) @
                          m.router.detach(), dim=-1)
    cap = max(int(cfg.capacity_factor * cfg.top_k * 16 / cfg.num_experts), 1)
    _, topi, pos, keep = M.route(probs.reshape(1, 64, -1), cfg.top_k, cap)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.reshape(1, 64, -1).numpy()),
                           cfg.top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    if case == "drops":
        assert not bool(keep.all())
    if case == "ties_empty":
        assert topi[0, 21].tolist() == [0, 1]        # the tied row
        assert not bool((topi == 3).any())
    else:
        assert bool(keep.any())


@pytest.mark.parametrize("case", ["balanced", "drops", "ties_empty"])
def test_moe_fwd_bf16_combine_rounds_once(case, monkeypatch):
    """bf16 activations (deepseek-moe's and grok's on the card): the
    reference combines the experts' bf16 outputs with bf16 weights in one
    einsum, whose products are exact in its fp32 accumulator, and rounds
    the sum over a token's k choices once; the port's ``moe_fwd`` must be
    within one bf16 ulp of the larger magnitude (the same fp32 sum in
    another order can round one ulp apart) plus ``1e-6 * max|ref|``.
    Rounding each weighted choice to bf16 before the sum misses this.
    silu is relu in both packages here: XLA rounds silu's bf16 sigmoid and
    product apart, PyTorch once, which would move the experts' outputs
    themselves by an ulp; relu, the bf16 products and the fp32-accumulated
    bf16 matmuls round alike in both."""
    relu = {"jax": jax.nn.relu, "torch": torch.nn.functional.relu}
    monkeypatch.setattr(jax.nn, "silu", relu["jax"])
    monkeypatch.setitem(JL._ACTS, "silu", relu["jax"])
    monkeypatch.setattr(M.F, "silu", relu["torch"])
    monkeypatch.setitem(L._ACTS, "silu", relu["torch"])
    jp, m, cfg, jcfg, x = _moe_pair(case, False)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, _ = JM.moe_fwd(jax.tree.map(jnp.asarray, jp), xb, jcfg)
    with torch.no_grad():
        y, _ = M.moe_fwd(m, torch.from_numpy(
            np.asarray(xb.astype(jnp.float32))).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16
    a = y.float().numpy()
    ref = np.asarray(jy.astype(jnp.float32))
    big = np.maximum(np.abs(a), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(a - ref) <= ulp + 1e-6 * np.abs(ref).max())


def _einsum_data(pattern):
    r = np.random.RandomState(13)
    G, E, C, din, dout = 2, 3, 5, 24, 16
    xs = {"ecd": (E, G * C, din), "ecf": (E, G * C, din),
          "gecd": (G, E, C, din), "gecf": (G, E, C, din),
          "btd": (2, 7, din)}[pattern.split(",")[0]]
    ws = (din, 2, dout // 2) if pattern.startswith("btd") else (E, din, dout)
    x = r.randn(*xs).astype(np.float32)
    if pattern.startswith("g"):
        x[:, 1] = 0.0                   # an expert with no token
    w = (r.randn(*ws) * 0.1).astype(np.float32)
    y_shape = np.einsum(pattern, x, w).shape
    gy = (r.randn(*y_shape) * 0.01).astype(np.float32)
    gy.flat[0] = 0.1
    if pattern.startswith("g"):
        gy[:, 1] = 0.0
    return x, w, gy


@pytest.mark.parametrize("pattern", ["ecd,edf->ecf", "ecf,efd->ecd",
                                     "gecd,edf->gecf", "gecf,efd->gecd",
                                     "btd,dnh->btnh"])
def test_grouped_psg_einsums_match_jax(pattern):
    """Forward, dx, the dw signs (bit for bit) and the probe of the port's
    per-expert PSG matmuls against the JAX package's ``vmap`` of
    ``psg_matmul`` (one scale and one flag tiling per expert; the probe
    sums the experts'), one expert with no token in the grouped ones."""
    x, w, gy = _einsum_data(pattern)

    def f(x_, w_, probe_):
        with jpsg.enable(JCFG, probe=probe_):
            return jpsg.einsum(pattern, x_, w_)
    jy, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.zeros((2,)))
    jdx, jdw, jdp = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    probe = tpsg.zero_probe()
    with tpsg.enable(CFG, probe=probe):
        y = tpsg.einsum(pattern, xt, wt)
    y.backward(torch.from_numpy(gy))
    _close(y.detach().numpy(), jy, 1e-5)
    _close(xt.grad.numpy(), jdx, 1e-5)
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))
    np.testing.assert_allclose(probe.grad.numpy(), np.asarray(jdp), rtol=1e-6)
    assert float(probe.grad[1]) > 0


# ---------------------------------------------------------------------------
# the encoder, cross-attention and the VLM prepend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("psg_on", [False, True], ids=["psg_off", "psg_on"])
def test_encoder_and_cross_attention_match_jax(psg_on, fp32_probabilities):
    """``encode`` (every layer checkpointed, unmasked attention) and the
    cross-attention over its output against the JAX package's
    ``encoder_fwd`` and ``cross_attention_fwd``, forward and the encoder's
    input gradient."""
    jexp, texp = _configs("whisper_small", psg_on)
    jparams = _jstate("whisper_small", psg_on).params
    model = _port_model(texp, jparams)
    fe = tsyn.host_frontend(texp.model, 0, BATCH).numpy()
    h = np.random.RandomState(2).randn(BATCH, SEQ, 64).astype(np.float32)

    g = np.random.RandomState(4).randn(BATCH, 8, 64).astype(np.float32)

    @jax.jit
    def jf(p, e):
        def f(e_):
            with jpsg.enable(JCFG if psg_on else None):
                mem = JT.encoder_fwd(p, e_, jexp.model)
                cp = jax.tree.map(lambda a: a[1], p["cross"])
                return mem, JL.cross_attention_fwd(
                    cp["attn"], jnp.asarray(h), mem, jexp.model)
        (mem, x), vjp = jax.vjp(f, e)
        return mem, x, vjp((jnp.asarray(g), jnp.zeros_like(x)))[0]
    jmem, jx, jde = jf(jparams, jnp.asarray(fe))
    et = torch.from_numpy(fe).requires_grad_(True)
    with tpsg.enable(CFG if psg_on else None, probe=tpsg.zero_probe()):
        mem = model.encode(et)
        x = L.cross_attention_fwd(model.cross[1].attn, torch.from_numpy(h),
                                  mem, texp.model)
    _close(mem.detach().numpy(), jmem, 1e-5)
    _close(x.detach().numpy(), jx, 1e-5)
    mem.backward(torch.from_numpy(g))
    _close(et.grad.numpy(), jde, 1e-4 if psg_on else 1e-5)


# ---------------------------------------------------------------------------
# whole models: forward, loss, aux, SLU decisions; one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("psg_on", [False, True], ids=["psg_off", "psg_on"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_aux_and_slu_decisions_match_jax(arch, psg_on,
                                                      fp32_probabilities):
    jexp, texp = _configs(arch, psg_on)
    jparams = _jstate(arch, psg_on).params
    model = _port_model(texp, jparams)
    tb = _batch(texp)
    jb = _jbatch(tb)

    @jax.jit
    def jfwd(params, batch, jrng):
        with jpsg.enable(jexp.e2.psg if psg_on else None):
            out = JT.lm_fwd(params, batch["tokens"], jexp.model, jexp.e2,
                            jrng, frontend_embeds=batch.get("frontend"),
                            remat="none")
            return out, JT.lm_loss(params, batch, jexp.model, jexp.e2, jrng,
                                   remat="none")

    for step in range(2):
        jrng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        key = rng.fold_in(rng.PRNGKey(0), step)
        out, (jtotal, jmet) = jfwd(jparams, jb, jrng)
        with tpsg.enable(texp.e2.psg if psg_on else None,
                         probe=tpsg.zero_probe()):
            logits, aux = model(tb["tokens"], key, remat="none",
                                frontend=tb.get("frontend"))
            total, met = lm_loss(model, tb, key, remat="none")
        extra = texp.model.frontend_tokens \
            if arch == "phi_3_vision_4_2b" else 0
        assert logits.shape == (BATCH, SEQ + extra, 128)
        _close(logits.detach().numpy(), out.logits, 1e-5)
        np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                      np.asarray(out.slu_executed))
        np.testing.assert_allclose(aux["slu_keep_probs"].detach().numpy(),
                                   np.asarray(out.slu_keep_probs).ravel(),
                                   rtol=1e-5)
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=1e-5)
        assert (float(met["aux_loss"]) > 0) == bool(texp.model.num_experts)


_JSTEPS = {}


def _jax_step(arch, psg_on):
    if (arch, psg_on) not in _JSTEPS:
        jexp, texp = _configs(arch, psg_on)
        _JSTEPS[arch, psg_on] = jax.jit(jmake(jexp))(
            _jstate(arch, psg_on), _jbatch(_batch(texp)))
    return _JSTEPS[arch, psg_on]


@pytest.mark.parametrize("psg_on", [False, True], ids=["psg_off", "psg_on"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch, psg_on):
    _, texp = _configs(arch, psg_on)
    model = _port_model(texp, _jstate(arch, psg_on).params)
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 0) \
        if psg_on else TrainState(model, sgd_init(params), None, 0)
    jnew, jmet = _jax_step(arch, psg_on)
    new, met = make_train_step(texp)(state, _batch(texp))
    assert new.step == int(jnew.step) == 1
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "aux_loss", "slu_cost", "slu_exec_ratio",
              *(("psg_fallback_ratio",) if psg_on else ())):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    want = convert.lm_state_dict_from_jax(_np(jnew.params))
    dtypes = {k: str(v.dtype) for k, v in
              convert.port_named(_np(jnew.params)).items()}
    for name, p in new.model.named_parameters():
        assert str(p.dtype) == f"torch.{dtypes[name]}", name
        same = np.isclose(p.detach().float().numpy(), want[name].numpy(),
                          rtol=0, atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())


def _skipping_key(model, tb, pos):
    """A step key whose SLU draws skip flat sub-block ``pos`` (layer 1's
    ffn), and that key's flags."""
    for step in range(64):
        key = rng.fold_in(rng.PRNGKey(0), step)
        with torch.no_grad():
            _, aux = model(tb["tokens"], key, remat="none")
        if float(aux["slu_executed"].reshape(-1)[pos]) == 0.0:
            return step, key
    raise AssertionError("no step skipped the MoE sub-block")


def test_gated_moe_aux_is_zero_when_skipped():
    """A skipped MoE sub-block adds 0 to the aux loss (the reference's
    ``lax.cond`` pair): at a step key that skips layer 1's MoE, the port's
    aux equals the JAX package's and falls short of the every-block aux by
    that layer's share; its gradient through the router is that of the
    executed layers alone."""
    jexp, texp = _configs("deepseek_moe_16b", False)
    jparams = _jstate("deepseek_moe_16b", False).params
    model = _port_model(texp, jparams)
    tb = _batch(texp)
    step, key = _skipping_key(model, tb, 3)
    jrng = jax.random.fold_in(jax.random.PRNGKey(0), step)
    out = JT.lm_fwd(jparams, _jbatch(tb)["tokens"], jexp.model, jexp.e2, jrng,
                    remat="none")
    assert float(np.asarray(out.slu_executed)[1, 1]) == 0.0
    _, aux = model(tb["tokens"], key, remat="block")
    np.testing.assert_allclose(float(aux["aux_loss"]), float(out.aux_loss),
                               rtol=1e-6)
    aux["aux_loss"].backward()
    skipped = model.layers[1].moe.router.grad
    assert skipped is None or float(skipped.abs().sum()) == 0.0
    assert float(model.layers[0].moe.router.grad.abs().sum()) > 0.0
    model.eval()
    with torch.no_grad():
        _, full = model(tb["tokens"])
    assert float(full["aux_loss"]) > float(aux["aux_loss"]) + 0.5


def test_chunked_loop_keeps_the_moe_aux_of_the_per_step_loop():
    """The chunked loop (K = 4) against the per-step loop for the reduced
    deepseek-moe-16b with PSG on: every step's aux loss, loss and SLU flags
    equal, a skipped MoE sub-block among them, the final parameters bit for
    bit."""
    _, texp = _configs("deepseek_moe_16b", True)
    texp = texp.replace(train=dataclasses.replace(texp.train, total_steps=16))
    task = tsyn.MarkovLMTask(vocab=128)

    def trainer(**kw):
        return Trainer(texp, init_train_state(texp, seed=0, device="cpu"),
                       lambda s, sh: tsyn.make_lm_batch(task, 0, s, sh, BATCH,
                                                        SEQ, "cpu"),
                       device="cpu", **kw)
    a, b = trainer(), trainer(chunk_steps=4)
    ha, hb = a.run(16), b.run(16)
    assert [(h["step"], h["loss"], h["aux_loss"], h["slu_executed"])
            for h in ha] == [(h["step"], h["loss"], h["aux_loss"],
                              h["slu_executed"]) for h in hb]
    assert any(f[3] == 0.0 for f in (h["slu_executed"] for h in ha))
    assert all(h["aux_loss"] > 0 for h in ha)
    for (n, x), (_, y) in zip(a.state.model.named_parameters(),
                              b.state.model.named_parameters()):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# conversion and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_and_checkpoints_cross_load(arch):
    """The JAX tree through the port's names and back (structure and values;
    bf16 leaves come back as fp32 arrays of the same values), and a port
    checkpoint restored by the JAX package, every leaf equal; for the fp32
    archs also a JAX checkpoint restored by the port.  (The JAX package's
    own checkpoints of bf16 leaves do not verify: ``np.savez`` writes its
    bf16 arrays as ``|V2``, which its manifest check refuses.)"""
    jexp, texp = _configs(arch)
    jstate = _jstate(arch)
    model = _port_model(texp, jstate.params)
    want = _np(jstate.params)
    back = convert.jax_tree(dict(model.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                      err_msg=str(path))
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 4)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, 4)
        assert jckpt.verify_checkpoint(d, 4) == (True, "ok")
        jtree, step = jckpt.restore_checkpoint(d, jstate)
    assert step == 4 and int(jtree.step) == 4
    flat, jflat = _flatten(convert.train_state_tree(state)), \
        jckpt._flatten(jtree)
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jflat[k], np.float32),
                                      np.asarray(flat[k], np.float32),
                                      err_msg=k)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, jstate, 5)
        if arch == "grok_1_314b":      # the reference's bf16 leaves: |V2
            assert not jckpt.verify_checkpoint(d, 5)[0]
            assert not verify_checkpoint(d, 5)[0]
            return
        assert verify_checkpoint(d, 5) == (True, "ok")
        fresh = init_train_state(texp, device="cpu")
        restored, step = restore_checkpoint(d, fresh)
        assert step == 5 and restored is fresh
    for name, p in restored.model.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(),
            convert.lm_state_dict_from_jax(want)[name].numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# kernels 7-9 at head dim 96 (plain versions), and the CLI
# ---------------------------------------------------------------------------


def test_hd96_plain_flash_versions_match_jax():
    """phi-3-vision's head dim: the plain versions of kernels 7-9 against
    the JAX package's flash kernels in interpret mode at hd 96, g = 1, S
    past one 128-row block: o and dq within ``1e-5 * max``, lse within
    1e-5, the dk/dv code products (given JAX's lse, delta and scales)
    equal to its tile-replay oracle's.  Small integer inputs make every
    score and dP exact in any summation order, so no code can flip."""
    B, S, nh, nkv, hd = 1, 160, 2, 2, 96
    r = np.random.RandomState(9)
    q, k, v, do = (r.randint(-2, 3, (B, S, n, hd)).astype(np.float32)
                   for n in (nh, nkv, nkv, nh))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jfa.flash_attention(jq, jk, jv, causal=True, interpret=True,
                                   return_lse=True)
    delta = jnp.einsum("bsnh,bsnh->bns", jdo, jo)
    jdq = jfa.flash_bwd_dq_pallas(jq, jk, jv, jdo, jlse, delta, causal=True,
                                  interpret=True)
    scales = jfa.attention_psg_scales(jq, jv, jdo, delta, bits_x=8,
                                      bits_x_msb=4, bits_g=16, bits_g_msb=10)
    lims = (FA.qlim(8), FA.qlim(4), FA.qlim(16), FA.qlim(10))
    parts = jref.attention_dkv_products_oracle(jq, jk, jv, jdo, jlse, delta,
                                               scales, lims=lims, causal=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = FA.flash_attention_plain(tq, tk, tv, causal=True)
    _close(o.numpy(), jo, 1e-5)
    assert float(np.max(np.abs(lse.numpy() - np.asarray(jlse)))) <= 1e-5
    tdelta = torch.from_numpy(np.asarray(delta))
    tlse = torch.from_numpy(np.asarray(jlse))
    _close(FA.flash_bwd_dq_plain(tq, tk, tv, tdo, tlse, tdelta).numpy(), jdq,
           1e-5)
    got = FA.flash_bwd_dkv_plain(tq, tk, tv, tdo, tlse, tdelta,
                                 torch.from_numpy(np.asarray(scales)),
                                 lims=lims)
    for g_, p_ in zip(got, parts):     # g = 1: one query head a kv head
        np.testing.assert_array_equal(
            g_.numpy(), np.asarray(p_, np.float64).astype(np.int64))
        assert bool((g_ != 0).any())
    assert 96 in FA.HEAD_DIMS


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_arch_on_the_cpu(arch, capsys):
    tr = train.run(["--task", "lm", "--arch", arch, "--smoke", "--steps",
                    "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.exp.model.name == get_experiment(arch).model.name
    assert tr.executed_steps > 0 and "held-out accuracy" in out
    m = tr.exp.model
    assert ("frames" in out) == bool(m.encoder_layers)
    assert ("patches prepended" in out) == (arch == "phi_3_vision_4_2b")
    assert ("experts top-" in out) == bool(m.num_experts)
    assert all(h["aux_loss"] > 0 for h in tr.history) == bool(m.num_experts)
