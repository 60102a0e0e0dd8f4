"""repro_torch's flash-attention path (plain versions of kernels 7-9, the
Eq. (2) select, ``PSGAttention`` and a whole LM train step with
``fused_attention=True``) against the JAX package's.

The JAX side runs ``flash_attention``, ``flash_bwd_dq_pallas`` and
``flash_bwd_dkv_pallas`` in interpret mode, ``ref.attention_dkv_products_oracle``
and ``ops.flash_attention_bwd(..., interpret=True)``, as the JAX package's
own tests do, at their shapes (``tests/test_flash_bwd.py``).  Inputs come
from a numpy seed.  Tolerances:

* o in fp32 within ``1e-5 * max|o|``, dq within ``1e-5 * max|dq|``, lse
  within ``1e-5`` absolute: the same fp32 operations, but a materialized
  softmax against the TPU kernel's online one and another summation order
  (measured: below 2e-7 relative, 1e-6 absolute).
* o in bf16 within one bf16 ulp of the larger of the two values, plus
  ``1e-6 * max|o|`` for the fp32 difference before the rounding: two fp32
  values a few 1e-7 apart can round to neighbouring bf16 values, and
  near zero that neighbour is many ulps of the value away.
* the grid scales within ``1e-6`` relative: the row sums of squares of dO
  and v are reduced in another order.
* the dk/dv code products, given JAX's own lse, delta and scales, so that
  only the summation order of q k^T and ``exp`` differ: a P or dS code can
  flip at a rounding boundary, which moves one product element by at most
  one code of the other operand; at most 0.1% of the elements may differ,
  by at most ``1e-3 * max|ref|`` (measured: none differ at these shapes).
* the select, given JAX's group-summed products and dequantization
  scales: bit-identical, values and ratio.
* a whole train step: the tolerances of ``tests/test_torch_lm.py`` and for
  the same reasons.
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
from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.convert import lm_state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import TrainState, make_train_step  # noqa: E402

# the JAX package's BWD_SHAPES: the LM geometry (hd 128, GQA), S not a
# multiple of the 128-row block, MHA with double padding, non-causal
BWD_SHAPES = [(1, 256, 4, 2, 128, True), (1, 192, 4, 2, 128, True),
              (2, 300, 8, 8, 32, True), (1, 128, 4, 4, 64, False)]
SHAPE_IDS = ["lm", "padded", "mha", "noncausal"]
DTYPES = ["float32", "bfloat16"]
CFG = tc.PSGConfig(enabled=True, fused_attention=False)
JCFG = jc.PSGConfig(enabled=True, backend="interpret", fused_attention=True)
LIMS = (FA.qlim(8), FA.qlim(4), FA.qlim(16), FA.qlim(10))


def _inputs(B, S, nh, nkv, hd, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, nh, hd).astype(np.float32),
            r.randn(B, S, nkv, hd).astype(np.float32),
            r.randn(B, S, nkv, hd).astype(np.float32),
            (0.1 * r.randn(B, S, nh, hd)).astype(np.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _bf16_within_one_ulp(a, ref):
    """Every element within one bf16 ulp of the larger magnitude, plus
    ``1e-6 * max|ref|`` (module docstring)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    big = np.maximum(np.abs(a), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    slack = ulp + 1e-6 * np.max(np.abs(ref))
    assert np.all(np.abs(a - ref) <= slack), np.max(np.abs(a - ref) / slack)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's forward, lse, delta, dq, scales and group-summed dk/dv code
    products per (shape, dtype), computed once."""
    cache = {}

    def get(shape, dtype):
        if (shape, dtype) in cache:
            return cache[shape, dtype]
        B, S, nh, nkv, hd, causal = shape
        arrs = _inputs(B, S, nh, nkv, hd, seed=S + nh + hd)
        q, k, v, do = (jnp.asarray(a).astype(dtype) for a in arrs)
        o, lse = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                     return_lse=True)
        delta = jnp.einsum("bsnh,bsnh->bns", do.astype(jnp.float32),
                           o.astype(jnp.float32))
        dq = jfa.flash_bwd_dq_pallas(q, k, v, do, lse, delta, causal=causal,
                                     interpret=True)
        scales = jfa.attention_psg_scales(q, v, do, delta, bits_x=8,
                                          bits_x_msb=4, bits_g=16,
                                          bits_g_msb=10)
        out = dict(arrs=arrs, o=o, lse=lse, delta=delta, dq=dq,
                   scales=scales)
        if dtype == "float32":
            parts = jref.attention_dkv_products_oracle(
                q, k, v, do, lse, delta, scales, lims=LIMS, causal=causal)
            kernel = jfa.flash_bwd_dkv_pallas(
                q, k, v, do, lse, delta, scales, lims=LIMS, causal=causal,
                interpret=True)
            g = nh // nkv
            out["products"] = [np.asarray(p, np.float64).reshape(
                B, S, nkv, g, hd).sum(axis=3) for p in parts]
            out["products_kernel"] = kernel
        cache[shape, dtype] = out
        return out
    return get


# ---------------------------------------------------------------------------
# kernels 7 and 8 (plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_forward_and_lse_match_jax(jax_side, shape, dtype):
    j = jax_side(shape, dtype)
    q, k, v, _ = (_t(a, dtype) for a in j["arrs"])
    o, lse = FA.flash_attention_plain(q, k, v, causal=shape[-1])
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    want = np.asarray(j["o"].astype(jnp.float32))
    if dtype == "float32":
        assert _rel(o.numpy(), want) <= 1e-5
    else:
        _bf16_within_one_ulp(o.float().numpy(), want)
    assert np.max(np.abs(lse.numpy() - np.asarray(j["lse"]))) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_bwd_dq_matches_jax(jax_side, shape, dtype):
    j = jax_side(shape, dtype)
    q, k, v, do = (_t(a, dtype) for a in j["arrs"])
    dq = FA.flash_bwd_dq_plain(q, k, v, do, _t(j["lse"]), _t(j["delta"]),
                               causal=shape[-1])
    assert dq.dtype == torch.float32
    assert _rel(dq.numpy(), j["dq"]) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_psg_scales_match_jax(jax_side, shape, dtype):
    j = jax_side(shape, dtype)
    q, _, v, do = (_t(a, dtype) for a in j["arrs"])
    got = FA.attention_psg_scales(q, v, do, _t(j["delta"]), bits_x=8,
                                  bits_x_msb=4, bits_g=16, bits_g_msb=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(j["scales"]),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# kernel 9 (plain version) and the select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_bwd_dkv_products_match_the_tile_replay_oracle(jax_side, shape):
    j = jax_side(shape, "float32")
    q, k, v, do = (_t(a) for a in j["arrs"])
    got = FA.flash_bwd_dkv_plain(q, k, v, do, _t(j["lse"]), _t(j["delta"]),
                                 _t(j["scales"]), lims=LIMS,
                                 causal=shape[-1])
    B, S, nh, nkv, hd, _ = shape
    for g, w, name, dt in zip(got, j["products"],
                              ("dv_msb", "dv_full", "dk_msb", "dk_full"),
                              (torch.int64,) * 4):
        assert g.dtype == dt and g.shape == (B, S, nkv, hd), name
        diff = np.abs(g.numpy().astype(np.float64) - w)
        assert np.mean(diff > 0) <= 1e-3, name
        assert np.max(diff) <= 1e-3 * np.max(np.abs(w)), name


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_select_is_bit_identical_to_jax(jax_side, shape):
    """JAX's group-summed kernel products through both selects, with JAX's
    dequantization scales: the same values and the same tile ratio."""
    j = jax_side(shape, "float32")
    B, S, nh, nkv, hd, _ = shape
    g = nh // nkv
    dv_m, dv_f, dk_m, dk_f = (p.reshape(B, S, nkv, g, hd).sum(axis=3)
                              for p in j["products_kernel"])
    s_q, s_qm, s_do, s_dom, s_ds, s_dsm = j["scales"]
    for m, f, dm, df in ((dv_m, dv_f, (1.0 / LIMS[1]) * s_dom,
                          (1.0 / LIMS[0]) * s_do),
                         (dk_m, dk_f, s_dsm * s_qm, s_ds * s_q)):
        want, wr = jfa.psg_attention_select(m, f, dm, df, 0.05)
        got, gr = FA.psg_attention_select(_t(m), _t(f), _t(dm), _t(df), 0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(gr) == float(wr)


def test_select_counts_partial_tiles_as_confident_padding():
    msb = torch.zeros(1, 130, 1, 4)
    msb[0, 0, 0, 0] = 10.0      # tau = 0.5: only this entry is confident
    _, ratio = FA.psg_attention_select(msb, torch.ones_like(msb), 1.0, 1.0,
                                       0.05)
    # tiles: rows 0-127 (not all confident) and rows 128-129 + padding
    assert float(ratio) == 1.0
    msb[0, 128:] = 10.0
    _, ratio = FA.psg_attention_select(msb, torch.ones_like(msb), 1.0, 1.0,
                                       0.05)
    assert float(ratio) == 0.5


def test_check_lims_bounds_the_integer_sums():
    """The codes must fit int8 / int16; the sums are exact at any S * g
    (int32 partials flushed into int64), so no size is refused."""
    FA.check_lims(LIMS)
    with pytest.raises(ValueError):
        FA.check_lims((255.0, 7.0, 32767.0, 511.0))
    with pytest.raises(ValueError):
        FA.check_lims((127.0, 0.0, 32767.0, 511.0))


# ---------------------------------------------------------------------------
# the backward op and the autograd function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=SHAPE_IDS)
def test_attention_backward_matches_jax_ops(jax_side, shape):
    """``ops.flash_attention_bwd`` on JAX's o and lse against the JAX
    package's: dq and the selected dk/dv values, and the ratio."""
    j = jax_side(shape, "float32")
    causal = shape[-1]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in j["arrs"])
    cfg = jc.PSGConfig(enabled=True)
    dq, dk, dv, fb = jops.flash_attention_bwd(jq, jk, jv, j["o"], j["lse"],
                                              jdo, cfg, causal=causal,
                                              interpret=True)
    q, k, v, do = (_t(a) for a in j["arrs"])
    tdq, tdk, tdv, tfb = tops.flash_attention_bwd(
        q, k, v, _t(j["o"]), _t(j["lse"]), do, CFG, causal=causal)
    assert _rel(tdq.numpy(), dq) <= 1e-5
    # delta and the scales are reduced in another order (1e-6 relative), so
    # a few P or dS codes sit on the other side of a rounding boundary; each
    # moves an element by one code step of the product (measured: 3.3e-4
    # relative at the MHA shape, below 2e-7 at the others)
    assert _rel(tdk.numpy(), dk) <= 1e-3
    assert _rel(tdv.numpy(), dv) <= 1e-3
    assert float(tfb) == float(fb)


def test_psg_attention_probe_gradient_matches_the_custom_vjp():
    B, S, nh, nkv, hd = 2, 40, 4, 2, 16
    q, k, v, do = _inputs(B, S, nh, nkv, hd, seed=7)

    def jf(q_, k_, v_, probe):
        return jpsg._psg_attention(q_, k_, v_, probe, True, JCFG)

    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)),
                      jnp.zeros(2, jnp.float32))
    jdq, jdk, jdv, jprobe = vjp(jnp.asarray(do))
    targs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    probe = tpsg.zero_probe()
    o = tpsg.PSGAttention.apply(*targs, probe, True, CFG)
    o.backward(_t(do))
    assert _rel(o.detach().numpy(), jo) <= 1e-5
    assert _rel(targs[0].grad.numpy(), jdq) <= 1e-5
    assert _rel(targs[1].grad.numpy(), jdk) <= 1e-5
    assert _rel(targs[2].grad.numpy(), jdv) <= 1e-5
    # macs = float32(2 * B * nh * hd) * S (S + 1) / 2, exactly
    assert float(probe.grad[1]) == float(jprobe[1]) == 2 * B * nh * hd * 820
    np.testing.assert_allclose(probe.grad.numpy(), np.asarray(jprobe),
                               rtol=1e-6)


def test_attention_needs_an_active_config():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        tpsg.attention(q, q, q)


def test_fused_attention_resolution():
    """Explicit True/False wins; None (auto) is the flash path, as in the
    JAX package off Mosaic; no config is the materialized path."""
    assert tc.fused_attention_active(None) is False
    assert tc.fused_attention_active(tc.PSGConfig(enabled=True)) is True
    assert tc.fused_attention_active(
        tc.PSGConfig(enabled=True, fused_attention=True)) is True
    assert tc.fused_attention_active(
        tc.PSGConfig(enabled=True, fused_attention=False)) is False


def test_layer_routes_to_flash_only_under_fused_attention(monkeypatch):
    """The flash path comes before the sequence threshold of the
    query-chunked path, which computes the materialized softmax's values
    one chunk at a time; flash and materialized agree at bf16-probability
    resolution (the materialized softmax rounds its probabilities to
    bf16)."""
    _, texp = _configs(16)
    attn = L.Attention(texp.model, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(L, "ATTN_CHUNK_THRESHOLD", 8)
    fused = tc.PSGConfig(enabled=True, fused_attention=True)
    with tpsg.enable(fused, tpsg.zero_probe()):
        y_flash = L.attention_fwd(attn, x, texp.model)
    with tpsg.enable(CFG, tpsg.zero_probe()):
        y_chunked = L.attention_fwd(attn, x, texp.model)
    monkeypatch.setattr(L, "ATTN_CHUNK_THRESHOLD", 8192)
    with tpsg.enable(CFG, tpsg.zero_probe()):
        y_mat = L.attention_fwd(attn, x, texp.model)
    assert torch.equal(y_chunked, y_mat)
    assert _rel(y_flash.detach().numpy(), y_mat.detach().numpy()) <= 2e-2


# ---------------------------------------------------------------------------
# a whole train step of the reduced qwen2.5-3b through the flash path
# ---------------------------------------------------------------------------

TOL = dict(rtol=1e-2, atol=1e-2)


def _configs(seq):
    """The reduced qwen2.5-3b with fused attention in both packages, three
    layers (the middle one SLU-gated), E2-Train full without SMD, SWA from
    step 0, ``remat="none"``."""
    def cut(exp, e2):
        model = dataclasses.replace(exp.model, num_layers=3)
        train = dataclasses.replace(exp.train, optimizer="psg", lr=0.03,
                                    total_steps=4, remat="none", seq_len=seq)
        return exp.replace(model=model, e2=e2, train=train)

    jexp = cut(jreduce(jget("qwen2_5_3b")), jc.E2TrainConfig(
        slu=jc.SLUConfig(enabled=True),
        psg=jc.PSGConfig(enabled=True, fused_attention=True,
                         backend="interpret", swa_start_frac=0.0)))
    texp = cut(reduce_experiment(get_experiment("qwen2_5_3b")),
               tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                                psg=tc.PSGConfig(enabled=True,
                                                 fused_attention=True,
                                                 swa_start_frac=0.0)))
    return jexp, texp


@pytest.mark.parametrize("seq", [16, 192])
def test_one_flash_train_step_matches_jax(seq):
    """seq 192 gives two 128-row query blocks, the second padded."""
    jexp, texp = _configs(seq)
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(lm_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 0)
    tb = tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, 0, 0, 2, seq,
                            "cpu")
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    jnew, jmet = jax.jit(jmake(jexp))(jstate, jb)
    new, met = make_train_step(texp)(state, tb)
    assert set(met) == set(jmet)
    for key in ("loss", "total_loss", "slu_cost", "slu_exec_ratio",
                "psg_fallback_ratio"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), **TOL,
                                   err_msg=key)
    want = lm_state_dict_from_jax(jax.tree.map(np.asarray, jnew.params))
    for name, p in new.model.named_parameters():
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())


def test_cli_trains_through_the_flash_path_on_the_cpu(capsys):
    from repro_torch.launch import train
    trainer = train.run(["--task", "lm", "--arch", "qwen2_5_3b", "--smoke",
                          "--fused-attention", "on", "--steps", "3",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert trainer.exp.e2.psg.fused_attention is True
    assert "flash attention" in out and "measured PSG fallback" in out
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
