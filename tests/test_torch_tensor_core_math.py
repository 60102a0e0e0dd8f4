"""The arithmetic that the tensor-core kernels 1-3 and 5-9 rest on, in
plain PyTorch on the CPU, against the JAX package's kernels.

* Kernel 1 (``conv_fwd`` on int8 tensor cores) sums the 8-bit codes
  exactly and scales once: ``(sum_t window_t(cx) @ cw_t) * (sx * sw)``
  (``conv_fwd_codes_plain``).  It must hold against JAX's
  ``conv_fwd_pallas`` (interpret mode) on ``quantize(x)`` and
  ``quantize(w)`` within ``FP32_REL * max|ref|``: both round only at the
  end of their sums, JAX's in fp32.
* Kernel 2 (``conv_grad_x`` on int8 tensor cores) sums the 16-bit g codes
  and 8-bit weight codes exactly, each byte plane of g in int32 and ``256
  hi + lo`` in int64, and scales once (``conv_grad_x_codes_plain``).  It
  must hold against JAX's ``conv_grad_x_pallas`` (interpret mode) on the
  scaled codes within ``FP32_REL * max|ref|``, and equal the int64 sum
  rounded once where every code is at its limit and the sums pass int32.
* Kernel 3 (``conv_grad_w_predictor`` on int8 tensor cores) multiplies on
  a padded grid where every tap is a shifted view of one stride phase, and
  splits the g codes into byte planes (``conv_grad_w_predictor_grid_plain``).
  It must equal the plain version and JAX's ``conv_grad_w_predictor_pallas``
  (interpret mode) bit for bit, also with every code at its limit: pass 1's
  fp32 output is the exact sum rounded once, and JAX's fp32 sums are exact
  below 2**24, which these cases stay under.  Past the size the int32
  version refused (batch 600 at 32 x 32) the plain version holds against
  the JAX package's materialized-patch product within fp32 rounding.
* Kernel 4 (``conv_grad_w`` on int8 tensor cores) runs kernel 3's
  padded-grid product on the 8-bit x and 16-bit g codes, each byte plane in
  int32 over at most 65,536 positions and int64 across splits, then the
  Eq. (2) select and the flags (``conv_grad_w_grid_plain``).  Signs and flags must equal the plain
  version's and JAX's ``conv_grad_w_pallas`` (interpret mode) bit for bit
  at k 1 and 3, stride 1 and 2, dout 16, 64 and 160 (a padded last flag
  block) and tau 0, ``beta max|pred|`` and above every |pred|; the JAX
  kernel sums in fp32, exact below 2**24, which these cases stay under
  (checked).  With every code at its limit past one 65,536-position split
  the sums pass 2**31 and are held against the float64 plain version only.
* Kernel 10's scale (``quantize``'s reduction, ``scale_plain``) must equal
  ``qscale`` bit for bit on inputs holding a NaN, an inf, only zeros and
  only -0.0, and its output JAX's ``quantize_pallas`` (interpret mode): NaN
  where it is NaN, the same zeros with the same signs.

* Kernel 5 (``predictor_matmul`` on int8 tensor cores) splits every int16
  g code into a signed high byte and an unsigned low byte and sums ``256
  x^T hi + x^T lo``.  The split must be exact for every int16 code, and the
  combined product must equal the plain version and JAX's
  ``predictor_matmul_pallas`` (interpret mode) exactly, also with every code
  at its limit and N not a multiple of the 32-token MMA depth.  The JAX
  kernel sums in fp32, exact below 2**24, which every case here stays under.
* Kernel 6 (``psg_grad_w`` on int8 tensor cores) runs kernel 5's byte-plane
  product on the 8-bit x and 16-bit g codes, each plane in int32 over at
  most 65,536 tokens and int64 across splits, then the Eq. (2) select and
  the fallback flags as its fused epilogue forms them, one MMA block at a
  time (``psg_grad_w_split_plain``).  Signs and flags must equal the plain
  version's and JAX's ``psg_grad_w_pallas`` (interpret mode) bit for bit,
  with codes random and at their limits, on partly padded tiles and where
  one TPU tile spans several MMA blocks; the JAX kernel sums in fp32, exact
  below 2**24, which the cases held against it stay under (checked).
* Kernel 7 (``flash_fwd`` on bf16 tensor cores) rounds each fp32 P tile to
  ``p_hi + p_lo`` (two bf16) before its products with v.  Its plain
  emulation (``flash_attention_split_p``) must hold against JAX's
  ``flash_attention(..., return_lse=True, interpret=True)`` within the
  kernel's contract: o within one bf16 ulp of the larger magnitude plus
  ``1e-6 * max|o|``, lse within ``1e-5``.
* Kernel 8 (``flash_bwd_dq`` on bf16 tensor cores) splits the fp32 dS into
  three bf16 parts before its products with k
  (``flash_bwd_dq_split_plain``).  It must hold against JAX's
  ``flash_bwd_dq_pallas`` (interpret mode) within ``FP32_REL * max|dq|``,
  also on ``dq_cancel_inputs``, where dq cancels and two parts do not.
* Kernel 9 (``flash_bwd_dkv`` on bf16 and int8 tensor cores) runs its code
  products over 64-row query tiles with the 16-bit operand in byte planes,
  256 hi + lo folded into one wrapping int32 sum per product and flushed
  into int64 every few tiles (``flash_bwd_dkv_mma_plain``, which checks
  every flushed int32 sum against the exact one).  On integer inputs, where
  every score is exact in any order, it must equal the plain version bit
  for bit, at the paper's code limits and with every limit at its largest
  (flushes every 8 tiles), and the JAX package's tile-replay oracle
  (``attention_dkv_products_oracle``) at code limits whose fp32 sums stay
  exact.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import conv as jconv  # noqa: E402
from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import psg_matmul as jpm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.quant import codes, qscale, quantize  # noqa: E402
from repro_torch.kernels import conv as K  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import psg_matmul as PM  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402

FP32_REL = 1e-5


def test_byte_split_is_exact_for_every_int16_code():
    g = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    hi, lo = PM.split_code_bytes(g)
    assert hi.dtype == torch.int8 and lo.dtype == torch.uint8
    assert torch.equal(256 * hi.long() + lo.long(), g.long())
    assert int(hi.min()) == -128 and int(hi.max()) == 127
    assert int(lo.min()) == 0 and int(lo.max()) == 255


def _codes(N, din, dout, kind, seed):
    """4-bit x and 10-bit g codes: uniform over the grid, or every code at
    +-limit with signs that make every output element reach the largest
    magnitude, N * 7 * 511, with either sign (a sign per token times one
    per column)."""
    r = np.random.RandomState(seed)
    if kind == "random":
        x = r.randint(-7, 8, size=(N, din))
        g = r.randint(-511, 512, size=(N, dout))
    else:
        tok = r.choice([-1, 1], size=(N, 1))
        x = 7 * tok * r.choice([-1, 1], size=(1, din))
        g = 511 * tok * r.choice([-1, 1], size=(1, dout))
    return (torch.from_numpy(x.astype(np.int8)),
            torch.from_numpy(g.astype(np.int16)))


@pytest.mark.parametrize("kind", ["random", "at_limit"])
@pytest.mark.parametrize("shape", [(77, 30, 20), (40, 130, 48)],
                         ids=lambda s: "N{}_{}x{}".format(*s))
def test_split_predictor_product_equals_plain_and_jax(shape, kind):
    xm, gm = _codes(*shape, kind, seed=sum(shape))
    got = PM.predictor_matmul_split_plain(xm, gm)
    assert got.dtype == torch.int64 and got.shape == shape[1:]
    plain = PM.predictor_matmul_plain(xm, gm)
    assert plain.dtype == torch.float32
    assert torch.equal(got, plain.long())
    if kind == "at_limit":
        assert bool((got.abs() == shape[0] * 7 * 511).all())
    assert float(got.abs().max()) < 2 ** 24      # JAX's fp32 sum is exact
    want = jpm.predictor_matmul_pallas(jnp.asarray(xm.numpy()),
                                       jnp.asarray(gm.numpy()),
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def _bf16_within_one_ulp(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    big = np.maximum(np.abs(a), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    slack = ulp + 1e-6 * np.max(np.abs(ref))
    assert np.all(np.abs(a - ref) <= slack), np.max(np.abs(a - ref) / slack)


# (B, S, nh, nkv, hd): GQA at hd 16 with S below one 64-key tile, and GQA
# at hd 128 over three 64-key tiles (JAX's kernel: two 128-row blocks)
SPLIT_P = [(2, 40, 4, 2, 16), (1, 192, 4, 2, 128)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SPLIT_P, ids=["hd16", "hd128"])
def test_split_p_forward_holds_the_kernel_contract_against_jax(shape,
                                                               causal):
    B, S, nh, nkv, hd = shape
    r = np.random.RandomState(S + hd + causal)
    arrs = [r.randn(B, S, n, hd).astype(np.float32) for n in (nh, nkv, nkv)]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    jo, jlse = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True,
                                   return_lse=True)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    o, lse = FA.flash_attention_split_p(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _bf16_within_one_ulp(o.float().numpy(),
                         np.asarray(jo.astype(jnp.float32)))
    assert np.max(np.abs(lse.numpy() - np.asarray(jlse))) <= 1e-5


# (batch, hw, C, dout, k, stride) as the PSG conv runs them (pre-padded,
# SAME): the stem (C = 3), a stride-1 and a stride-2 3x3 conv, and a 1x1
CONVS = [(2, 8, 3, 16, 3, 1), (2, 8, 16, 16, 3, 1), (3, 9, 16, 32, 3, 2),
         (4, 4, 32, 24, 1, 1)]
CONV_IDS = ["stem", "stride1", "stride2", "1x1"]


def _conv_codes(shape, seed, at_limit=False):
    B, hw, C, dout, k, st = shape
    r = np.random.RandomState(seed)
    p = k // 2
    hp = hw + 2 * p
    ho = (hp - k) // st + 1
    x = np.zeros((B, hp, hp, C), np.float32)
    x[:, p:hp - p, p:hp - p] = r.randn(B, hw, hw, C)
    gy = r.randn(B, ho, ho, dout).astype(np.float32)
    w = (r.randn(k * k * C, dout) * 0.1).astype(np.float32)
    if at_limit:
        xm = torch.from_numpy((7 * np.sign(x)).astype(np.int8))
        gm = torch.from_numpy(np.where(gy < 0, -511, 511).astype(np.int16))
    else:
        xm, gm = codes(torch.from_numpy(x), 4)[0], codes(torch.from_numpy(gy), 10)[0]
    return torch.from_numpy(x), torch.from_numpy(w), xm, gm


@pytest.mark.parametrize("shape", CONVS, ids=CONV_IDS)
def test_int8_conv_fwd_arithmetic_holds_against_jax(shape):
    k, st = shape[4], shape[5]
    x, w, _, _ = _conv_codes(shape, seed=sum(shape))
    (xc, sx), (wc, sw) = codes(x, 8), codes(w, 8)
    assert xc.dtype == torch.int8 and wc.dtype == torch.int8
    got = K.conv_fwd_codes_plain(xc, sx, wc, sw, k, st)
    want = np.asarray(jconv.conv_fwd_pallas(
        jnp.asarray(quantize(x, 8).numpy()), jnp.asarray(quantize(w, 8).numpy()),
        k=k, stride=st, interpret=True))
    assert got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= FP32_REL * np.max(np.abs(want))


@pytest.mark.parametrize("at_limit", [False, True], ids=["random", "at_limit"])
@pytest.mark.parametrize("shape", CONVS, ids=CONV_IDS)
def test_padded_grid_predictor_equals_plain_and_jax(shape, at_limit):
    k, st = shape[4], shape[5]
    _, _, xm, gm = _conv_codes(shape, seed=sum(shape) + 1, at_limit=at_limit)
    got = K.conv_grad_w_predictor_grid_plain(xm, gm, k, st)
    plain = K.conv_grad_w_predictor_plain(xm, gm, k, st)
    assert got.dtype == plain.dtype == torch.float32
    assert torch.equal(got, plain)
    exact = K._code_product(xm, gm, k, st)
    assert float(exact.abs().max()) < 2 ** 24    # JAX's fp32 sums are exact
    if at_limit:
        assert float(exact.abs().max()) >= 7 * 511 * shape[0]
    want = np.asarray(jconv.conv_grad_w_predictor_pallas(
        jnp.asarray(xm.numpy()), jnp.asarray(gm.numpy()), k=k, stride=st))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_padded_grid_geometry():
    """Every tap a constant shift of one stride phase: the 3x3 stride-2 conv
    of a 34 x 34 padded input reads 17 x 17 phases, shifted by at most one
    row and one column."""
    assert K.pred_grid(34, 34, 3, 1) == (34, 34, 2 * 34 + 2)
    assert K.pred_grid(34, 34, 3, 2) == (17, 17, 17 + 1)
    assert K.pred_grid(8, 8, 1, 1) == (8, 8, 0)


def test_conv_predictor_past_the_old_int32_limit_against_jax_reference():
    """Batch 600 at 32 x 32, C 3, dout 16, codes at their limits with signs
    that make every product positive: every output is near 600 * 1024 * 7 *
    511 = 2.2e9, past 2**31, where the int32 version raised.  The JAX
    package's materialized-patch product (``conv_patches_ref``, one fp32
    GEMM) sums 614,400 terms in fp32, so the two agree within fp32
    rounding: 1e-5 of the largest magnitude."""
    B, k = 600, 3
    r = np.random.RandomState(600)
    img = r.choice([-1, 1], size=(B, 1, 1, 1))
    x = np.zeros((B, 34, 34, 3), np.int8)
    x[:, 1:33, 1:33] = 7 * img
    g = np.broadcast_to(511 * img, (B, 32, 32, 16)).astype(np.int16)
    got = K.conv_grad_w_predictor_plain(torch.from_numpy(x), torch.from_numpy(g),
                                        k, 1)
    assert got.dtype == torch.float32 and float(got.max()) > 2 ** 31
    patches = jref.conv_patches_ref(jnp.asarray(x, jnp.float32), k, 1)
    want = np.asarray(jnp.dot(patches.T, jnp.asarray(g, jnp.float32).reshape(-1, 16),
                              precision="highest"))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


# (batch, hw, C, dout, k, stride) of kernel 4: the stem; a stride-2 3x3 conv
# at dout 64; a 1x1 stride-2 conv at dout 16; a 1x1 and a 3x3 conv at dout
# 160 (flag blocks of 128, the last padded)
SIGN_CONVS = [(2, 8, 3, 16, 3, 1), (2, 8, 16, 64, 3, 2), (3, 6, 24, 16, 1, 2),
              (2, 4, 40, 160, 1, 1), (1, 6, 20, 160, 3, 1)]
SIGN_CONV_IDS = ["stem_d16", "3x3s2_d64", "1x1s2_d16", "1x1s1_d160",
                 "3x3s1_d160"]


def _sign_conv_codes(shape, seed):
    """4-bit and 8-bit x codes, 10-bit and 16-bit g codes (g within +-300,
    so that every byte plane is used and JAX's fp32 sums stay exact)."""
    B, hw, C, dout, k, st = shape
    r = np.random.RandomState(seed)
    p = k // 2
    hp = hw + 2 * p
    ho = (hp - k) // st + 1
    inner = (slice(None), slice(p, hp - p), slice(p, hp - p))
    xm, xq = np.zeros((B, hp, hp, C), np.int8), np.zeros((B, hp, hp, C), np.int8)
    xm[inner] = r.randint(-7, 8, size=(B, hw, hw, C))
    xq[inner] = r.randint(-127, 128, size=(B, hw, hw, C))
    gm = r.randint(-511, 512, size=(B, ho, ho, dout)).astype(np.int16)
    gq = r.randint(-300, 301, size=(B, ho, ho, dout)).astype(np.int16)
    return tuple(torch.from_numpy(a) for a in (xm, gm, xq, gq))


@pytest.mark.parametrize("tau_kind", ["zero", "beta", "above"])
@pytest.mark.parametrize("shape", SIGN_CONVS, ids=SIGN_CONV_IDS)
def test_conv_sign_grid_arithmetic_equals_plain_and_jax(shape, tau_kind):
    k, st = shape[4], shape[5]
    xm, gm, xq, gq = _sign_conv_codes(shape, seed=sum(shape))
    exact = K._code_product(xq.abs(), gq.abs(), k, st)
    assert float(exact.max()) < 2 ** 24          # JAX's fp32 sums are exact
    pred = K.conv_grad_w_predictor_plain(xm, gm, k, st)
    big = pred.abs().amax()
    tau = {"zero": torch.zeros(()), "beta": 0.05 * big,
           "above": 2 * big + 1}[tau_kind]
    got = K.conv_grad_w_grid_plain(pred, xq, gq, tau, k, st)
    plain = K.conv_grad_w_plain(pred, xq, gq, tau, k, st)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    jsign, jstats = jconv.conv_grad_w_pallas(
        *(jnp.asarray(t.numpy()) for t in (xm, gm, xq, gq)),
        jnp.float32(float(tau)), k=k, stride=st)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jstats))
    if tau_kind == "above":     # every sign from the full product, every flag
        full = K._code_product(xq, gq, k, st)
        assert torch.equal(got[0], torch.sign(full).to(torch.int8))
        assert bool(got[1].all())
    if tau_kind == "zero":      # every sign from pred, no flag
        assert torch.equal(got[0], torch.sign(pred).to(torch.int8))
        assert not bool(got[1].any())


@pytest.mark.parametrize("tau_kind", ["zero", "beta", "above"])
def test_conv_sign_grid_past_one_split_at_the_limits(tau_kind):
    """Batch 70 at 32 x 32, C 3, dout 16: 80,920 grid positions, past one
    65,536-position split; every x code at +-127 and every g code at
    +-32767, signed per image and per channel or column, so that every
    element of the full product is +-(its tap's positions) * 127 * 32767,
    past 2**31.  The signs and flags equal the float64 plain version's
    whatever the split, and no int32 plane partial overflows (the emulation
    checks)."""
    B, C, dout = 70, 3, 16
    r = np.random.RandomState(70)
    img = r.choice([-1, 1], size=(B, 1, 1, 1))
    x = np.zeros((B, 34, 34, C), np.int8)
    x[:, 1:33, 1:33] = 127 * img * r.choice([-1, 1], size=(1, 1, 1, C))
    g = np.broadcast_to(32767 * img * r.choice([-1, 1], size=(1, 1, 1, dout)),
                        (B, 32, 32, dout)).astype(np.int16)
    xq, gq = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(g))
    assert B * 34 * 34 > K.MAX_SPLIT_POSITIONS
    full = K._code_product(xq, gq, 3, 1)
    assert float(full.abs().min()) > 2 ** 31
    assert torch.equal(K._grid_product(xq, gq, 3, 1), full)
    pred = torch.from_numpy(r.randn(9 * C, dout).astype(np.float32))
    big = pred.abs().amax()
    tau = {"zero": torch.zeros(()), "beta": 0.5 * big,
           "above": 2 * big}[tau_kind]
    for split in (K.MAX_SPLIT_POSITIONS, 7 * 1024):
        got = K.conv_grad_w_grid_plain(pred, xq, gq, tau, 3, 1, split=split)
        plain = K.conv_grad_w_plain(pred, xq, gq, tau, 3, 1)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


QUANT_SPECIAL = ["nan", "inf", "neg_inf", "zero", "neg_zero"]


def _special(kind, dtype):
    x = (np.random.RandomState(len(kind)).randn(7, 300) * 3).astype(np.float32)
    if kind in ("zero", "neg_zero"):
        x[:] = -0.0 if kind == "neg_zero" else 0.0
    else:
        x[3, 100] = {"nan": np.nan, "inf": np.inf, "neg_inf": -np.inf}[kind]
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", QUANT_SPECIAL)
def test_quantize_scale_on_special_values_equals_qscale_and_jax(kind, dtype):
    x = _special(kind, dtype)
    for bits in (4, 8, 16):
        s, want = Q.scale_plain(x, bits), qscale(x, bits)
        assert s.dtype == torch.float32 and s.dim() == 0
        if kind == "nan":       # a NaN's payload is the arithmetic unit's
            assert math.isnan(float(s)) and math.isnan(float(want))
        else:
            assert torch.equal(s.view(torch.int32), want.view(torch.int32))
        if kind in ("inf", "neg_inf"):
            assert float(s) == math.inf
        if kind in ("zero", "neg_zero"):
            assert float(s) == np.float32(1e-12) / np.float32(2 ** (bits - 1) - 1)
        out, s_out = Q.quantize_with_scale(x, bits)
        assert torch.equal(s_out.view(torch.int32), s.view(torch.int32))
        assert torch.equal(out, Q.quantize(x, bits).view(out.shape)) or \
            kind in ("nan", "inf", "neg_inf")
        ref = Q.quantize_plain(x, want, bits).float().numpy()
        jout = np.asarray(jquant.quantize_pallas(
            jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
            bits, interpret=True).astype(jnp.float32))
        got = out.float().numpy()
        num = ~np.isnan(got)
        for a in (ref, jout):
            np.testing.assert_array_equal(np.isnan(a), ~num)
            np.testing.assert_array_equal(got[num], a[num])
            np.testing.assert_array_equal(np.signbit(got[num]),
                                          np.signbit(a[num]))
        if kind != "neg_zero":
            continue
        assert bool(np.signbit(got).all()) and not bool(np.any(got))


# (N, din, dout) of kernel 6: one TPU tile, a 200 x 328 grid whose last row
# and column of tiles are partly padded, din below 128, and dout 48, where
# one TPU tile (all 48 columns) spans two 32-column MMA blocks
SIGN_SHAPES = [(77, 30, 20), (4, 200, 328), (9, 100, 200), (64, 300, 48)]


def _sign_codes(N, din, dout, kind, seed):
    """8-bit x and 16-bit g codes with 4-bit and 10-bit predictor codes:
    random (g within +-300, so every plane is used and the fp32 sums of the
    JAX kernel stay exact), or every code at +-limit with signs that make
    every element of both products reach the largest magnitude."""
    r = np.random.RandomState(seed)
    if kind == "random":
        xq = r.randint(-127, 128, size=(N, din))
        gq = r.randint(-300, 301, size=(N, dout))
        xm, gm = r.randint(-7, 8, size=(N, din)), r.randint(-511, 512, size=(N, dout))
    else:
        tok = r.choice([-1, 1], size=(N, 1))
        xs, gs = r.choice([-1, 1], size=(1, din)), r.choice([-1, 1], size=(1, dout))
        xq, gq, xm, gm = 127 * tok * xs, 32767 * tok * gs, 7 * tok * xs, 511 * tok * gs
    return tuple(torch.from_numpy(a.astype(t)) for a, t in
                 ((xm, np.int8), (gm, np.int16), (xq, np.int8), (gq, np.int16)))


@pytest.mark.parametrize("kind", ["random", "at_limit"])
@pytest.mark.parametrize("shape", SIGN_SHAPES,
                         ids=lambda s: "N{}_{}x{}".format(*s))
def test_sign_split_product_and_flags_equal_plain_and_jax(shape, kind):
    """At the limits each token adds 127 * 32767 to every element, so 4
    tokens keep JAX's fp32 sums exact (past one split: the next test)."""
    N, din, dout = shape
    if kind == "at_limit":
        N = 4
    xm, gm, xq, gq = _sign_codes(N, din, dout, kind, seed=N + din + dout)
    exact = PM._code_product(xq, gq)
    assert float(exact.abs().max()) < 2 ** 24   # JAX's fp32 sums are exact
    if kind == "at_limit":
        assert bool((exact.abs() == N * 127 * 32767).all())
    pred = PM.predictor_matmul_plain(xm, gm)
    big = pred.abs().amax()
    for tau in (0.05 * big, torch.zeros(()), 2 * big + 1):
        got = PM.psg_grad_w_split_plain(pred, xq, gq, tau)
        plain = PM.psg_grad_w_plain(pred, xq, gq, tau)
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        jsign, jstats = jpm.psg_grad_w_pallas(
            *(jnp.asarray(t.numpy()) for t in (xm, gm, xq, gq)),
            jnp.float32(float(tau)))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jsign))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jstats))
    # tau above every |pred|: every sign from the full product, every flag on
    assert torch.equal(got[0], torch.sign(exact).to(torch.int8))
    assert bool(got[1].all())


@pytest.mark.parametrize("split", [7, 65536], ids=["split7", "split65536"])
def test_sign_split_product_past_one_split_at_the_limits(split):
    """70,000 tokens, every code at +-limit: past one 65,536-token split;
    the int64 product and the signs equal the plain version's whatever the
    split, and no int32 plane partial overflows (the emulation checks)."""
    xm, gm, xq, gq = _sign_codes(70_000, 8, 8, "at_limit", seed=70)
    full = PM._split_product(xq, gq, split)
    assert torch.equal(full, PM._code_product(xq, gq).long())
    assert bool((full.abs() == 70_000 * 127 * 32767).all())
    pred = PM.predictor_matmul_plain(xm, gm)
    tau = 2 * pred.abs().amax()
    got = PM.psg_grad_w_split_plain(pred, xq, gq, tau, split_tokens=split)
    plain = PM.psg_grad_w_plain(pred, xq, gq, tau)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def _int_attention(B, S, nh, nkv, hd, causal, seed):
    """Small integer q, k, v, dO (every score exact in any order) as bf16,
    with the plain forward's lse, delta and the PSG scales."""
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randint(-2, 3, size=sh).astype(np.float32))
                   .to(torch.bfloat16) for sh in ((B, S, nh, hd), (B, S, nkv, hd),
                                                  (B, S, nkv, hd), (B, S, nh, hd)))
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8, bits_x_msb=4,
                                     bits_g=16, bits_g_msb=10)
    return q, k, v, do, lse, delta, scales


# (B, S, nh, nkv, hd, causal): hd 16 with S not a multiple of the 64-row
# tiles, the qwen2.5-3b grouping (g = 8) at hd 128, and non-causal MHA
DKV_SHAPES = [(2, 100, 4, 2, 16, True), (1, 128, 8, 1, 128, True),
              (1, 96, 2, 2, 64, False)]
DKV_IDS = ["hd16_ragged", "g8_hd128", "mha_noncausal"]


@pytest.mark.parametrize("lims", [(127.0, 7.0, 32767.0, 511.0),
                                  (127.0, 127.0, 32767.0, 32767.0)],
                         ids=["paper_bits", "largest_limits"])
@pytest.mark.parametrize("shape", DKV_SHAPES, ids=DKV_IDS)
def test_dkv_plane_schedule_equals_plain_on_integer_inputs(shape, lims):
    """Bit for bit against the plain version; at the largest limits the
    int32 sums flush into int64 every 8 query tiles, which the g = 8 case
    passes (16 tiles for its first kv block)."""
    q, k, v, do, lse, delta, scales = _int_attention(*shape, seed=sum(shape[:5]))
    causal = shape[-1]
    got = FA.flash_bwd_dkv_mma_plain(q, k, v, do, lse, delta, scales,
                                     lims=lims, causal=causal)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, lims=lims,
                                  causal=causal)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int64 and torch.equal(g_, w_)
    assert all(bool((w_ != 0).any()) for w_ in want)
    assert FA.dkv_flush_tiles(lims)[0] == 8


@pytest.mark.parametrize("shape", DKV_SHAPES, ids=DKV_IDS)
def test_dkv_plane_schedule_equals_the_jax_tile_replay_oracle(shape):
    """At code limits of 4 x 8 bits (predictor 3 x 6), where every fp32 sum
    of the JAX oracle is exact (checked), the emulation's group-summed
    products equal the oracle's bit for bit on integer inputs."""
    q, k, v, do, lse, delta, scales = _int_attention(*shape, seed=sum(shape[:5]) + 1)
    B, S, nh, nkv, hd, causal = shape
    lims = (FA.qlim(4), FA.qlim(3), FA.qlim(8), FA.qlim(6))
    got = FA.flash_bwd_dkv_mma_plain(q, k, v, do, lse, delta, scales,
                                     lims=lims, causal=causal)
    parts = jref.attention_dkv_products_oracle(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v, do)),
        *(jnp.asarray(t.numpy()) for t in (lse, delta, scales)),
        lims=lims, causal=causal)
    for g_, part in zip(got, parts):
        per_head = np.asarray(part, np.float64)
        assert np.abs(per_head).sum(axis=1).max() < 2 ** 24
        want = per_head.reshape(B, S, nkv, nh // nkv, hd).sum(axis=3)
        np.testing.assert_array_equal(g_.numpy(), want.astype(np.int64))
    assert all(bool((g_ != 0).any()) for g_ in got)


# (batch, hw, C, dout, k, stride) of the input gradient: k 1 and 3, stride 1
# and 2, dout 16 / 32 / 64; the 1x1 stride-2 one leaves the odd positions
# without a tap (a stride phase with no K)
DX_CONVS = [(2, 8, 16, 16, 3, 1), (2, 8, 16, 32, 3, 2), (1, 6, 32, 64, 3, 1),
            (2, 4, 32, 64, 1, 1), (2, 8, 16, 32, 1, 2), (1, 9, 8, 64, 3, 2)]
DX_IDS = ["3x3s1_d16", "3x3s2_d32", "3x3s1_d64", "1x1s1_d64", "1x1s2_d32",
          "3x3s2_d64_odd"]


def _dx_operands(shape, seed):
    B, hw, C, dout, k, st = shape
    r = np.random.RandomState(seed)
    hp = hw + 2 * (k // 2)
    ho = (hp - k) // st + 1
    gy = torch.from_numpy((r.randn(B, ho, ho, dout) * 0.01).astype(np.float32))
    w = torch.from_numpy((r.randn(k * k * C, dout) * 0.1).astype(np.float32))
    return codes(gy, 16), codes(w, 8), hp


@pytest.mark.parametrize("shape", DX_CONVS, ids=DX_IDS)
def test_int8_conv_grad_x_arithmetic_holds_against_jax(shape):
    """Kernel 2 on codes: the exact integer sum rounded once and scaled
    (``conv_grad_x_codes_plain``) against JAX's ``conv_grad_x_pallas``
    (interpret mode) on ``gc * sg`` and ``wc * sw``, which sums in fp32:
    within ``FP32_REL * max|ref|``."""
    k, st = shape[4], shape[5]
    (gc, sg), (wc, sw), hp = _dx_operands(shape, seed=sum(shape))
    assert gc.dtype == torch.int16 and wc.dtype == torch.int8
    got = K.conv_grad_x_codes_plain(gc, sg, wc, sw, k, st, hp, hp)
    want = np.asarray(jconv.conv_grad_x_pallas(
        jnp.asarray((gc.float() * sg).numpy()),
        jnp.asarray((wc.float() * sw).numpy()), k=k, stride=st, hp=hp, wp=hp,
        interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= FP32_REL * np.max(np.abs(want))
    # the plain version on the scaled codes is the same function
    plain = K.conv_grad_x_plain(gc.float() * sg, wc.float() * sw, k, st, hp, hp)
    assert float((got - plain).abs().max()) <= FP32_REL * float(
        plain.abs().max())


@pytest.mark.parametrize("sign", [1, -1], ids=["positive", "negative"])
def test_int8_conv_grad_x_is_exact_past_int32_with_codes_at_their_limits(sign):
    """A 3x3 conv with dout 64, every g code at +-32767 and every weight
    code at +-127 with the signs aligned: each interior dx sums 576 products
    of 32767 * 127 to 2.4e9, past int32.  The byte planes of g (``hi = g >>
    8``, ``lo = g & 0xFF``) each sum exactly in int32, ``256 hi + lo`` meets
    in int64, and ``conv_grad_x_codes_plain`` equals the int64 sum rounded
    once to fp32 and scaled, bit for bit."""
    B, hw, C, dout, k = 2, 5, 16, 64, 3
    hp = hw + 2
    r = np.random.RandomState(7)
    sigma = np.where(r.randn(dout) < 0, -1, 1)            # one sign a channel
    gc = torch.from_numpy(np.broadcast_to(sign * 32767 * sigma,
                                          (B, hw, hw, dout)).astype(np.int16))
    wc = torch.from_numpy(np.broadcast_to(127 * sigma, (k * k * C, dout))
                          .astype(np.int8))
    sg, sw = torch.tensor(3.1e-7), torch.tensor(7.9e-3)
    exact = torch.zeros((B, hp, hp, C), dtype=torch.int64)
    planes = [torch.zeros_like(exact), torch.zeros_like(exact)]
    w64 = wc.long().reshape(C, k, k, dout)
    g64 = gc.long()
    for ki in range(k):
        for kj in range(k):
            wt = w64[:, ki, kj].T
            exact[:, ki:ki + hw, kj:kj + hw] += g64 @ wt
            planes[0][:, ki:ki + hw, kj:kj + hw] += (g64 >> 8) @ wt
            planes[1][:, ki:ki + hw, kj:kj + hw] += (g64 & 0xFF) @ wt
    assert int(exact.abs().max()) == 576 * 32767 * 127 > 2 ** 31
    assert all(int(p.abs().max()) < 2 ** 31 for p in planes)
    assert torch.equal(256 * planes[0] + planes[1], exact)
    got = K.conv_grad_x_codes_plain(gc, sg, wc, sw, k, 1, hp, hp)
    assert torch.equal(got, exact.float() * (sg * sw))


# (B, S, nh, nkv, hd) of kernel 8: GQA at hd 16 below one 64-key tile, and
# GQA at hd 128 over three 64-key tiles (JAX's kernel: two 128-row blocks)
DQ_SHAPES = [(2, 40, 4, 2, 16), (1, 192, 4, 2, 128)]


def _dq_inputs(shape, causal, kind):
    B, S, nh, nkv, hd = shape
    if kind == "cancel":
        q, k, v, do = FA.dq_cancel_inputs(B, S, nh, nkv, hd, seed=S + hd)
    else:
        r = np.random.RandomState(S + hd + causal)
        q, k, v, do = (torch.from_numpy(
            (r.randn(B, S, n, hd) * f).astype(np.float32)).to(torch.bfloat16)
            for n, f in ((nh, 1.0), (nkv, 1.0), (nkv, 1.0), (nh, 0.1)))
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("kind", ["random", "cancel"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", DQ_SHAPES, ids=["hd16", "hd128"])
def test_split_ds_dq_holds_the_kernel_contract_against_jax(shape, causal,
                                                           kind):
    """Kernel 8 in bf16: dS in three bf16 parts (``flash_bwd_dq_split_plain``)
    against JAX's ``flash_bwd_dq_pallas`` (interpret mode) on the same bf16
    inputs, lse and delta: within ``FP32_REL * max|dq|``, also on inputs
    whose dq cancels (``dq_cancel_inputs``)."""
    q, k, v, do, lse, delta = _dq_inputs(shape, causal, kind)
    got = FA.flash_bwd_dq_split_plain(q, k, v, do, lse, delta, causal=causal)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16)
    want = np.asarray(jfa.flash_bwd_dq_pallas(
        to_j(q), to_j(k), to_j(v), to_j(do), jnp.asarray(lse.numpy()),
        jnp.asarray(delta.numpy()), causal=causal, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= FP32_REL * np.max(np.abs(want))


def test_dq_cancel_inputs_need_the_third_part():
    """On ``dq_cancel_inputs`` a two-part split of dS (16 bits) leaves dq
    more than ``FP32_REL * max|dq|`` from the plain version, the three-part
    split of the kernel stays within a tenth of it."""
    q, k, v, do, lse, delta = _dq_inputs((1, 256, 4, 2, 128), True, "cancel")
    plain = FA.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    err = {t: float((FA.flash_bwd_dq_split_plain(q, k, v, do, lse, delta,
                                                 terms=t) - plain).abs().max())
           / (FP32_REL * float(plain.abs().max())) for t in (2, 3)}
    assert err[2] > 1.0 and err[3] < 0.1, err


def test_three_bf16_parts_keep_fp32_precision():
    x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32)) * 10.0 ** torch.arange(
        -4, 4, 0.001953125)[:4096]
    for terms, bits in ((2, 16), (3, 24)):
        parts = FA.split_bf16(x, terms)
        assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in parts)
        rest = (x.double() - sum(p.double() for p in parts)).abs()
        assert bool((rest <= 2.0 ** -bits * x.double().abs()).all())
