"""repro_torch's element-level oracles (``kernels/ref.py``) against the JAX
package's ``repro.kernels.ref``, on the same numpy inputs.

Exact where both sides are exact: quantization, the im2col patches (data
movement), the signs and element-level fallback ratios of the PSG oracles
(their fp32 sums differ in order only, and at these sizes no product or
threshold lies that close to a boundary).  fp32 values that are sums
(products, convs, attention) are compared at ``rtol=atol=1e-5``, a few
hundred times the fp32 rounding of sums of at most a few hundred terms.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.config import PSGConfig as JPSG  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

CFG, JCFG = PSGConfig(enabled=True), JPSG(enabled=True)
TOL = dict(rtol=1e-5, atol=1e-5)
MATMULS = [(64, 32, 48), (300, 130, 70), (128, 7, 9)]
CONVS = [(3, 1), (3, 2), (1, 1)]        # (k, stride) on a pre-padded input
ATTN = [(1, 24, 4, 2, 16, True), (2, 20, 2, 2, 8, False)]


def _pair(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a)
                                                   for a in arrays]


def _matmul_inputs(N, din, dout):
    r = np.random.RandomState(N + din)
    return _pair((r.randn(N, din) * 0.5).astype(np.float32),
                 (r.randn(N, dout) * 0.01).astype(np.float32))


def _eq(a: torch.Tensor, b):
    np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def _close(a: torch.Tensor, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_ref(bits):
    (x,), (jx,) = _pair(np.random.RandomState(bits).randn(33, 65)
                        .astype(np.float32))
    _eq(tref.quantize_ref(x, bits), jref.quantize_ref(jx, bits))


@pytest.mark.parametrize("N,din,dout", MATMULS)
def test_psg_oracles(N, din, dout):
    (x, g), (jx, jg) = _matmul_inputs(N, din, dout)
    _close(tref.predictor_matmul_oracle(x, g, CFG),
           jref.predictor_matmul_oracle(jx, jg, JCFG))
    g_msb, ok = tref.predictor_confidence_ref(x, g, CFG)
    jg_msb, jok = jref.predictor_confidence_ref(jx, jg, JCFG)
    _close(g_msb, jg_msb)
    _eq(ok, jok)
    _eq(tref.psg_grad_w_ref(x, g, CFG), jref.psg_grad_w_ref(jx, jg, JCFG))
    _eq(tref.psg_grad_w_oracle(x, g, CFG),
        jref.psg_grad_w_oracle(jx, jg, JCFG))
    _eq(tref.psg_fallback_ratio_ref(x, g, CFG),
        jref.psg_fallback_ratio_ref(jx, jg, JCFG))


def _conv_inputs(k, stride, B=2, H=9, C=5, dout=6):
    r = np.random.RandomState(10 * k + stride)
    hp = H + 2 * (k // 2)
    ho = (hp - k) // stride + 1
    xp = np.zeros((B, hp, hp, C), np.float32)
    p = k // 2
    xp[:, p:hp - p, p:hp - p] = r.randn(B, H, H, C)
    w = (r.randn(k * k * C, dout) * 0.1).astype(np.float32)
    gy = (r.randn(B, ho, ho, dout) * 0.01).astype(np.float32)
    return hp, _pair(xp, w, gy)


@pytest.mark.parametrize("k,stride", CONVS)
def test_conv_oracles(k, stride):
    hp, ((xp, w, gy), (jxp, jw, jgy)) = _conv_inputs(k, stride)
    _eq(tref.conv_patches_ref(xp, k, stride),
        jref.conv_patches_ref(jxp, k, stride))
    _close(tref.conv_fwd_ref(xp, w, k, stride),
           jref.conv_fwd_ref(jxp, jw, k, stride))
    _close(tref.conv_grad_x_ref(gy, w, k, stride, hp, hp),
           jref.conv_grad_x_ref(jgy, jw, k, stride, hp, hp))
    _eq(tref.conv_grad_w_ref(xp, gy, CFG, k, stride),
        jref.conv_grad_w_ref(jxp, jgy, JCFG, k, stride))
    _eq(tref.conv_fallback_ratio_ref(xp, gy, CFG, k, stride),
        jref.conv_fallback_ratio_ref(jxp, jgy, JCFG, k, stride))


def test_conv_grad_x_ref_accumulates_bf16_in_fp32():
    hp, ((_, w, gy), (_, jw, jgy)) = _conv_inputs(3, 2)
    got = tref.conv_grad_x_ref(gy.to(torch.bfloat16), w, 3, 2, hp, hp)
    assert got.dtype == torch.float32
    _close(got, jref.conv_grad_x_ref(jgy.astype(jnp.bfloat16), jw, 3, 2,
                                     hp, hp))


def _attn_inputs(B, S, nh, nkv, hd):
    r = np.random.RandomState(S + nh)
    return _pair(r.randn(B, S, nh, hd).astype(np.float32),
                 r.randn(B, S, nkv, hd).astype(np.float32),
                 r.randn(B, S, nkv, hd).astype(np.float32),
                 (r.randn(B, S, nh, hd) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,S,nh,nkv,hd,causal", ATTN)
def test_attention_oracles(B, S, nh, nkv, hd, causal):
    (q, k, v, do), (jq, jk, jv, jdo) = _attn_inputs(B, S, nh, nkv, hd)
    _close(tref.flash_attention_oracle(q, k, v, causal),
           jref.flash_attention_oracle(jq, jk, jv, causal))
    _close(tref.attention_lse_ref(q, k, causal),
           jref.attention_lse_ref(jq, jk, causal))
    for a, b in zip(tref.flash_attention_vjp_oracle(q, k, v, do, causal),
                    jref.flash_attention_vjp_oracle(jq, jk, jv, jdo, causal)):
        _close(a, b)


@pytest.mark.parametrize("B,S,nh,nkv,hd,causal", ATTN)
def test_psg_attention_bwd_ref(B, S, nh, nkv, hd, causal):
    (q, k, v, do), (jq, jk, jv, jdo) = _attn_inputs(B, S, nh, nkv, hd)
    got = tref.psg_attention_bwd_ref(q, k, v, do, CFG, causal)
    want = jref.psg_attention_bwd_ref(jq, jk, jv, jdo, JCFG, causal)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    _eq(got[3], want[3])
