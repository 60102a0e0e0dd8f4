"""repro_torch's PSG matmul kernels (plain versions) and ``PSGMatmul``
against the JAX package's.

The JAX side runs ``predictor_matmul_pallas`` / ``psg_grad_w_pallas`` in
interpret mode, as the JAX package's own tests do.  Tolerances:

* predictor products, signs and fallback flags must be equal.  The JAX
  kernels sum the integer codes in fp32, which is exact while every partial
  sum stays below 2**24; each case first checks that bound (the sum of
  |x||g| over the tokens) so that equality is a fair demand.  At the
  qwen2.5-3b shapes the sums exceed 2**24 and the CUDA kernels are held to
  their own exact plain versions instead (``chip_smoke.py``).
* forward and input gradient of ``PSGMatmul``: plain matmuls of the same
  quantized operands in another summation order, so fp32 values within
  ``1e-5 * max|ref|``; in bf16 the output is rounded to 8 bits of mantissa,
  so within ``1e-2 * max|ref|`` (a few bf16 ulp of the largest value).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import psg as jpsg  # noqa: E402
from repro.core.config import PSGConfig as JPSGConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import psg_matmul as jpm  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.core.quant import codes  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import psg_matmul as PM  # noqa: E402

CFG = PSGConfig(enabled=True)
JCFG = JPSGConfig(enabled=True, backend="interpret", fused_attention=False)

# (N tokens, din, dout): one tile smaller than 128 both ways, a padded
# 200 x 328 grid (second row and third column of tiles partly padded),
# several whole tiles, and a tall-thin one
SHAPES = [(64, 32, 48), (48, 200, 328), (64, 256, 128), (40, 130, 20)]
CASES = [pytest.param(s, id="N{}_{}x{}".format(*s)) for s in SHAPES]


def _data(s, seed=0):
    N, din, dout = s
    r = np.random.RandomState(seed + N + din + dout)
    x = r.randn(N, din).astype(np.float32)
    gy = (r.randn(N, dout) * 0.01).astype(np.float32)
    gy[0, 0] = 0.1       # a large outlier keeps the 16-bit codes small
    return x, gy


def _close(a, ref, rel):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= rel * np.max(np.abs(ref))


def _exact_in_fp32(x, g):
    """Every fp32 partial sum of ``x^T g`` is exact below 2**24."""
    return float(PM._code_product(x.abs(), g.abs()).max()) < 2 ** 24


def _all_codes(x, gy):
    xt, gt = torch.from_numpy(x), torch.from_numpy(gy)
    return (codes(xt, 4)[0], codes(gt, 10)[0], codes(xt, 8)[0],
            codes(gt, 16)[0])


@pytest.mark.parametrize("s", CASES)
def test_plain_kernels_match_jax_kernels(s):
    xm, gm, xq, gq = _all_codes(*_data(s))
    assert _exact_in_fp32(xq, gq)
    pred = PM.predictor_matmul(xm, gm)
    jpred = jpm.predictor_matmul_pallas(jnp.asarray(xm.numpy()),
                                        jnp.asarray(gm.numpy()))
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(jpred).astype(np.int64))
    tau = 0.05 * pred.float().abs().amax()
    jtau = 0.05 * jnp.max(jnp.abs(jpred))
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
    sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
    jsign, jstats = jpm.psg_grad_w_pallas(
        jnp.asarray(xm.numpy()), jnp.asarray(gm.numpy()),
        jnp.asarray(xq.numpy()), jnp.asarray(gq.numpy()), jtau)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))


def test_tau_zero_flags_nothing_even_on_padded_tiles():
    """All-zero output gradient: every code is 0, tau = 0, every element
    (padding included, 0 >= 0) is confident and every sign is 0."""
    x, _ = _data((40, 200, 328))
    gy = np.zeros((40, 328), np.float32)
    xm, gm, xq, gq = _all_codes(x, gy)
    pred = PM.predictor_matmul(xm, gm)
    tau = 0.05 * pred.float().abs().amax()
    assert float(tau) == 0.0
    sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
    jsign, jstats = jpm.psg_grad_w_pallas(
        jnp.asarray(xm.numpy()), jnp.asarray(gm.numpy()),
        jnp.asarray(xq.numpy()), jnp.asarray(gq.numpy()), jnp.float32(0.0))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    assert not stats.any() and not sign.any()


def test_partly_padded_tiles_count_as_fallback():
    """200 x 328 -> tiles of 128: with tau > 0 every tile that holds
    padding is flagged even where every real element is confident."""
    pred = torch.full((200, 328), 1000, dtype=torch.float32)
    xq = torch.zeros((4, 200), dtype=torch.int8)
    gq = torch.zeros((4, 328), dtype=torch.int16)
    sign, stats = PM.psg_grad_w(pred, xq, gq, torch.tensor(1.0))
    assert stats.tolist() == [[0, 0, 1], [1, 1, 1]]
    assert bool((sign == 1).all())
    assert PM.tile_grid(200, 328) == (128, 128, 2, 3)
    assert PM.tile_grid(32, 48) == (32, 48, 1, 1)


@pytest.mark.parametrize("s", CASES)
def test_psg_grad_w_op_matches_jax(s):
    x, gy = _data(s)
    sign, fb = tops.psg_grad_w(torch.from_numpy(x), torch.from_numpy(gy), CFG)
    jsign, jfb = jops.psg_grad_w(jnp.asarray(x), jnp.asarray(gy), JCFG,
                                 interpret=True)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    assert float(fb) == float(jfb)


def _jax_vjp(x, w, gy, fn):
    def f(x_, w_, probe_):
        with jpsg.enable(JCFG, probe=probe_):
            return fn(x_, w_)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.zeros((2,)))
    return (y, *vjp(jnp.asarray(gy).astype(y.dtype)))


def _torch_grad(x, w, gy, fn):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    probe = tpsg.zero_probe()
    with tpsg.enable(CFG, probe=probe):
        y = fn(xt, wt)
    y.backward(torch.from_numpy(gy).to(y.dtype))
    return y.detach(), xt.grad, wt.grad, probe.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", CASES[:2])
def test_psg_matmul_function_matches_jax_vjp(s, dtype):
    """(y, dx, dw, dprobe) of ``psg.matmul`` against ``jax.vjp`` of the JAX
    package's under ``psg.enable``, with the weight cast to the activation
    dtype as the layers do."""
    x, gy = _data(s, seed=1)
    r = np.random.RandomState(7)
    w = (r.randn(s[1], s[2]) * 0.1).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jy, jdx, jdw, jdp = _jax_vjp(
        x, w, gy, lambda x_, w_: jpsg.matmul(x_.astype(jdt), w_.astype(jdt)))
    y, dx, dw, dp = _torch_grad(
        x, w, gy, lambda x_, w_: tpsg.matmul(x_.to(tdt), w_.to(tdt)))
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert y.dtype == tdt
    _close(y.float().numpy(), jy.astype(jnp.float32), rel)
    _close(dx.numpy(), jdx, rel)
    xr, gr = (torch.from_numpy(a).to(tdt).float().numpy() for a in (x, gy))
    assert _exact_in_fp32(*_all_codes(xr, gr)[2:])
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))


@pytest.mark.parametrize("pattern", ["bsd,dnh->bsnh", "bsnh,nhd->bsd"])
def test_psg_einsum_patterns_match_jax(pattern):
    r = np.random.RandomState(5)
    B, S, d, n, h = 2, 8, 24, 3, 8
    if pattern == "bsd,dnh->bsnh":
        x, w = r.randn(B, S, d), r.randn(d, n, h) * 0.1
        gy = r.randn(B, S, n, h) * 0.01
    else:
        x, w = r.randn(B, S, n, h), r.randn(n, h, d) * 0.1
        gy = r.randn(B, S, d) * 0.01
    x, w, gy = (a.astype(np.float32) for a in (x, w, gy))
    gy.flat[0] = 0.1
    jy, jdx, jdw, jdp = _jax_vjp(
        x, w, gy, lambda x_, w_: jpsg.einsum(pattern, x_, w_))
    y, dx, dw, dp = _torch_grad(
        x, w, gy, lambda x_, w_: tpsg.einsum(pattern, x_, w_))
    _close(y.numpy(), jy, 1e-5)
    _close(dx.numpy(), jdx, 1e-5)
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))


def test_plain_matmul_without_psg_and_unported_patterns():
    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    torch.testing.assert_close(tpsg.matmul(x, w), x @ w)
    with pytest.raises(NotImplementedError):
        tpsg.einsum("ecd,edf->ecf", torch.randn(2, 3, 4),
                    torch.randn(2, 4, 5))


def test_wrappers_reject_what_the_kernels_do_not_take():
    xm = torch.zeros(8, 4, dtype=torch.int8)
    gm = torch.zeros(8, 6, dtype=torch.int16)
    with pytest.raises(ValueError):
        PM.predictor_matmul(xm, gm.to("meta"))
    with pytest.raises(ValueError):
        PM.psg_grad_w(torch.zeros(4, 6, dtype=torch.float32), xm,
                      gm.to("meta"), torch.tensor(0.0))
