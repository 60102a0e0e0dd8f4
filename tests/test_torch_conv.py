"""repro_torch conv kernels' plain versions against the JAX package's ops.

The JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do.  Tolerances:

* signs, fallback flags and predictor products must be equal.  The JAX
  kernels sum the integer codes in fp32, which is exact while every partial
  sum stays below 2**24; each case first checks that bound (the sum of
  |x||g| over the reduced positions) so that equality is a fair demand.
  At the paper's shapes the sums exceed 2**24 and the CUDA kernels are held
  to their own exact plain versions instead (``chip_smoke.py``).
* forward and input gradient: fp32 sums in another order, so
  ``max|diff| <= 1e-5 * max|ref|``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import psg as jpsg  # noqa: E402
from repro.core.config import PSGConfig as JPSGConfig  # noqa: E402
from repro.kernels import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.paper_cnns import resnet_conv_shapes  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.core.quant import codes, quantize  # noqa: E402
from repro_torch.kernels import conv as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CFG = PSGConfig(enabled=True)
JCFG = JPSGConfig(enabled=True, fused_conv=True, backend="interpret")
REL = 1e-5

# every conv kind of a small CIFAR ResNet (body, strided, down), plus 1x1
# "point" convs, one with a dout (200) that is not a multiple of 128
SHAPES = resnet_conv_shapes(depth=14, width=8, batch=1, image=8)
SHAPES += [SHAPES[0]._replace(hw=8, cin=24, cout=40, k=1, stride=1),
           SHAPES[0]._replace(hw=4, cin=40, cout=200, k=1, stride=1)]
CASES = [pytest.param(s, id=f"{s.kind}_{s.hw}x{s.cin}-{s.cout}k{s.k}s{s.stride}")
         for s in SHAPES]


def _data(s, seed=0):
    """Padded input, weight and output gradient for one conv, as the PSG
    conv sees them (``k < stride`` pre-subsampled)."""
    r = np.random.RandomState(seed + s.hw * 7 + s.cin + s.cout)
    x = r.randn(s.batch, s.hw, s.hw, s.cin).astype(np.float32)
    stride, k = s.stride, s.k
    if k < stride:
        x, stride = x[:, ::stride, ::stride], 1
    p = k // 2
    xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    w = (r.randn(k * k * s.cin, s.cout) * 0.1).astype(np.float32)
    ho = (xp.shape[1] - k) // stride + 1
    gy = (r.randn(s.batch, ho, ho, s.cout) * 0.01).astype(np.float32)
    gy.flat[0] = 0.1     # a large outlier keeps the 16-bit codes small
    return np.ascontiguousarray(xp), w, gy, k, stride


def _close(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= REL * np.max(np.abs(ref))


@pytest.mark.parametrize("s", CASES)
def test_conv_fwd_plain_matches_jax(s):
    xp, w, _, k, stride = _data(s)
    (xc, sx), (wc, sw) = codes(torch.from_numpy(xp), 8), codes(torch.from_numpy(w), 8)
    xq, wq = quantize(torch.from_numpy(xp), 8), quantize(torch.from_numpy(w), 8)
    assert torch.equal(xc.float() * sx, xq) and torch.equal(wc.float() * sw, wq)
    y = K.conv_fwd(xc, sx, wc, sw, k, stride)
    ref = jops.conv_fwd(jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), k,
                        stride, interpret=True)
    _close(y.numpy(), ref)


@pytest.mark.parametrize("s", CASES)
def test_conv_grad_x_plain_matches_jax(s):
    xp, w, gy, k, stride = _data(s)
    (gc, sg), (wc, sw) = codes(torch.from_numpy(gy), 16), codes(torch.from_numpy(w), 8)
    gq = quantize(torch.from_numpy(gy), 16)
    wq = quantize(torch.from_numpy(w), 8)
    assert torch.equal(gc.float() * sg, gq) and torch.equal(wc.float() * sw, wq)
    dx = K.conv_grad_x(gc, sg, wc, sw, k, stride, xp.shape[1], xp.shape[2])
    ref = jops.conv_grad_x(jnp.asarray(gq.numpy()), jnp.asarray(wq.numpy()),
                           k, stride, xp.shape[1], xp.shape[2], interpret=True)
    _close(dx.numpy(), ref)


def _exact_in_fp32(x, g, k, stride):
    """Every fp32 partial sum of ``window(x)^T g`` is exact below 2**24."""
    bound = K._code_product(x.abs(), g.abs(), k, stride)
    return float(bound.max()) < 2 ** 24


@pytest.mark.parametrize("s", CASES)
def test_psg_grad_w_plain_matches_jax_kernels(s):
    xp, _, gy, k, stride = _data(s)
    xt, gt = torch.from_numpy(xp), torch.from_numpy(gy)
    xm, _ = codes(xt, 4)
    gm, _ = codes(gt, 10)
    xq, _ = codes(xt, 8)
    gq, _ = codes(gt, 16)
    assert _exact_in_fp32(xq, gq, k, stride)
    pred = K.conv_grad_w_predictor(xm, gm, k, stride)
    jpred = jconv.conv_grad_w_predictor_pallas(
        jnp.asarray(xm.numpy()), jnp.asarray(gm.numpy()), k=k, stride=stride)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred).astype(np.int64))
    tau = 0.05 * pred.float().abs().amax()
    jtau = 0.05 * jnp.max(jnp.abs(jpred))
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
    sign, stats = K.conv_grad_w(pred, xq, gq, tau, k, stride)
    jsign, jstats = jconv.conv_grad_w_pallas(
        jnp.asarray(xm.numpy()), jnp.asarray(gm.numpy()),
        jnp.asarray(xq.numpy()), jnp.asarray(gq.numpy()), jtau, k=k,
        stride=stride)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))


@pytest.mark.parametrize("s", CASES)
def test_conv_grad_w_op_matches_jax(s):
    xp, _, gy, k, stride = _data(s)
    sign, fb = tops.conv_grad_w(torch.from_numpy(xp), torch.from_numpy(gy),
                                CFG, k, stride)
    jsign, jfb = jops.conv_grad_w(jnp.asarray(xp), jnp.asarray(gy), JCFG, k,
                                  stride, interpret=True)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    assert float(fb) == float(jfb)


def test_padded_dout_block_counts_as_fallback():
    """dout=200 -> blocks of 128, the second padded: with tau > 0 its flag
    is set even where every real column is predictor-confident."""
    pred = torch.full((4, 200), 1000, dtype=torch.float32)
    xq = torch.zeros((1, 2, 2, 4), dtype=torch.int8)
    gq = torch.zeros((1, 2, 2, 200), dtype=torch.int16)
    sign, stats = K.conv_grad_w(pred, xq, gq, torch.tensor(1.0), 1, 1)
    assert stats.tolist() == [[0, 1]]
    assert bool((sign == 1).all())


@pytest.mark.parametrize("s", CASES)
def test_psg_conv2d_function_matches_jax_vjp(s):
    """(y, dx, dw, dprobe) of the autograd Function against ``jax.vjp`` of
    the JAX package's ``psg.conv2d`` under ``psg.enable``, from the
    unpadded input (padding, subsample and dx cropping included)."""
    r = np.random.RandomState(3 + s.cout)
    x = r.randn(s.batch, s.hw, s.hw, s.cin).astype(np.float32)
    w = (r.randn(s.k * s.k * s.cin, s.cout) * 0.1).astype(np.float32)
    ho = s.hw_out
    gy = (r.randn(s.batch, ho, ho, s.cout) * 0.01).astype(np.float32)
    gy.flat[0] = 0.1

    def f(x_, w_, probe_):
        with jpsg.enable(JCFG, probe=probe_):
            return jpsg.conv2d(x_, w_, k=s.k, stride=s.stride)

    jy, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.zeros((2,)))
    jdx, jdw, jdprobe = vjp(jnp.asarray(gy))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    probe = tpsg.zero_probe()
    with tpsg.enable(CFG, probe=probe):
        y = tpsg.conv2d(xt, wt, k=s.k, stride=s.stride)
    y.backward(torch.from_numpy(gy))
    _close(y.detach().numpy(), jy)
    _close(xt.grad.numpy(), jdx)
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))
    np.testing.assert_array_equal(probe.grad.numpy(), np.asarray(jdprobe))


def test_stem_input_gets_no_gradient_work():
    """An input that needs no gradient (the stem's image) skips dx."""
    x = torch.randn(1, 4, 4, 3)
    w = torch.randn(27, 8, requires_grad=True)
    with tpsg.enable(CFG, probe=tpsg.zero_probe()):
        y = tpsg.conv2d(x, w, k=3)
    y.sum().backward()
    assert x.grad is None and w.grad is not None


def test_wrappers_reject_what_the_kernels_do_not_take():
    one = torch.tensor(1.0)
    with pytest.raises(ValueError):
        K.conv_fwd(torch.zeros(1, 4, 4, 2, dtype=torch.int8), one,
                   torch.zeros(18, 3, dtype=torch.int8, device="meta"), one,
                   3, 1)
    assert K.conv_out_hw(34, 34, 3, 2) == (16, 16)
    assert K.fallback_blocks(200) == (128, 2)
    assert K.fallback_blocks(16) == (16, 1)
