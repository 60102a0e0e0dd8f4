"""Kernel 10 (fake-quantize) of repro_torch against the JAX package's.

The plain version of ``kernels/quant.py`` and ``dispatch.quantize`` under
each backend go against ``repro.kernels.ops.quantize`` (the Pallas kernel,
run by the interpreter as the JAX package's own tests run it) over the
shapes x bits of ``tests/test_kernels.py``, with bf16 input, exact .5 ties,
an all-zero tensor (the 1e-12 floor of the scale) and idempotence.

Tolerance: the codes ``round(out / s)`` must be identical.  The values equal
the JAX package's eager oracle (``ref.quantize_ref``) bit for bit; against
its jit'd kernel they are held to that package's own kernel-vs-oracle
tolerance, ``rtol=3e-7`` (``tests/test_kernels.py``): under jit, XLA divides
``max|x|`` by the code limit as a product by the reciprocal, so the scale
can sit one ulp off (2 of these 20 cases) and ``q * s`` then up to two ulps.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.quant import qscale  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402

SHAPES = [(128, 256), (7, 300), (1000,), (4, 4, 64)]
BITS = [2, 4, 8, 10, 16]
CASES = [pytest.param(shape, bits, id=f"{'x'.join(map(str, shape))}-{bits}bit")
         for shape in SHAPES for bits in BITS]


@functools.lru_cache(maxsize=None)
def _case(shape, bits):
    x = np.random.RandomState(bits).randn(*shape).astype(np.float32)
    return (x, np.array(jops.quantize(jnp.asarray(x), bits)),
            np.array(jref.quantize_ref(jnp.asarray(x), bits)))


def _check(out: torch.Tensor, x: np.ndarray, want_jit: np.ndarray,
           want_ref: np.ndarray, bits: int):
    s = qscale(torch.from_numpy(x), bits)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_array_equal(torch.round(out / s).numpy(),
                                  torch.round(torch.from_numpy(want_jit) / s)
                                  .numpy())
    np.testing.assert_array_equal(out.numpy(), want_ref)
    np.testing.assert_allclose(out.numpy(), want_jit, rtol=3e-7)


@pytest.mark.parametrize("shape,bits", CASES)
def test_plain_version_matches_jax_kernel(shape, bits):
    x, want_jit, want_ref = _case(shape, bits)
    xt = torch.from_numpy(x)
    _check(Q.quantize_plain(xt, qscale(xt, bits), bits), x, want_jit,
           want_ref, bits)
    _check(Q.quantize(xt, bits), x, want_jit, want_ref, bits)


@pytest.mark.parametrize("backend", ["auto", "plain", "reference"])
@pytest.mark.parametrize("shape,bits", CASES)
def test_dispatch_quantize_matches_jax_kernel(shape, bits, backend):
    x, want_jit, want_ref = _case(shape, bits)
    with dispatch.override_backend(backend):
        out = dispatch.quantize(torch.from_numpy(x), bits)
    _check(out, x, want_jit, want_ref, bits)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    Q.reset_launches()
    x = torch.randn(33, 17)
    torch.testing.assert_close(Q.quantize(x, 8),
                               Q.quantize_plain(x, qscale(x, 8), 8),
                               rtol=0, atol=0)
    assert Q.LAUNCHES["quantize"] == 0


def test_bf16_input():
    x = (np.random.RandomState(3).randn(64, 96) * 5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jops.quantize(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                         8)
    got = Q.quantize(xb, 8)
    assert got.dtype == torch.bfloat16
    s = qscale(xb, 8)
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
    np.testing.assert_array_equal(torch.round(got.float() / s).numpy(),
                                  torch.round(want_t / s).numpy())
    # one bf16 rounding of the same fp32 product: equal, or one bf16 ulp
    # apart where the jit'd scale sits an fp32 ulp off
    np.testing.assert_allclose(got.float().numpy(), want_t.numpy(),
                               rtol=2 ** -8)
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jref.quantize_ref(jnp.asarray(xb.float().numpy())
                                     .astype(jnp.bfloat16), 8)
                   .astype(jnp.float32)))


def test_exact_half_ties_round_to_even():
    # max|x| = 127 makes the 8-bit scale exactly 1.0
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5], np.float32)
    got = Q.quantize(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, [127, 0, 2, 2, -0, -2, 4, -126])
    np.testing.assert_array_equal(got, np.asarray(jops.quantize(
        jnp.asarray(x), 8)))


def test_all_zero_tensor_uses_the_scale_floor():
    x = torch.zeros(5, 7)
    np.testing.assert_array_equal(qscale(x, 8).numpy(), np.float32(1e-12) /
                                  np.float32(127.0))
    got = Q.quantize(x, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.quantize(jnp.zeros((5, 7)), 8)))
    assert not got.any()


def test_idempotent():
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 64)
                         .astype(np.float32))
    q1 = Q.quantize(x, 8)
    torch.testing.assert_close(Q.quantize(q1, 8), q1, rtol=0, atol=1e-7)


def test_rejects_other_dtypes_and_cuda_pin_on_cpu():
    with pytest.raises(ValueError):
        Q.quantize(torch.zeros(4, dtype=torch.float16), 8)
    with pytest.raises(ValueError):
        Q.quantize(torch.zeros(4, dtype=torch.int32), 8)
    with dispatch.override_backend("cuda"), pytest.raises(ValueError):
        dispatch.quantize(torch.randn(4), 8)
