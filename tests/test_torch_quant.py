"""repro_torch.core.quant against the JAX package's grids, bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels.ops import _codes as jax_codes  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402

BITS = [4, 8, 10, 16]


def _inputs():
    r = np.random.RandomState(0)
    # exact .5 ties: max|x| = 127 makes the 8-bit scale exactly 1.0
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    return {
        "normal": r.randn(257, 33).astype(np.float32),
        "wide": (r.randn(4, 9, 9, 5) * 1e3).astype(np.float32),
        "ties": ties,
        "zeros": np.zeros((16,), np.float32),
        "tiny": np.full((7,), 1e-14, np.float32),
    }


CASES = [pytest.param(name, b, id=f"{name}-{b}bit")
         for name in _inputs() for b in BITS]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,bits", CASES)
def test_qscale_and_quantize_bitwise(name, bits):
    x = _inputs()[name]
    xt = torch.from_numpy(x)
    _eq(tq.qscale(xt, bits).numpy(), jq.qscale(jnp.asarray(x), bits))
    _eq(tq.quantize(xt, bits).numpy(), jq.quantize(jnp.asarray(x), bits))


@pytest.mark.parametrize("name,bits", CASES)
def test_codes_bitwise(name, bits):
    x = _inputs()[name]
    c, s = tq.codes(torch.from_numpy(x), bits)
    jc, js = jax_codes(jnp.asarray(x), bits)
    assert str(c.dtype).split(".")[-1] == str(np.asarray(jc).dtype)
    _eq(c.numpy(), jc)
    _eq(s.numpy(), js)
    ci, si = tq.quantize_int(torch.from_numpy(x), bits)
    jci, jsi = jq.quantize_int(jnp.asarray(x), bits)
    _eq(ci.numpy(), jci)
    _eq(si.numpy(), jsi)


def test_ties_round_half_to_even():
    c, s = tq.codes(torch.from_numpy(_inputs()["ties"]), 8)
    assert float(s) == 1.0
    assert c.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_all_zero_tensor_uses_the_scale_floor():
    q = tq.quantize(torch.zeros(5), 8)
    assert torch.equal(q, torch.zeros(5))
    assert float(tq.qscale(torch.zeros(5), 8)) == np.float32(1e-12) / np.float32(127.0)
