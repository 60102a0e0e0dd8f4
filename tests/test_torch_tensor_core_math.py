"""The arithmetic that the tensor-core kernels 5 and 7 rest on, in plain
PyTorch on the CPU, against the JAX package's kernels.

* Kernel 5 (``predictor_matmul`` on int8 tensor cores) splits every int16
  g code into a signed high byte and an unsigned low byte and sums ``256
  x^T hi + x^T lo``.  The split must be exact for every int16 code, and the
  combined product must equal the plain version and JAX's
  ``predictor_matmul_pallas`` (interpret mode) exactly, also with every code
  at its limit and N not a multiple of the 32-token MMA depth.  The JAX
  kernel sums in fp32, exact below 2**24, which every case here stays under.
* Kernel 7 (``flash_fwd`` on bf16 tensor cores) rounds each fp32 P tile to
  ``p_hi + p_lo`` (two bf16) before its products with v.  Its plain
  emulation (``flash_attention_split_p``) must hold against JAX's
  ``flash_attention(..., return_lse=True, interpret=True)`` within the
  kernel's contract: o within one bf16 ulp of the larger magnitude plus
  ``1e-6 * max|o|``, lse within ``1e-5``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import psg_matmul as jpm  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import psg_matmul as PM  # noqa: E402


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
    assert torch.equal(got, PM.predictor_matmul_plain(xm, gm).long())
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
