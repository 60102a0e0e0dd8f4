"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips elsewhere;
the card is looked for inside a fixture, never at import time.  Run them
on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports JAX.)  Kernels 3-6
and 10 must equal their exact plain versions (kernels 3-6 also with every
code at its limit, past 65,536 positions or tokens a split and past 2**31;
kernels 3 and 4 also the emulations of their padded-grid arithmetic;
kernel 10 also on NaN, inf and zero inputs and above the L2, its scale
``qscale``'s bit for bit);
kernels 1 and 2 on 8-bit weight codes must equal the emulations of their
integer arithmetic bit for bit (kernel 2 also with every code at its limit,
its sums past int32); kernels 1, 2 and 8 sum in fp32 in another order than
their plain versions, within ``1e-5 * max|ref|`` of them (kernel 8 in bf16
also on inputs whose dq cancels); kernel 7's output is within one bf16 ulp (its bf16
kernel keeps about 16 bits of P; fp32: ``1e-5 * max|ref|``) and its lse
within 1e-5; kernel 9's code products equal the plain version's on integer inputs (its
bf16 kernel also the emulation of its tile arithmetic, at every head dim)
and elsewhere differ only where a P or dS code flips at a rounding boundary.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_cnns import resnet_conv_shapes  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.core import psg  # noqa: E402
from repro_torch.core.quant import codes, quantize  # noqa: E402
from repro_torch.kernels import conv as K  # noqa: E402
from repro_torch.kernels import psg_matmul as PM  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = resnet_conv_shapes(depth=14, width=16, batch=4)
SHAPES.append(SHAPES[0]._replace(hw=4, cin=40, cout=200, k=1, stride=1))
CASES = [pytest.param(s, id=f"{s.kind}_{s.hw}x{s.cin}-{s.cout}k{s.k}s{s.stride}")
         for s in SHAPES]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(s, dev):
    g = torch.Generator(device=dev).manual_seed(s.hw + s.cin + s.cout)
    hw, k, st = s.hw, s.k, s.stride
    if k < st:
        hw, st = -(-hw // st), 1
    hp = hw + 2 * (k // 2)
    ho = (hp - k) // st + 1
    x = torch.randn(s.batch, hp, hp, s.cin, device=dev, generator=g)
    w = torch.randn(k * k * s.cin, s.cout, device=dev, generator=g) * 0.1
    gy = torch.randn(s.batch, ho, ho, s.cout, device=dev, generator=g) * 0.01
    return x, w, gy, k, st, hp


def _close(a, ref):
    assert float((a - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("s", CASES)
def test_fwd_and_grad_x_kernels_match_plain(card, s):
    x, w, gy, k, st, hp = _data(s, card)
    (xc, sx), (wc, sw) = codes(x, 8), codes(w, 8)
    gc, sg = codes(gy, 16)
    xq, wq, gq = quantize(x, 8), quantize(w, 8), quantize(gy, 16)
    y = K.conv_fwd(xc, sx, wc, sw, k, st)
    _close(y, K.conv_fwd_plain(xq, wq, k, st))
    assert torch.equal(y, K.conv_fwd_codes_plain(xc, sx, wc, sw, k, st))
    dx = K.conv_grad_x(gc, sg, wc, sw, k, st, hp, hp)
    _close(dx, K.conv_grad_x_plain(gq, wq, k, st, hp, hp))
    assert torch.equal(dx, K.conv_grad_x_codes_plain(gc, sg, wc, sw, k, st,
                                                     hp, hp))


@pytest.mark.parametrize("s", CASES)
def test_grad_x_kernel_is_exact_with_codes_at_their_limits(card, s):
    """Every g code at +-32767 and every weight code at +-127, the signs
    aligned a channel, so that the 3x3 dout-64 sums reach 576 * 32767 *
    127 = 2.4e9, past int32: bit for bit the emulation, within 1e-5 of the
    fp32 plain version."""
    _, _, gy, k, st, hp = _data(s, card)
    g = torch.Generator(device=card).manual_seed(s.cout)
    sigma = torch.where(torch.randn(s.cout, device=card, generator=g) < 0,
                        -1, 1)
    for sign in (1, -1):
        gc = (sign * 32767 * sigma).expand(gy.shape).to(torch.int16) \
            .contiguous()
        wc = (127 * sigma).expand(k * k * s.cin, s.cout).to(torch.int8) \
            .contiguous()
        sg, sw = (torch.tensor(v, device=card) for v in (3.1e-7, 7.9e-3))
        dx = K.conv_grad_x(gc, sg, wc, sw, k, st, hp, hp)
        assert torch.equal(dx, K.conv_grad_x_codes_plain(gc, sg, wc, sw, k,
                                                         st, hp, hp))
        _close(dx, K.conv_grad_x_plain(gc.float() * sg, wc.float() * sw, k,
                                       st, hp, hp))


@pytest.mark.parametrize("s", CASES)
def test_psg_kernels_equal_plain(card, s):
    x, _, gy, k, st, _ = _data(s, card)
    xm, _ = codes(x, 4)
    gm, _ = codes(gy, 10)
    xq, _ = codes(x, 8)
    gq, _ = codes(gy, 16)
    pred = K.conv_grad_w_predictor(xm, gm, k, st)
    assert torch.equal(pred, K.conv_grad_w_predictor_plain(xm, gm, k, st))
    tau = 0.05 * pred.float().abs().amax()
    sign, stats = K.conv_grad_w(pred, xq, gq, tau, k, st)
    psign, pstats = K.conv_grad_w_plain(pred, xq, gq, tau, k, st)
    assert torch.equal(sign, psign) and torch.equal(stats, pstats)


def test_psg_conv2d_on_the_card_counts_its_launches(card):
    x = torch.randn(2, 8, 8, 16, device=card, requires_grad=True)
    w = torch.randn(144, 32, device=card, requires_grad=True)
    K.reset_launches()
    with psg.enable(PSGConfig(enabled=True), probe=psg.zero_probe(card)):
        y = psg.conv2d(x, w, k=3, stride=2)
    y.sum().backward()
    torch.cuda.synchronize()
    assert all(n == 1 for n in K.LAUNCHES.values()), K.LAUNCHES


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    one = torch.ones((), device=card)
    x = torch.zeros(1, 4, 4, 2, device=card, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.conv_fwd(x, one, torch.zeros(18, 3, device=card, dtype=torch.int32),
                   one, 3, 1)
    with pytest.raises(ValueError):
        K.conv_fwd(x.to(torch.int8), one, torch.zeros(18, 3, dtype=torch.int8),
                   one, 3, 1)
    with pytest.raises(ValueError):              # codes of two widths
        K.conv_fwd(x.to(torch.int8), one,
                   torch.zeros(18, 3, device=card, dtype=torch.int16), one, 3, 1)
    x5 = torch.zeros(1, 6, 6, 2, device=card, dtype=torch.int8)
    g5 = torch.zeros(1, 2, 2, 3, device=card, dtype=torch.int16)
    with pytest.raises(ValueError, match="up to 3x3"):   # k above 3
        K.conv_grad_w(torch.zeros(50, 3, device=card), x5, g5, one, 5, 1)


# (N, din, dout) of the PSG matmul kernels: tiles smaller than 128, a padded
# 200 x 328 grid with N not a multiple of the 32-token stage, two qwen2.5-3b
# projections at a short sequence, two ResNet-74 im2col geometries (the stem
# and a 16-channel 3x3 conv at batch 32) and the qwen2.5-3b k_proj width at
# its training N (8192 tokens); then two with enough 128 x 128 tiles that the
# token axis is not split (the sign kernel's fused select), one of them
# with partly padded tiles in its last row and column
MATMULS = [(64, 32, 48), (1000, 200, 328), (2048, 2048, 256),
           (1024, 11008, 128), (32768, 27, 16), (32768, 144, 32),
           (8192, 2048, 256), (1000, 2048, 1280), (500, 1100, 2100)]


@pytest.mark.parametrize("s", MATMULS, ids=lambda s: "N{}_{}x{}".format(*s))
def test_psg_matmul_kernels_equal_plain(card, s):
    N, din, dout = s
    g = torch.Generator(device=card).manual_seed(N + din + dout)
    x = torch.randn(N, din, device=card, generator=g)
    gy = torch.randn(N, dout, device=card, generator=g) * 0.01
    xm, gm = codes(x, 4)[0], codes(gy, 10)[0]
    xq, gq = codes(x, 8)[0], codes(gy, 16)[0]
    pred = PM.predictor_matmul(xm, gm)
    assert torch.equal(pred, PM.predictor_matmul_plain(xm, gm))
    for tau in (0.05 * pred.float().abs().amax(), torch.zeros((), device=card)):
        sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
        psign, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
        assert torch.equal(sign, psign) and torch.equal(stats, pstats)


@pytest.mark.parametrize("N", [(2 ** 31 - 1) // (7 * 511), 700_000],
                         ids=["old_limit", "past_old_limit"])
@pytest.mark.parametrize("dout", [32, 160])
def test_predictor_kernel_is_exact_at_the_worst_case_magnitude(card, dout, N):
    """Every 4-bit x code at +-7 and every 10-bit g code at +-511, signed so
    that every output element is +-N * 7 * 511: at the largest token count
    the int32 version took (odd, so not a multiple of any stage), and past
    it, where the sums pass 2**31 (the output is fp32, the exact sum
    rounded once).  Where g is -511 (hi = -2, lo = 1) the high plane's 256
    * sum(x hi) is larger still."""
    g = torch.Generator(device=card).manual_seed(dout)
    sign = lambda *s: torch.randint(0, 2, s, device=card,  # noqa: E731
                                    generator=g) * 2 - 1
    tok = sign(N, 1)
    xm = (7 * tok * sign(1, 48)).to(torch.int8)
    gm = (511 * tok * sign(1, dout)).to(torch.int16)
    pred = PM.predictor_matmul(xm, gm)
    assert pred.dtype == torch.float32
    assert torch.equal(pred, PM.predictor_matmul_plain(xm, gm))
    top = torch.tensor(float(N * 7 * 511), device=card)     # rounded to fp32
    assert bool((pred.abs() == top).all())


@pytest.mark.parametrize("N,din,dout", [(700_000, 48, 160),
                                         (700_000, 48, 32),
                                         (65_536, 1536, 1536)],
                         ids=["split_128x128", "split_128x32", "fused"])
def test_sign_kernel_is_exact_at_the_worst_case_magnitude(card, N, din, dout):
    """Every 8-bit x code at +-127 and every 16-bit g code at +-32767,
    signed so that every element of the full product is +-N * 127 * 32767
    (2.9e12 at N = 700,000: past 65,536 tokens per split and past 2**31;
    1536 x 1536 at N = 65,536 runs one split, the fused select, with each
    plane's int32 sum at its largest).  tau lies above every |pred|, so
    every sign comes from the full product; the int64 product itself
    (``psg_full_product``) must equal the exact one."""
    g = torch.Generator(device=card).manual_seed(N + dout)
    sign = lambda *s: torch.randint(0, 2, s, device=card,  # noqa: E731
                                    generator=g) * 2 - 1
    tok = sign(N, 1)
    xq = (127 * tok * sign(1, din)).to(torch.int8)
    gq = (32767 * tok * sign(1, dout)).to(torch.int16)
    full = PM.psg_full_product(xq, gq)
    want = PM._code_product(xq, gq).to(torch.int64)
    assert full.dtype == torch.int64 and torch.equal(full, want)
    assert bool((full.abs() == N * 127 * 32767).all())
    pred = torch.randn(din, dout, device=card, generator=g)
    tau = 2 * pred.abs().amax()
    s, stats = PM.psg_grad_w(pred, xq, gq, tau)
    ps, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
    assert torch.equal(s, ps) and torch.equal(stats, pstats)
    assert torch.equal(s, torch.sign(full).to(torch.int8))
    assert bool(stats.all())


def test_psg_matmul_on_the_card_counts_its_launches(card):
    x = torch.randn(300, 96, device=card, requires_grad=True)
    w = torch.randn(96, 160, device=card, requires_grad=True)
    PM.reset_launches()
    with psg.enable(PSGConfig(enabled=True), probe=psg.zero_probe(card)):
        y = psg.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert PM.LAUNCHES == {"predictor_matmul": 1, "psg_grad_w": 1}
    assert set(w.grad.unique().tolist()) <= {-1.0, 0.0, 1.0}


def test_lm_trainer_runs_on_the_card(card):
    from repro_torch.launch.train import build_lm_trainer
    trainer = build_lm_trainer("qwen2_5_3b", smoke=True, steps=3,
                               device="cuda")
    PM.reset_launches()
    hist = trainer.run(3)
    assert hist and all(h["loss"] == h["loss"] for h in hist)
    assert all(n > 0 for n in PM.LAUNCHES.values()), PM.LAUNCHES


# ---------------------------------------------------------------------------
# flash attention (kernels 7-9)
# ---------------------------------------------------------------------------

# (B, S, nh, nkv, hd, causal): the reduced qwen2.5-3b head dim, MHA with S
# padded past two 64-row tiles, GQA at the qwen2.5-3b head dim, non-causal;
# then S = T not a multiple of the bf16 forward's 128-row query block or
# 64-row kv stage: the qwen2.5-3b grouping (g = 8) at hd 128, and a
# non-causal g = 4 one; then hd 96 (phi-3-vision's head dim, whose columns
# do not come in groups of 64) with g = 1 (whisper's and phi-3's MHA), causal,
# and with g = 4, non-causal, S past eight 64-row tiles (large enough that the
# 0.1% limit of the random-input kernel 9 check admits one flipped code)
FLASH = [(2, 40, 4, 2, 16, True), (2, 300, 8, 8, 32, True),
         (1, 256, 4, 2, 128, True), (1, 200, 4, 4, 64, False),
         (1, 200, 16, 2, 128, True), (2, 77, 4, 1, 64, False),
         (1, 200, 4, 4, 96, True), (1, 520, 8, 2, 96, False)]
FLASH_IDS = ["hd16", "mha_padded", "gqa_hd128", "noncausal", "gqa8_hd128",
             "ragged_noncausal", "hd96_g1", "gqa_hd96_noncausal"]
# the integer-input cases: the first three and both hd 96 ones
FLASH_INT = FLASH[:3] + FLASH[6:]
FLASH_INT_IDS = FLASH_IDS[:3] + FLASH_IDS[6:]


def _flash_data(shape, dev, dtype, integer=False):
    B, S, nh, nkv, hd, _ = shape
    g = torch.Generator(device=dev).manual_seed(S + nh + hd)
    if integer:
        draw = lambda *s: torch.randint(-2, 3, s, device=dev,  # noqa: E731
                                        generator=g).float()
    else:
        draw = lambda *s: torch.randn(*s, device=dev,  # noqa: E731
                                      generator=g)
    q, k, v = draw(B, S, nh, hd), draw(B, S, nkv, hd), draw(B, S, nkv, hd)
    do = draw(B, S, nh, hd) * (1.0 if integer else 0.1)
    return tuple(t.to(dtype) for t in (q, k, v, do))


def _bf16_close(a, ref):
    """Within one bf16 ulp of the larger magnitude, plus 1e-6 * max|ref|
    for the fp32 difference before the rounding."""
    a, ref = a.double(), ref.double()
    big = torch.maximum(a.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((a - ref).abs() <= ulp + 1e-6 * ref.abs().max()).all())


def _dkv_inputs(q, k, v, do, causal):
    from repro_torch.kernels import flash_attn as FA
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8, bits_x_msb=4,
                                     bits_g=16, bits_g_msb=10)
    return lse, delta, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLASH, ids=FLASH_IDS)
def test_flash_fwd_and_dq_kernels_match_plain(card, shape, dtype):
    from repro_torch.kernels import flash_attn as FA
    causal = shape[-1]
    q, k, v, do = _flash_data(shape, card, dtype)
    o, lse = FA.flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = FA.flash_attention_plain(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        _bf16_close(o.float(), o_p.float())
    else:
        _close(o, o_p)
    assert float((lse - lse_p).abs().max()) <= 1e-5
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o_p.float()).contiguous()
    _close(FA.flash_bwd_dq(q, k, v, do, lse_p, delta, causal=causal),
           FA.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLASH, ids=FLASH_IDS)
def test_flash_dkv_kernel_matches_plain(card, shape, dtype):
    """A P or dS code may flip where the kernel's q k^T sums in another
    order than the plain matmul: at most 0.1% of the elements differ, by at
    most 1e-3 of the largest magnitude."""
    from repro_torch.kernels import flash_attn as FA
    causal = shape[-1]
    q, k, v, do = _flash_data(shape, card, dtype)
    lse, delta, scales = _dkv_inputs(q, k, v, do, causal)
    lims = (127.0, 7.0, 32767.0, 511.0)
    got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims,
                           causal=causal)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, lims=lims,
                                  causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        diff = (g - w).abs().double()
        assert float((diff > 0).double().mean()) <= 1e-3
        assert float(diff.max()) <= 1e-3 * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_INT, ids=FLASH_INT_IDS)
def test_flash_dkv_kernel_is_bit_identical_on_integer_inputs(card, shape,
                                                             dtype):
    """Small integer q, k, v and dO make every score and dP exact in any
    summation order, so the codes, and the products, must be identical."""
    from repro_torch.kernels import flash_attn as FA
    causal = shape[-1]
    q, k, v, do = _flash_data(shape, card, dtype, integer=True)
    lse, delta, scales = _dkv_inputs(q, k, v, do, causal)
    lims = (127.0, 7.0, 32767.0, 511.0)
    got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims,
                           causal=causal)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, lims=lims,
                                  causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert any(bool((w != 0).any()) for w in want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128])
def test_flash_dkv_bf16_kernel_at_every_head_dim(card, hd, causal):
    """The bf16 kernel 9 (bf16 and int8 tensor cores) at every head dim it
    is built for, S = 300 (not a multiple of the 64-row tiles), g = 4: on
    integer inputs bit for bit against the plain version and the emulation
    of its tile arithmetic (``flash_bwd_dkv_mma_plain``), at the paper's
    code limits and with every limit at its largest (full and predictor
    sums both flushed into int64 every 8 query tiles)."""
    from repro_torch.kernels import flash_attn as FA
    shape = (1, 300, 8, 2, hd, causal)
    q, k, v, do = _flash_data(shape, card, torch.bfloat16, integer=True)
    lse, delta, scales = _dkv_inputs(q, k, v, do, causal)
    for lims in ((127.0, 7.0, 32767.0, 511.0),
                 (127.0, 127.0, 32767.0, 32767.0)):
        FA.reset_launches()
        got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims,
                               causal=causal)
        assert FA.LAUNCHES["flash_bwd_dkv"] == 1
        want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales,
                                      lims=lims, causal=causal)
        emul = FA.flash_bwd_dkv_mma_plain(q, k, v, do, lse, delta, scales,
                                          lims=lims, causal=causal)
        for g_, w_, e_ in zip(got, want, emul):
            assert torch.equal(g_, w_) and torch.equal(g_, e_)
        assert all(bool((w_ != 0).any()) for w_ in want)


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import flash_attn as FA
    q = torch.randn(1, 8, 2, 16, device=card)
    with pytest.raises(ValueError):
        FA.flash_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        FA.flash_fwd(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        FA.flash_fwd(q[..., :8].contiguous(), q[..., :8].contiguous(),
                     q[..., :8].contiguous())          # head dim 8
    with pytest.raises(ValueError):
        FA.flash_fwd(q, torch.randn(1, 8, 3, 16, device=card),
                     torch.randn(1, 8, 3, 16, device=card))   # 2 % 3
    flat = torch.randn(8 * 2 * 16 + 1, device=card)
    with pytest.raises(ValueError):                     # 4-byte offset
        FA.flash_fwd(*(flat[1:].view(1, 8, 2, 16),) * 3)
    lse = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(ValueError):
        FA.flash_bwd_dq(q, q, q, q, lse.double(), lse)
    with pytest.raises(ValueError):
        FA.flash_bwd_dkv(q, q, q, q, lse, lse, torch.ones(5, device=card),
                         lims=(127.0, 7.0, 32767.0, 511.0))


def test_psg_attention_on_the_card_counts_its_launches(card):
    from repro_torch.kernels import flash_attn as FA
    q, k, v, do = _flash_data(FLASH[0], card, torch.bfloat16)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    FA.reset_launches()
    cfg = PSGConfig(enabled=True, fused_attention=True)
    with psg.enable(cfg, probe=psg.zero_probe(card)):
        o = psg.attention(q, k, v, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    assert all(bool(t.grad.float().isfinite().all()) for t in (q, k, v))


def test_flash_lm_trainer_runs_on_the_card(card):
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.launch.train import build_lm_trainer
    trainer = build_lm_trainer("qwen2_5_3b", smoke=True, steps=3,
                               device="cuda", fused_attention=True)
    PM.reset_launches()
    FA.reset_launches()
    hist = trainer.run(3)
    assert hist and all(h["loss"] == h["loss"] for h in hist)
    assert all(n > 0 for n in PM.LAUNCHES.values()), PM.LAUNCHES
    assert all(n > 0 for n in FA.LAUNCHES.values()), FA.LAUNCHES


# kernel 10: shapes of tests/test_kernels.py, a bf16 one, a view that is not
# 16-byte aligned, sizes that are not multiples of 4 or 8
QUANT = [((128, 256), "float32"), ((7, 300), "float32"), ((1000,), "float32"),
         ((4, 4, 64), "float32"), ((7, 300), "bfloat16"),
         ((3, 5, 11), "bfloat16"), ((1,), "float32")]


@pytest.mark.parametrize("bits", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("shape,dt", QUANT,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_quantize_kernel_equals_plain_bit_for_bit(card, shape, dt, bits):
    from repro_torch.core.quant import qscale
    from repro_torch.kernels import quant as Q
    dtype = getattr(torch, dt)
    g = torch.Generator(device=card).manual_seed(bits)
    view = torch.int32 if dt == "float32" else torch.int16
    n = 1
    for d in shape:
        n *= d
    for offset in (0, 1):       # 1: a view 4 or 2 bytes into its storage
        x = (torch.randn(n + offset, device=card, generator=g) * 3).to(dtype)
        x = x[offset:].view(shape)
        Q.reset_launches()
        out = Q.quantize(x, bits)
        assert Q.LAUNCHES["quantize"] == 1
        want = Q.quantize_plain(x, qscale(x, bits), bits)
        assert out.dtype == dtype and out.shape == x.shape
        assert torch.equal(out.view(view), want.view(view))


def test_quantize_kernel_on_the_card_through_dispatch(card):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import quant as Q
    x = torch.randn(257, 33, device=card)
    Q.reset_launches()
    y = dispatch.quantize(x, 8)
    assert Q.LAUNCHES["quantize"] == 1
    for backend in ("plain", "reference"):
        with dispatch.override_backend(backend):
            torch.testing.assert_close(dispatch.quantize(x, 8), y, rtol=0,
                                       atol=0)
    assert Q.LAUNCHES["quantize"] == 1
    with pytest.raises(ValueError):
        Q.quantize(x.half(), 8)


def test_resnet_im2col_and_psg_off_trainers_run_on_the_card(card):
    from repro_torch.launch.train import E2TRAIN, build_trainer
    trainer = build_trainer(depth=8, width=8, batch=4, steps=3, device="cuda",
                            fused_conv=False)
    K.reset_launches()
    PM.reset_launches()
    hist = trainer.run(3)
    assert hist and all(h["loss"] == h["loss"] for h in hist)
    assert all(n > 0 for n in PM.LAUNCHES.values()), PM.LAUNCHES
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
    trainer = build_trainer(depth=8, width=8, batch=4, steps=2, device="cuda",
                            e2=E2TRAIN["off"])
    PM.reset_launches()
    hist = trainer.run(2)
    assert len(hist) == 2 and trainer.measured_psg_fallback() is None
    assert not any(PM.LAUNCHES.values()) and not any(K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# kernels 1 and 3 on int8 tensor cores; pass 1 past its old int32 limits;
# kernel 7 against an adversarial v
# ---------------------------------------------------------------------------

RESNET74 = resnet_conv_shapes(depth=74, width=16, batch=128)


@pytest.mark.parametrize("s", RESNET74, ids=[
    f"{s.kind}_{s.hw}x{s.cin}-{s.cout}k{s.k}s{s.stride}" for s in RESNET74])
def test_tensor_core_conv_kernels_at_resnet74_geometries(card, s):
    """Kernel 1 on 8-bit codes: within 1e-5 * max|ref| of the plain version
    and bit for bit the emulation of its integer arithmetic.  Kernel 3: bit
    for bit its plain version and the emulation of its padded-grid
    arithmetic, also with every code at its limit."""
    x, w, gy, k, st, _ = _data(s, card)
    (xc, sx), (wc, sw) = codes(x, 8), codes(w, 8)
    y = K.conv_fwd(xc, sx, wc, sw, k, st)
    _close(y, K.conv_fwd_plain(quantize(x, 8), quantize(w, 8), k, st))
    assert torch.equal(y, K.conv_fwd_codes_plain(xc, sx, wc, sw, k, st))
    xm, _ = codes(x, 4)
    gm, _ = codes(gy, 10)
    pred = K.conv_grad_w_predictor(xm, gm, k, st)
    assert pred.dtype == torch.float32
    assert torch.equal(pred, K.conv_grad_w_predictor_plain(xm, gm, k, st))
    assert torch.equal(pred, K.conv_grad_w_predictor_grid_plain(xm, gm, k, st))
    xl = (7 * torch.where(x < 0, -1, 1)).to(torch.int8)
    gl = (511 * torch.where(gy < 0, -1, 1)).to(torch.int16)
    assert torch.equal(K.conv_grad_w_predictor(xl, gl, k, st),
                       K.conv_grad_w_predictor_plain(xl, gl, k, st))


@pytest.mark.parametrize("s", RESNET74, ids=[
    f"{s.kind}_{s.hw}x{s.cin}-{s.cout}k{s.k}s{s.stride}" for s in RESNET74])
def test_conv_sign_kernel_at_resnet74_geometries(card, s):
    """Kernel 4 on int8 tensor cores: signs and flags bit for bit its plain
    version and the emulation of its padded-grid arithmetic, at tau 0
    (every sign from pred), beta max|pred| and above every |pred| (every
    sign from the full product)."""
    x, _, gy, k, st, _ = _data(s, card)
    xm, _ = codes(x, 4)
    gm, _ = codes(gy, 10)
    xq, _ = codes(x, 8)
    gq, _ = codes(gy, 16)
    pred = K.conv_grad_w_predictor(xm, gm, k, st)
    big = pred.abs().amax()
    for tau in (torch.zeros((), device=card), 0.05 * big, 2 * big + 1):
        sign, stats = K.conv_grad_w(pred, xq, gq, tau, k, st)
        psign, pstats = K.conv_grad_w_plain(pred, xq, gq, tau, k, st)
        gsign, gstats = K.conv_grad_w_grid_plain(pred, xq, gq, tau, k, st)
        assert torch.equal(sign, psign) and torch.equal(stats, pstats)
        assert torch.equal(sign, gsign) and torch.equal(stats, gstats)


@pytest.mark.parametrize("dout", [16, 160])
def test_conv_sign_kernel_is_exact_at_the_worst_case(card, dout):
    """Batch 128 at 32 x 32 (147,968 grid positions, past one 65,536-position
    split), every x code at +-127 and every g code at +-32767, signed per
    image and per channel or column: every element of the full product is
    +-(its tap's positions) * 127 * 32767, past 2**31.  At tau above every
    |pred| the signs are those of the exact product and every flag is set;
    at tau 0 the signs are pred's and no flag is set."""
    g = torch.Generator(device=card).manual_seed(dout)

    def sign(*shape):
        return torch.randint(0, 2, shape, device=card, generator=g) * 2 - 1

    B, C = 128, 16
    img = sign(B, 1, 1, 1)
    xq = torch.zeros(B, 34, 34, C, device=card, dtype=torch.int8)
    xq[:, 1:-1, 1:-1] = (127 * img * sign(1, 1, 1, C)).to(torch.int8)
    gq = (32767 * img * sign(1, 1, 1, dout)).expand(B, 32, 32, dout) \
        .to(torch.int16).contiguous()
    full = K._code_product(xq, gq, 3, 1)
    assert float(full.abs().min()) > 2 ** 31
    pred = torch.randn(9 * C, dout, device=card, generator=g)
    for tau, want in ((2 * pred.abs().amax(), full),
                      (torch.zeros((), device=card), pred)):
        s_, stats = K.conv_grad_w(pred, xq, gq, tau, 3, 1)
        ps, pstats = K.conv_grad_w_plain(pred, xq, gq, tau, 3, 1)
        assert torch.equal(s_, ps) and torch.equal(stats, pstats)
        assert torch.equal(s_, torch.sign(want).to(torch.int8))
        assert bool((stats == int(want is full)).all())


def test_conv_predictor_past_its_old_int32_limit(card):
    """Batch 640 of 32 x 32 images, every code at its limit: the sums reach
    640 * 1024 * 7 * 511 > 2**31, where the int32 version raised."""
    g = torch.Generator(device=card).manual_seed(640)
    x = torch.randn(640, 34, 34, 3, device=card, generator=g)
    gy = torch.randn(640, 32, 32, 16, device=card, generator=g)
    xm = (7 * torch.where(x < 0, -1, 1)).to(torch.int8)
    gm = (511 * torch.where(gy < 0, -1, 1)).to(torch.int16)
    pred = K.conv_grad_w_predictor(xm, gm, 3, 1)
    assert torch.equal(pred, K.conv_grad_w_predictor_plain(xm, gm, 3, 1))


def test_conv_fwd_on_int16_codes_runs_the_fp32_kernel(card):
    g = torch.Generator(device=card).manual_seed(16)
    x = torch.randn(8, 18, 18, 32, device=card, generator=g)
    w = torch.randn(288, 32, device=card, generator=g) * 0.1
    (xc, sx), (wc, sw) = codes(x, 12), codes(w, 12)
    assert xc.dtype == torch.int16
    K.reset_launches()
    y = K.conv_fwd(xc, sx, wc, sw, 3, 1)
    assert K.LAUNCHES["conv_fwd"] == 1
    _close(y, K.conv_fwd_plain(xc.float() * sx, wc.float() * sw, 3, 1))


def test_conv_grad_x_on_int16_weight_codes_runs_the_fp32_kernel(card):
    g = torch.Generator(device=card).manual_seed(4)
    w = torch.randn(288, 32, device=card, generator=g) * 0.1
    gy = torch.randn(8, 16, 16, 32, device=card, generator=g) * 0.01
    (gc, sg), (wc, sw) = codes(gy, 16), codes(w, 12)
    assert wc.dtype == torch.int16
    _close(K.conv_grad_x(gc, sg, wc, sw, 3, 1, 18, 18),
           K.conv_grad_x_plain(gc.float() * sg, wc.float() * sw, 3, 1, 18, 18))


def test_flash_dq_bf16_kernel_on_cancelling_inputs(card):
    """Kernel 8 on ``dq_cancel_inputs`` at the qwen2.5-3b attention
    geometry (batch 2 x 4096, 16 heads over 2 kv heads, hd 128, causal):
    the tensor-core kernel (three bf16 parts of dS) and the CUDA-core kernel
    (on the same values in fp32) within ``1e-5 * max|dq|`` of the plain
    version."""
    from repro_torch.kernels import flash_attn as FA
    q, k, v, do = FA.dq_cancel_inputs(2, 4096, 16, 2, 128, device=card)
    lse, delta, _ = _dkv_inputs(q, k, v, do, True)
    want = FA.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    _close(FA.flash_bwd_dq(q, k, v, do, lse, delta), want)
    _close(FA.flash_bwd_dq(q.float(), k.float(), v.float(), do.float(), lse,
                           delta), want)


def test_flash_dkv_kernel_past_its_old_int32_limit(card):
    """S g = 9472 * 64 = 606,208 query rows per kv head, past the 600,358
    the int32 predictor sums took; small integer inputs, so bit for bit."""
    from repro_torch.kernels import flash_attn as FA
    shape = (1, 9472, 64, 1, 16, True)
    q, k, v, do = _flash_data(shape, card, torch.bfloat16, integer=True)
    lse, delta, scales = _dkv_inputs(q, k, v, do, True)
    lims = (127.0, 7.0, 32767.0, 511.0)
    got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, lims=lims)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int64 and torch.equal(g_, w_)


def test_flash_fwd_holds_its_contract_on_a_split_p_adversarial_v(card):
    """The qwen2.5-3b attention geometry with v built against kernel 7's
    split P (``split_p_adversarial_v``): o within one bf16 ulp plus 1e-6 *
    max|o| of the plain version, lse within 1e-5."""
    from repro_torch.kernels import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(2, 4096, 16, 128, device=card, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 4096, 2, 128, device=card, generator=g).to(torch.bfloat16)
    v = FA.split_p_adversarial_v(q, k)
    o, lse = FA.flash_fwd(q, k, v)
    o_p, lse_p = FA.flash_attention_plain(q, k, v)
    _bf16_close(o.float(), o_p.float())
    assert float((lse - lse_p).abs().max()) <= 1e-5


def _quant_special(kind, shape, dtype, dev, g):
    x = (torch.randn(shape, device=dev, generator=g) * 3).to(dtype)
    if kind in ("zero", "neg_zero"):
        x.fill_(-0.0 if kind == "neg_zero" else 0.0)
    elif kind != "random":
        x.view(-1)[x.numel() // 3] = {"nan": float("nan"), "inf": float("inf"),
                                      "neg_inf": -float("inf")}[kind]
    return x


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["nan", "inf", "neg_inf", "zero", "neg_zero",
                                  "random"])
def test_quantize_kernel_on_special_values_and_above_l2(card, kind, dt):
    """Kernel 10 (the scale's reduction and the pass) bit for bit
    ``quantize_plain(x, qscale(x, bits))``, its scale ``qscale``'s, on
    inputs holding a NaN, an inf, only zeros or only -0.0, at a small
    shape, an unaligned view and the qwen2.5-3b gy shape (8192 x 11008,
    180 MB in bf16, above the 50 MB L2)."""
    from repro_torch.core.quant import qscale
    from repro_torch.kernels import quant as Q
    dtype = getattr(torch, dt)
    view = torch.int32 if dt == "float32" else torch.int16
    g = torch.Generator(device=card).manual_seed(11)
    shapes = [(7, 300), (8192, 11008)] if kind in ("nan", "random") \
        else [(7, 300)]
    for shape in shapes:
        for offset in (0, 1):
            base = _quant_special(kind, (shape[0] * shape[1] + offset,),
                                  dtype, card, g)
            x = base[offset:].view(shape)
            for bits in (8, 16):
                Q.reset_launches()
                out, s = Q.quantize_with_scale(x, bits)
                assert Q.LAUNCHES["quantize"] == 1
                want_s = qscale(x, bits)
                assert torch.equal(s.view(torch.int32), want_s.view(torch.int32))
                want = Q.quantize_plain(x, want_s, bits)
                assert torch.equal(out.view(view), want.view(view))
                assert torch.equal(Q.quantize(x, bits).view(view),
                                   want.view(view))
            del base, x, out, want


def test_slu_decide_kernel_matches_plain(card):
    from repro_torch.kernels import graph_cond
    gen = torch.Generator(device=card).manual_seed(0)
    u = torch.rand(4099, device=card, generator=gen)
    p = torch.rand(4099, device=card, generator=gen)
    p[:64] = u[:64]
    for force in (False, True):
        got = graph_cond.slu_decide(u, p, force)
        torch.cuda.synchronize()
        assert torch.equal(got, graph_cond.slu_decide_plain(u, p, force))


def test_graphed_chunk_matches_per_step(card):
    """The chunked loop on the card (one captured graph, gated blocks as
    IF nodes) equals the per-step loop bit for bit."""
    from repro_torch.launch.train import build_trainer
    runs = []
    for k in (1, 4):
        tr = build_trainer(depth=14, width=8, batch=16, steps=16,
                           device=card, chunk_steps=k)
        tr.run(16)
        runs.append(tr)
    a, b = runs
    for key in ("step", "total_loss", "slu_executed"):
        assert [h[key] for h in a.history] == [h[key] for h in b.history]
    assert b._chunk_fn.cond.nodes > 0
    for (n, x), (_, y) in zip(a.state.model.state_dict().items(),
                              b.state.model.state_dict().items()):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "whisper_small"])
def test_graphed_moe_and_encoder_chunks_match_per_step(card, arch):
    """The reduced MoE and enc-dec LMs through the chunked loop on the card
    (gated sub-blocks as IF nodes) equal the per-step loop bit for bit,
    the MoE's aux loss included (0 where a skipped MoE sub-block's IF node
    did not run)."""
    from repro_torch.launch.train import build_lm_trainer
    a, b = (build_lm_trainer(arch, num_layers=3, smoke=True, steps=16,
                             device=card, chunk_steps=k) for k in (1, 4))
    a.run(16)
    b.run(16)
    for key in ("step", "total_loss", "aux_loss", "slu_executed"):
        assert [h[key] for h in a.history] == [h[key] for h in b.history]
    assert b._chunk_fn.cond.nodes > 0
    if arch == "deepseek_moe_16b":
        assert any(h["slu_executed"][3] == 0.0 for h in a.history)
        assert all(h["aux_loss"] > 0 for h in a.history)
    for (n, x), (_, y) in zip(a.state.model.state_dict().items(),
                              b.state.model.state_dict().items()):
        assert torch.equal(x, y), n
