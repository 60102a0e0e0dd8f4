"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips elsewhere;
the card is looked for inside a fixture, never at import time.  Run them
on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports JAX.)  Kernels 3-6
and 10 must equal their exact plain versions; kernels 1, 2 and 8 sum in fp32 in
another order, within ``1e-5 * max|ref|``; kernel 7's output is within one
bf16 ulp (fp32: ``1e-5 * max|ref|``) and its lse within 1e-5; kernel 9's
code products equal the plain version's on integer inputs and elsewhere
differ only where a P or dS code flips at a rounding boundary.
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
    xq, wq, gq = quantize(x, 8), quantize(w, 8), quantize(gy, 16)
    _close(K.conv_fwd(xq, wq, k, st), K.conv_fwd_plain(xq, wq, k, st))
    _close(K.conv_grad_x(gq, wq, k, st, hp, hp),
           K.conv_grad_x_plain(gq, wq, k, st, hp, hp))


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
    x = torch.randn(1, 4, 4, 2, device=card, dtype=torch.float64)
    with pytest.raises(ValueError):
        K.conv_fwd(x, torch.randn(18, 3, device=card, dtype=torch.float64), 3, 1)
    with pytest.raises(ValueError):
        K.conv_fwd(torch.randn(1, 4, 4, 2, device=card),
                   torch.randn(18, 3), 3, 1)


# (N, din, dout) of the PSG matmul kernels: tiles smaller than 128, a padded
# 200 x 328 grid with N not a multiple of the 32-token stage, and two
# qwen2.5-3b projections at a short sequence
MATMULS = [(64, 32, 48), (1000, 200, 328), (2048, 2048, 256),
           (1024, 11008, 128)]


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
# padded past two 64-row tiles, GQA at the qwen2.5-3b head dim, non-causal
FLASH = [(2, 40, 4, 2, 16, True), (2, 300, 8, 8, 32, True),
         (1, 256, 4, 2, 128, True), (1, 200, 4, 4, 64, False)]
FLASH_IDS = ["hd16", "mha_padded", "gqa_hd128", "noncausal"]


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
@pytest.mark.parametrize("shape", FLASH[:3], ids=FLASH_IDS[:3])
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
