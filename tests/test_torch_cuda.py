"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips elsewhere;
the card is looked for inside a fixture, never at import time.  Run them
on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels 3-6 must equal their exact plain versions; kernels 1 and 2 sum in
fp32 in another order, within ``1e-5 * max|ref|``.
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
