"""The byte models of ``launch/bench_conv.py`` and ``launch/bench_attn.py``
and their place in ``bench_run``, on the CPU.

* Every term that a PyTorch op of the path moves equals, summed, a tally
  of the same program on the CPU under a ``TorchDispatchMode`` (each op
  charged the bytes of every tensor it takes and returns; views, aliases
  and the shape-only inputs of ``new_*``/``*_like`` charged nothing), with
  the ops inside a kernel's wrapper (its plain version here) left out:
  exactly, at one small geometry of each conv kind and at small causal GQA
  shapes in bf16 and fp32.  Kernel 9's wrapper's own ops on the card
  (``operand_codes``, ``row_norms``) are tallied alone.
* Every kernel term equals an explicit loop over that kernel's launch
  grid, block by block, as the wrapper sets it up from the shapes the
  program handed it (``csrc/conv.cu``, ``psg_matmul.cu``,
  ``flash_attn.cu``).
* ``assert_complete`` raises on a missing or zero component and on a total
  that does not reconcile.
* The rows and records have the reference's names and keys
  (``benchmarks/bench_conv.py``, ``bench_attn.py``, their timing and
  training proxies stubbed), up to the stated renames and additions.
* ``bench_run``: ``--only conv,attn`` on the CPU exits 0, ``--json-conv`` and
  ``--json-attn`` write only where told and exit 1 on incomplete
  accounting.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import benchmarks.bench_attn as jattn  # noqa: E402
import benchmarks.bench_conv as jconv  # noqa: E402
from repro_torch.configs.paper_cnns import ConvShape  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.kernels import conv as K  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import psg_matmul as PM  # noqa: E402
from repro_torch.launch import bench_attn as BA  # noqa: E402
from repro_torch.launch import bench_common as BCm  # noqa: E402
from repro_torch.launch import bench_conv as BC  # noqa: E402
from repro_torch.launch import bench_run  # noqa: E402

WRAPPERS = ((K, "conv_fwd"), (K, "conv_grad_x"),
            (K, "conv_grad_w_predictor"), (K, "conv_grad_w"),
            (PM, "predictor_matmul"), (PM, "psg_grad_w"),
            (FA, "flash_fwd"), (FA, "flash_bwd_dq"), (FA, "flash_bwd_dkv"))
FREE = frozenset({"_unsafe_view", "alias"})


def _tensors(obj):
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts):
    return sum(math.prod(t.shape) * t.element_size() for t in ts)


class ByteTally(TorchDispatchMode):
    """Sums the bytes every dispatched ATen op takes and returns, outside
    the kernel wrappers (``depth``)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.depth or func.is_view or name in FREE:
            return out
        shape_only = name.startswith("new_") or name.endswith("_like")
        self.total += (0 if shape_only else _nbytes(_tensors((args, kwargs)))
                       ) + _nbytes(_tensors(out))
        return out


@pytest.fixture
def tally(monkeypatch):
    """A tally with every kernel wrapper marked, and the calls made to
    them: ``(wrapper name, args)``."""
    t = ByteTally()
    t.calls = []
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t.calls.append((_name, a))
            t.depth += 1
            try:
                return _fn(*a, **kw)
            finally:
                t.depth -= 1
        monkeypatch.setattr(mod, name, wrapped)
    return t


def _op_bytes(terms):
    return sum(x.nbytes for x in terms if x.source == "op")


def _by_source(terms):
    out = {}
    for x in terms:
        if x.source != "op":
            out[x.source] = out.get(x.source, 0) + x.nbytes
    return out


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

CONVS = {"stem": ConvShape(2, 8, 3, 16, 3, 1),
         "body": ConvShape(2, 8, 8, 8, 3, 1),
         "strided": ConvShape(2, 8, 16, 32, 3, 2),
         "down": ConvShape(2, 8, 16, 40, 1, 2),
         "point": ConvShape(2, 6, 8, 24, 1, 1),
         # two dout tiles of kernel 1, two channel tiles of kernel 2, three
         # of kernels 3-4; im2col's 128 x 128 MMA tiles of kernels 5-6
         "wide": ConvShape(2, 4, 72, 80, 3, 1),
         "wide_point": ConvShape(2, 4, 8, 136, 1, 1)}


def _run_conv(tally, shape, fused):
    x, w, gy = BC.conv_inputs(shape, torch.device("cpu"))
    with tally:
        BC.conv_step(shape, fused)(w, x, gy)
    return tally


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "im2col"])
@pytest.mark.parametrize("kind", list(CONVS))
def test_conv_op_terms_equal_the_op_tally(kind, fused, tally):
    shape = CONVS[kind]
    _run_conv(tally, shape, fused)
    terms = BC.fused_terms(shape) if fused else BC.im2col_terms(shape)
    assert tally.total == _op_bytes(terms)
    assert {n for n, _ in tally.calls} == set(_by_source(terms))


def _warp_plan(B, rows, cols, tiles_n):
    """``plan_fwd``/``plan_dx``: the byte model's plan, which the card's
    run holds against the grids and blocks it launches."""
    return BC._tile_plan(B, rows, cols, tiles_n)


def _conv_fwd_loop(xc, wc, k, s):
    """Kernel 1's two launches, block by block: ``wt_tapmajor_kernel``
    (one thread a wt byte, reading wc where inside) and
    ``conv_fwd_mma_kernel`` (each image's slab of ``rin`` rows, the weight
    tile, the y stores of its valid positions)."""
    B, Hp, Wp, C = xc.shape
    dout = wc.shape[1]
    ho = wo = (Hp - k) // s + 1
    bn = 16 if dout <= 16 else 32 if dout <= 32 else 64
    kp = -(-k * k * C // 32) * 32
    rows = -(-dout // bn) * bn
    total = rows * kp + sum(1 for o in range(rows) for q in range(kp)
                            if o < dout and q < k * k * C)
    warps, R, NI, tpi = _warp_plan(B, ho, wo, -(-dout // bn))
    rin = (R - 1) * s + k
    for tile in range(-(-B // NI) * tpi):
        for jy in range(-(-dout // bn)):
            b0, oh0 = (tile // tpi) * NI, (tile % tpi) * R
            for img in range(NI):
                if b0 + img >= B:
                    break
                total += min(rin, Hp - oh0 * s) * Wp * C
            total += bn * kp
            for m in range(16 * warps):
                img, r = m // (R * wo), (m // wo) % R
                if img < NI and b0 + img < B and oh0 + r < ho:
                    total += 4 * min(bn, dout - jy * bn)
    return total


def _conv_dx_loop(gc, wc, k, s, hp, wp):
    """Kernel 2's launches: ``wt_dx_kernel`` (every phase-weight byte,
    reading wc where a tap of the phase lies) and ``conv_dx_mma_kernel``
    (per block its g rows and halo inside the output, its weight tile,
    its dx stores)."""
    B, ho, wo, dout = gc.shape
    C = wc.shape[0] // (k * k)
    bn = 16 if C <= 16 else 32 if C <= 32 else 64
    rows = -(-C // bn) * bn
    d16 = -(-dout // 16) * 16

    def taps(p):
        return -(-(k - p) // s) if p < k else 0

    def kz(z):
        return -(-taps(z // s) * taps(z % s) * d16 // 32) * 32
    kp = kz(0)
    total = s * s * rows * kp
    for z in range(s * s):
        pi, pj = z // s, z % s
        for n in range(C):
            for ta in range(taps(pi) * taps(pj)):
                total += sum(1 for oo in range(d16) if oo < dout)
    nu = nv = -(-hp // s)
    amax = (k - 1) // s
    wg = nv + amax
    warps, R, NI, tpi = _warp_plan(B, nu, nv, -(-C // bn) * s * s)
    for tile in range(-(-B // NI) * tpi):
        for jy in range(-(-C // bn)):
            for z in range(s * s):
                b0, u0 = (tile // tpi) * NI, (tile % tpi) * R
                pi, pj = z // s, z % s
                for img in range(NI):
                    if b0 + img >= B:
                        break
                    for px in range((R + amax) * wg):
                        oh, ow = u0 - amax + px // wg, px % wg - amax
                        if 0 <= oh < ho and 0 <= ow < wo:
                            total += 2 * dout
                total += bn * kz(z)
                for m in range(16 * warps):
                    img, r, v = m // (R * nv), (m // nv) % R, m % nv
                    p, q = pi + s * (u0 + r), pj + s * v
                    if img < NI and b0 + img < B and u0 + r < nu \
                            and p < hp and q < wp:
                        total += 4 * min(bn, C - jy * bn)
    return total


def _wgrad_loop(x, g, k, s, sign_pass):
    """Kernels 3 or 4: both ``grid_kmajor_kernel`` pre-passes (each
    position's codes read where inside, every K-major byte written, the
    zeroed words), the MMA kernel's staged chunks and its int64 atomic
    adds, then the rounding (3) or the select (4)."""
    B, Hp, Wp, C = x.shape
    ho = wo = (Hp - k) // s + 1
    dout = g.shape[3]
    hq, wq, halo = -(-Hp // s), -(-Wp // s), ((k - 1) // s) * (-(-Wp // s)) \
        + (k - 1) // s
    npad = max(1, -(-B * hq * wq // K.PRED_BLOCK)) * K.PRED_BLOCK
    npx = -(-(npad + halo + 4 + 15) // K.PRED_BLOCK) * K.PRED_BLOCK
    w = k * k * C * dout
    acc = -(-8 * w // 128) * 128
    nj = -(-dout // min(128, dout))
    total = acc + (4 * k * k * nj if sign_pass else 0)
    for z in range(s * s):
        pi, pj = z // s, z % s
        for p in range(npx):
            b, r = p // (hq * wq), p % (hq * wq)
            h, ww = (r // wq) * s + pi, (r % wq) * s + pj
            if p < B * hq * wq and h < Hp and ww < Wp:
                total += C
        total += C * npx
    for p in range(npad):
        b, r = p // (hq * wq), p % (hq * wq)
        if p < B * hq * wq and r // wq < ho and r % wq < wo:
            total += 2 * dout
    total += 2 * dout * npad
    mt, np_ = (2 if C > 16 else 1), (2 if dout > 16 else 1)
    mb, nb = 16 * mt, 16 * np_
    ti, tj = -(-C // mb), -(-dout // nb)
    kts = npad // 128
    # the split of the token axis: the byte model's plan (held against
    # the card's grids on the card)
    p = BC.wgrad_plan(BC.Site(B, Hp, C, dout, k, s, Hp, ho, 0, 0))
    splits, per = p["splits"], p["per"]
    xw = -(-(128 + halo + 4) // 16) * 16
    ksplit = 1 if k * k >= 4 else 4 // (k * k)
    for bx in range(tj):
        for by in range(ti):
            for bz in range(splits):
                nk = max(0, min(kts, bz * per + per) - bz * per)
                for _ in range(nk):
                    total += sum(128 for r in range(2 * nb)
                                 if bx * nb + r % nb < dout)
                    total += sum(xw for r in range(s * s * mb)
                                 if by * mb + r % mb < C)
                for warp in range(k * k * ksplit):
                    total += 16 * min(mb, C - by * mb) * min(nb, dout - bx * nb)
    return total + (13 * w if sign_pass else 12 * w)


def _psg_loop(x, g, sign_pass):
    """Kernels 5 or 6: the two ``kmajor_kernel`` pre-passes, the MMA
    kernel's staged chunks and, where the tokens split, the zeroed int64
    sums, one atomic add per block and element, then the rounding (5) or
    the select kernel (6); else the epilogue's stores."""
    N, din = x.shape
    dout = g.shape[1]
    npad = -(-N // 128) * 128
    total = N * din + din * npad + 2 * N * dout + 2 * dout * npad
    bm, bn = (128, 128) if dout >= 128 else (128, 32)
    ti, tj = -(-din // bm), -(-dout // bn)
    kts = npad // 128
    p = BC.psg_plan(N, din, dout)      # as in _wgrad_loop
    splits, per = p["splits"], p["per"]
    for bx in range(tj):
        for by in range(ti):
            for bz in range(splits):
                nk = max(0, min(kts, bz * per + per) - bz * per)
                total += nk * 128 * (min(bm, din - by * bm)
                                     + 2 * min(bn, dout - bx * bn))
                if splits > 1:
                    total += 16 * min(bm, din - by * bm) \
                        * min(bn, dout - bx * bn)
    w = din * dout
    fb = (-(-din // min(128, din))) * (-(-dout // min(128, dout)))
    if sign_pass:
        total += 4 * fb + ((8 * w + 13 * w + 4 * fb) if splits > 1
                           else 5 * w)
    else:
        total += (8 * w + 12 * w) if splits > 1 else 4 * w
    return total


def _kernel_loop(name, args):
    if name == "conv_fwd":
        xc, _, wc, _, k, s = args
        return _conv_fwd_loop(xc, wc, k, s)
    if name == "conv_grad_x":
        gc, _, wc, _, k, s, hp, wp = args
        return _conv_dx_loop(gc, wc, k, s, hp, wp)
    if name == "conv_grad_w_predictor":
        return _wgrad_loop(args[0], args[1], args[2], args[3], False)
    if name == "conv_grad_w":
        return _wgrad_loop(args[1], args[2], args[4], args[5], True)
    if name == "predictor_matmul":
        return _psg_loop(args[0], args[1], False)
    return _psg_loop(args[1], args[2], True)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "im2col"])
@pytest.mark.parametrize("kind", list(CONVS))
def test_conv_kernel_terms_equal_a_loop_over_the_launch_grid(kind, fused,
                                                             tally):
    shape = CONVS[kind]
    _run_conv(tally, shape, fused)
    terms = BC.fused_terms(shape) if fused else BC.im2col_terms(shape)
    loops = {name: _kernel_loop(name, args) for name, args in tally.calls}
    assert len(loops) == len(tally.calls) == 4 - 2 * (not fused)
    assert loops == _by_source(terms)


def test_col2im_demoted_equals_the_reference_backends_tally():
    """``bwd_dx_col2im_demoted`` and the weight-side terms it leaves out
    are the tally of ``kernels/ref.conv_grad_x_ref`` at the same site."""
    from repro_torch.kernels import ref
    shape = CONVS["body"]
    g = BC.site_of(shape)
    gen = torch.Generator().manual_seed(0)
    gc = torch.randint(-99, 99, (g.B, g.ho, g.ho, g.dout), generator=gen,
                       dtype=torch.int16)
    wc = torch.randint(-99, 99, (g.n_w // g.dout, g.dout), generator=gen,
                       dtype=torch.int8)
    t = ByteTally()
    with t:
        ref.conv_grad_x_ref(gc, torch.tensor(0.1), wc, torch.tensor(0.2),
                            g.k, g.s, g.Hp, g.Hp)
    # the weight's cast and scaling (13 bytes an element, and the scales'
    # 8), and each tap's read of its (C, dout) slice in the product
    weights = 13 * g.n_w + 8 + 4 * g.n_w
    assert t.total == BC.col2im_demoted_bytes(shape) + weights


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTNS = {"gqa": BA.AttnShape(1, 96, 4, 2, 32),
         "batch2": BA.AttnShape(2, 80, 8, 2, 16)}
DTYPES = {"bf16": BA.BF16, "fp32": BA.FP32}


def _attn_shape(name, dt):
    return dataclasses.replace(ATTNS[name], op_bytes=DTYPES[dt])


@pytest.mark.parametrize("path", ["flash", "materialized"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(ATTNS))
def test_attn_op_terms_equal_the_op_tally(name, dt, path, tally):
    s = _attn_shape(name, dt)
    args = BA.attn_inputs(s, torch.device("cpu"))
    step = BA.attn_step(s, path)
    step(*args)                 # the first call makes the mask, as timed
    tally.calls.clear()
    with tally:
        step(*args)
    terms = BA.flash_terms(s) if path == "flash" \
        else BA.materialized_terms(s)
    assert tally.total == _op_bytes(terms)
    assert [n for n, _ in tally.calls] == \
        (["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"] if path == "flash"
         else [])



@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernel9_wrapper_ops_equal_their_tally(dt):
    """The ops kernel 9's wrapper runs on the card before its launches
    (``flash_attn.py:671-682``), tallied alone on the CPU."""
    s = _attn_shape("gqa", dt)
    q, k, v, do = BA.attn_inputs(s, torch.device("cpu"))
    c = PSGConfig()
    lims = (FA.qlim(c.bits_x), FA.qlim(c.bits_x_msb), FA.qlim(c.bits_g),
            FA.qlim(c.bits_g_msb))
    scales = torch.rand(6) + 0.1
    t = ByteTally()
    with t:
        FA.operand_codes(q, do, scales, lims)
        if dt == "bf16":
            FA.row_norms(q, do, k, v)
    assert t.total == sum(x.nbytes for x in BA.kernel9_wrapper_terms(s))


def _rows(r0, n, length):
    return max(0, min(n, length - r0))


def _flash_loops(s):
    """Kernels 7-9 block by block: ``grid((S + BQ - 1) / BQ, B nh)`` for 7
    and 8, ``(T + DK - 1) / DK * B nkv`` blocks for 9 (bf16; fp32 a grid of
    BK9-row tiles), each block's row loads and stores, kernel 9's memsets,
    pre-passes and flushes."""
    B, S, nh, nkv, hd, e = (s.batch, s.seq, s.heads, s.kv_heads,
                            s.head_dim, s.op_bytes)
    g = nh // nkv
    bf16 = e == 2
    out = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, bq, bk, kl in (("flash_fwd", 128 if bf16 else 64, 64, 2),
                             ("flash_bwd_dq", 64, 64, 2 if bf16 else 3)):
        for bx in range(-(-S // bq)):
            for by in range(B * nh):
                q0 = bx * bq
                rows = _rows(q0, bq, S)
                t_end = min(S, q0 + bq)
                n_tiles = -(-t_end // bk)
                kv = sum(_rows(t * bk, bk, S) for t in range(n_tiles))
                if name == "flash_fwd":
                    out[name] += rows * hd * e + 2 * kv * hd * e \
                        + rows * (hd * e + 4)
                else:
                    out[name] += 2 * rows * hd * e + 8 * rows \
                        + kl * kv * hd * e + 4 * rows * hd
    full, msb = BA.dkv_flush_tiles()
    tot = 4 * 8 * B * S * nkv * hd
    if bf16:
        sp = -(-S // 64) * 64
        tot += B * S * nh * hd * 6 + 6 * B * nh * hd * sp
        for blk in range(-(-S // 64) * B * nkv):
            kvb = blk // (B * nkv)
            kv0 = kvb * 64
            kv = _rows(kv0, 64, S)
            first = kv0 // 64
            n_it = g * max(0, sp // 64 - first)
            tot += kv * (2 * hd * 2 + 8)
            for it in range(n_it):
                q0 = (first + it % (n_it // g)) * 64
                tot += _rows(q0, 64, S) * (4 * hd + 16) + 6 * hd * 64
            fl = 4 + 2 * (n_it // full) + 2 * (n_it // msb)
            tot += fl * kv * hd * 16
    else:
        n_q = -(-S // 64)
        for bx in range(-(-S // 32)):
            for by in range(B * nkv):
                kv0 = bx * 32
                kv = _rows(kv0, 32, S)
                tot += 2 * kv * hd * 4
                tiles = t_full = t_msb = fl = 0
                for _ in range(g):
                    for c0 in range(kv0 // 64, n_q, msb):
                        c1 = min(n_q, c0 + msb)
                        if t_msb + c1 - c0 > msb:
                            fl, t_msb = fl + 2, 0
                        t_msb += c1 - c0
                        for iq in range(c0, c1):
                            r = _rows(iq * 64, 64, S)
                            tot += r * (2 * hd * 4 + 6 * hd + 8)
                            t_full += 1
                            if t_full == full:
                                fl, t_full = fl + 2, 0
                tot += (fl + 4) * kv * hd * 16
    out["flash_bwd_dkv"] = tot
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(ATTNS) + ["paper_lm_batch1"])
def test_attn_kernel_terms_equal_a_loop_over_the_launch_grid(name, dt):
    s = dataclasses.replace(BA.PAPER_LM, batch=1, seq=640) \
        if name == "paper_lm_batch1" else _attn_shape(name, dt)
    s = dataclasses.replace(s, op_bytes=DTYPES[dt])
    kernels = {x.source: x.nbytes for x in BA.flash_terms(s)
               if x.what.startswith("kernel ") and x.source != "op"
               and x.what[-1].isdigit()}
    assert kernels == _flash_loops(s)


# ---------------------------------------------------------------------------
# assert_complete, names and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["missing", "zero", "unreconciled"])
@pytest.mark.parametrize("mod", [BC, BA], ids=["conv", "attn"])
def test_assert_complete_raises(mod, how):
    acct = {c: 10 for c in mod.REQUIRED_COMPONENTS}
    acct["total"] = 10 * len(mod.REQUIRED_COMPONENTS)
    mod.assert_complete(dict(acct), "ok")
    first = mod.REQUIRED_COMPONENTS[0]
    if how == "missing":
        del acct[first]
        acct["total"] -= 10
    elif how == "zero":
        acct[first] = 0
        acct["total"] -= 10
    else:
        acct["total"] += 1
    with pytest.raises(mod.IncompleteAccountingError):
        mod.assert_complete(acct, "bad")


@pytest.mark.parametrize("raw,name", [
    ("void conv_fwd_mma_kernel<2>(signed char const*, float*, FwdPlan)",
     "conv_fwd_mma_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, at::native::FillFunctor<float>)",
     "vectorized_elementwise_kernel"),
    ("flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_mma_kernel")])
def test_kernel_name_strips_namespaces_and_templates(raw, name):
    assert BCm.kernel_name(raw) == name


@pytest.mark.parametrize("how", ["same", "grid", "block", "count", "absent"])
def test_check_launches_holds_grids_blocks_and_counts(how):
    L = BCm.Launch
    model = [L("a", (4, 2, 1), (256, 1, 1)), L("b", (8, 1, 1))]
    card = [L("a", (4, 2, 1), (256, 1, 1)), L("b", (8, 1, 1), (128, 1, 1)),
            L("other", (1, 1, 1), (32, 1, 1))]
    if how == "grid":
        card[1] = L("b", (9, 1, 1), (128, 1, 1))
    elif how == "block":
        card[0] = L("a", (4, 2, 1), (128, 1, 1))
    elif how == "count":
        card.append(card[0])
    elif how == "absent":
        card = card[1:]
    if how == "same":
        assert BCm.check_launches(model, card, "here") == {"a": 1, "b": 1}
    else:
        with pytest.raises(RuntimeError, match="here: the model's"):
            BCm.check_launches(model, card, "here")


def _trace(lost=(), mark=(100, 100)):
    """Chrome-trace events of a session: a lead launch before the
    ``_MEASURED`` range, then a launch on the marked thread, a memset and a
    launch on autograd's thread inside it; ``lost`` names the correlation
    ids whose device events are missing."""
    host = [(1, 50, "cudaLaunchKernel"), (2, 110, "cudaLaunchKernel"),
            (3, 120, "cudaMemsetAsync"), (4, 130, "cudaLaunchKernelExC")]
    dev = [(1, 55, 10, "kernel", "void lead_kernel<1>(float*)"),
           (2, 112, 20, "kernel", "void (anonymous namespace)::a_kernel<2>"
            "(float const*, float*)"),
           (3, 125, 5, "gpu_memset", "Memset (Device)"),
           (4, 140, 10, "kernel", "b_kernel(int)")]
    events = [{"cat": "user_annotation", "name": BCm._MEASURED,
               "ts": mark[0], "dur": mark[1]},
              {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
               "ts": 150, "args": {"correlation": 5}}]
    events += [{"cat": "cuda_runtime", "name": n, "ts": t,
                "args": {"correlation": c}} for c, t, n in host]
    events += [{"cat": cat, "name": n, "ts": t, "dur": d,
                "args": {"correlation": c, "grid": [c, 1, 1],
                         "block": [128, 1, 1]}}
               for c, t, d, cat, n in dev if c not in lost]
    return events


@pytest.mark.parametrize("how", ["whole", "lost", "lead_lost", "empty"])
def test_measured_call_takes_the_marked_range_and_finds_lost_records(how):
    """Busy ms is the union of the device intervals of the host calls in
    the range (112-132 and 140-150: 30 us); the lead call's launch is
    outside it, so its loss is no loss; a launching host call in the range
    without its device event is named."""
    events = _trace(lost={"lost": {3}, "lead_lost": {1}}.get(how, ()),
                    mark=(100, 1) if how == "empty" else (100, 100))
    busy, launches, lost = BCm.measured_call(events)
    if how == "empty":
        assert (busy, launches) == (0.0, [])
        assert lost == ["(no launching host call in the measured range)"]
    elif how == "lost":
        assert lost == ["cudaMemsetAsync"]
    else:
        assert lost == []
        assert busy == pytest.approx(0.030)
        assert launches == [BCm.Launch("a_kernel", (2, 1, 1), (128, 1, 1)),
                            BCm.Launch("b_kernel", (4, 1, 1), (128, 1, 1))]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "im2col"])
def test_conv_launch_models_are_the_planned_grids(fused):
    """Each modelled grid is the plan that the kernel terms count: its
    blocks times their bytes give the staging terms (kernels 1-2), its
    split count the wgrad and PSG plans'; one launch of each kernel a
    step at each of the 8 ResNet-74 geometries."""
    from repro_torch.configs.paper_cnns import resnet_conv_shapes
    shapes = resnet_conv_shapes(depth=74, width=16, batch=128)
    assert len(shapes) == 8
    for c in shapes:
        g = BC.site_of(c)
        got = {x.name: x for x in (BC.fused_launches(c) if fused
                                   else BC.im2col_launches(c))}
        if fused:
            f, d, w = BC.fwd_plan(g), BC.dx_plan(g), BC.wgrad_plan(g)
            assert got["conv_fwd_mma_kernel"].grid == (f["tiles"], f["n_j"],
                                                        1)
            assert got["conv_dx_mma_kernel"].grid == (d["tiles"], d["n_c"],
                                                      g.s * g.s)
            x = sum(BC.fwd_tile_x_bytes(g, f, t)
                    for t in range(got["conv_fwd_mma_kernel"].grid[0]))
            assert f["n_j"] * x == next(
                t.nbytes for t in BC.kernel1_terms(g)
                if t.what == "kernel 1 x codes")
            for n in ("conv_pred_mma_kernel", "conv_sign_mma_kernel"):
                assert got[n].grid == (w["tj"], w["ti"], w["splits"])
        else:
            p = BC.psg_plan(g.B * g.ho * g.ho, g.k * g.k * g.C, g.dout)
            for n in ("pred_mma_kernel", "sign_mma_kernel"):
                assert got[n].grid == (p["tj"], p["ti"], p["splits"])
                assert got[n].block is None


@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_launch_model_is_the_byte_models_tiling(dt):
    s = dataclasses.replace(BA.PAPER_LM, batch=2, op_bytes=DTYPES[dt])
    grids = {x.name.replace("_mma", ""): x.grid
             for x in BA.flash_launches(s)}
    bq = BA.FQ if DTYPES[dt] == 2 else BA.BQ
    assert grids == {
        "flash_fwd_kernel": (-(-s.seq // bq), 2 * s.heads, 1),
        "flash_bwd_dq_kernel": (-(-s.seq // (BA.DQ8 if DTYPES[dt] == 2
                                             else BA.BQ)), 2 * s.heads, 1),
        "flash_bwd_dkv_kernel": (-(-s.seq // BA.DK) * 2 * s.kv_heads, 1, 1)
        if DTYPES[dt] == 2 else (-(-s.seq // BA.BK9), 2 * s.kv_heads, 1)}


def _keys(obj):
    """Nested key structure: dicts by key, lists by their first item."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(obj[0])]
    return None


RENAMES = {"us_im2col_cpu_interpret": "us_im2col",
           "us_fused_cpu_interpret": "us_fused",
           "us_materialized_cpu_interpret": "us_materialized",
           "us_flash_cpu_interpret": "us_flash",
           "train_proxy_cpu_interpret": "train_proxy",
           "speedup_cpu_interpret": "speedup"}
# the keys the port adds: the card, its device times, the bytes it leaves
# out of the totals, the operand dtype of a shape row, the launches held
# against the card's and the profiles thrown away first
ADDED = {"profiles_discarded", "device", "unique_geometries", "device_ms_per_step", "time_ratio",
         "device_busy_ms_per_step", "device_busy_ms", "busy_ratio",
         "implied_tb_s_busy",
         "implied_tb_s", "excluded_weights", "excluded_fwd_out",
         "excluded_scalars", "device_ms_batch", "device_ms",
         "layer_bytes_at_timed_batch", "operand_dtype", "launches_held"}


def _renamed(tree):
    if isinstance(tree, dict):
        return {RENAMES.get(k, k): _renamed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_renamed(v) for v in tree]
    return tree


def _without_added(tree, ref):
    """``tree`` without the ``ADDED`` keys that ``ref``, the reference's
    structure at the same place, does not have."""
    if isinstance(tree, dict) and isinstance(ref, dict):
        return {k: _without_added(v, ref.get(k)) for k, v in tree.items()
                if k in ref or k not in ADDED}
    if isinstance(tree, list) and isinstance(ref, list) and ref:
        return [_without_added(v, ref[0]) for v in tree]
    return tree


class _StubTrainer:
    executed_steps = 2

    def __init__(self, *a, **kw):
        pass

    def run(self, steps, *a, **kw):
        return [{"loss": 1.0}] * steps

    def measured_psg_fallback(self):
        return 0.5

    def energy_report(self, steps=None):
        return type("R", (), {"computational_savings_measured": 0.5})()


@pytest.fixture
def reference_stubbed(monkeypatch):
    """The reference's benches with their interpreter timing and training
    proxies stubbed: nothing of the Pallas interpreter runs."""
    import benchmarks.common as jcommon
    import repro.training.train_step as jts
    import repro.training.trainer as jtr
    monkeypatch.setattr(jcommon, "time_us", lambda fn, *a, **kw: (1.0, None))
    monkeypatch.setattr(jtr, "Trainer", _StubTrainer)
    monkeypatch.setattr(jts, "init_train_state", lambda *a, **kw: None)
    monkeypatch.setattr(jcommon, "run_lm", lambda *a, **kw: (
        [{"loss": 1.0}] * 3, _StubTrainer(), 1.0))


def _names_and_keys(rows):
    out = []
    for row in rows:
        name, us, derived = row.split(",", 2)
        float(us)
        out.append((name, [kv.split("=", 1)[0] for kv in derived.split(";")]))
    return out


@pytest.mark.parametrize("which", ["conv", "attn"])
def test_rows_and_records_have_the_references_names_and_keys(
        which, reference_stubbed, monkeypatch):
    ref, port = (jconv, BC) if which == "conv" else (jattn, BA)
    make = "conv_json" if which == "conv" else "attn_json"
    monkeypatch.setattr(port, "_train_proxy", lambda fast, dev: _renamed(
        _keys(ref._train_proxy(fast))))
    want = _renamed(_keys(getattr(ref, make)(fast=True)))
    got = _keys(getattr(port, make)(True, "cpu"))
    assert _without_added(got, want) == want
    rows = list(port.run(True, "cpu"))
    assert _names_and_keys(rows) == _names_and_keys(list(ref.run(fast=True)))


def test_port_proxies_have_the_references_keys(reference_stubbed):
    """The port's own training proxies (run here, a few CPU steps each)
    give the reference's keys, renamed, and the card's label."""
    for ref, port in ((jconv, BC), (jattn, BA)):
        want = _renamed(_keys(ref._train_proxy(True)))
        got = _keys(port._train_proxy(True, "cpu"))
        assert got == {**want, "device": None}


def test_paper_acceptance_quantities():
    """``bytes_ratio`` of ``paper_lm_s4096`` is at least the reference's
    gate of 3; the conv totals reconcile over the 75 sites; nothing is
    timed off the card."""
    attn = BA._paper_totals()
    assert attn["bytes_ratio"] >= 3
    assert attn["device_ms"] == {"materialized": None, "flash": None}
    conv = BC._paper_totals()
    assert conv["conv_sites"] == 75 and conv["unique_geometries"] == 8
    assert conv["backward_bytes_ratio"] > 1
    assert conv["device_ms_per_step"] == {"im2col": None, "fused": None}


# ---------------------------------------------------------------------------
# bench_run
# ---------------------------------------------------------------------------


def test_bench_run_runs_conv_and_attn_on_the_cpu(capsys):
    assert bench_run.main(["--only", "conv,attn", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in rows[1:]] == [
        "conv/paper_resnet74_batch128", "conv/body/2x32x3-16k3s1",
        "conv/strided/2x32x16-32k3s2", "conv/down/2x32x16-32k1s2",
        "attn/paper_lm_s4096", "attn/gqa_small/1x128x4-2h32"]


def _fast_records(monkeypatch):
    for mod in (BC, BA):
        monkeypatch.setattr(mod, "_train_proxy",
                            lambda fast, dev: {"steps": 1})


def test_bench_run_writes_conv_and_attn_records_only_where_told(
        tmp_path, monkeypatch):
    _fast_records(monkeypatch)
    repo = {p: (ROOT / p).stat().st_mtime_ns
            for p in ("BENCH_conv.json", "BENCH_attn.json")}
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    assert bench_run.main(["--json-conv", str(out / "C.json"),
                           "--json-attn", str(out / "A.json"),
                           "--device", "cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert sorted(p.name for p in out.iterdir()) == ["A.json", "C.json"]
    conv = json.loads((out / "C.json").read_text())
    attn = json.loads((out / "A.json").read_text())
    assert conv["device"] == attn["device"] == "cpu"
    BC.assert_complete(conv["paper_resnet74_batch128"]["fused_bytes_per_step"],
                       "fused")
    BA.assert_complete(attn["paper_lm_s4096"]["flash_bytes_per_step"], "flash")
    assert {p: (ROOT / p).stat().st_mtime_ns for p in repo} == repo
    with pytest.raises(SystemExit):            # no default path
        bench_run.main(["--json-conv", "--device", "cpu"])


@pytest.mark.parametrize("which", ["conv", "attn"])
def test_bench_run_exits_1_on_incomplete_accounting(which, tmp_path,
                                                 monkeypatch, capsys):
    _fast_records(monkeypatch)
    if which == "conv":
        monkeypatch.setattr(BC, "fused_bytes", lambda shape: {
            **BC.summarize(BC.fused_terms(shape)), "bwd_dx": 0})
    else:
        monkeypatch.setattr(BA, "flash_bytes", lambda s: {
            k: v for k, v in BA.summarize(BA.flash_terms(s)).items()
            if k != "bwd"})
    path = tmp_path / "R.json"
    assert bench_run.main([f"--json-{which}", str(path), "--device",
                           "cpu"]) == 1
    assert not path.exists()
    assert "byte accounting incomplete" in capsys.readouterr().err
