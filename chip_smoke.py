#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. report the card (name, power limit) and build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once);
   refuse to run under any ``REPRO_TORCH_KERNEL_BACKEND`` pin (``plain``
   and ``reference`` would hide the kernels, ``cuda`` fail the CPU halves
   of phase 5);
2. run each of the four conv kernels at every ResNet-74 batch-128 conv
   geometry the training path gives it, hold it against its plain PyTorch
   version (kernels 3 and 4 bit for bit; kernels 1 and 2 within
   ``FP32_REL`` of the reference's largest magnitude) and time it with CUDA
   events next to the plain version, a PyTorch library call and its bound;
3. the same for the two PSG matmul kernels (bit for bit, signs and flags
   included) at every qwen2.5-3b weight-matmul geometry with N = 8192
   tokens, plus a padded one;
4. the same for the three flash-attention kernels at the qwen2.5-3b
   attention geometry (batch 2, 4096 tokens, 16 heads over 2 kv heads, hd
   128, bf16, causal), a padded one and a non-causal one (limits in
   ``check_flash_kernels``), plus kernel 9 bit for bit on integer inputs;
   kernel 7 is timed beside ``scaled_dot_product_attention``; then one
   qwen2.5-3b attention sub-block forward and backward, materialized softmax
   against flash kernels, timed in turns with its peak memory;
4c. the same for the quantize kernel (bit for bit) at the input of its main
   path, the kernel microbenchmark's x (2048 x 1024 fp32, 8 bits), the one
   its times in the ``kernels`` line are of; also at the qwen2.5-3b
   weight-matmul operands (N = 8192), a ResNet-74 batch-128 activation and
   the JAX package's test shapes at 2 to 16 bits; timed beside
   ``fake_quantize_per_tensor_affine``;
4d. the dispatch layer: ``dispatch.psg_grad_w`` at the ResNet-74 im2col
   geometries of the kernel microbenchmark under the ``cuda``, ``plain``
   and ``reference`` backends (kernels launched under ``cuda`` alone; equal
   signs and tile ratios under ``cuda`` and ``plain``; the element-level
   ratio of ``reference`` beside them);
4e. the kernel microbenchmark CLI (``repro_torch.launch.bench_kernels``) in
   full mode, with every launch counter zeroed just before and read just
   after: the main path of the quantize kernel;
5. train one step of a small ResNet on the card and on the CPU from the same
   parameters and batch, and compare, through the fused convs, the im2col
   convs and with PSG off; the same for the reduced qwen2.5-3b, with the
   materialized softmax and with the flash kernels;
6. train ResNet-74 (width 16, batch 128, synthetic CIFAR) with SMD, SLU and
   PSG through ``repro_torch.launch.train``'s trainer until at least three
   steps have executed, with every kernel's launch counter zeroed just
   before and read just after, print the energy report and profile one more
   executed step (device time by kernel, idle share); then the same with
   the im2col convs (``fused_conv=False``: the PSG matmul kernels and no
   conv kernel) and with PSG off (``--e2train off``: no kernel at all);
7. the same for qwen2.5-3b at full width, 8 of its 36 layers, batch 2 x
   sequence 4096 (``build_lm_trainer``), once through the materialized
   softmax and once through the flash kernels (``fused_attention=True``).

The second line from the end is a JSON object ``{"kernels": [...]}``, the
line before it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a card, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv.cu"
PSG_SOURCE = "src/repro_torch/kernels/csrc/psg_matmul.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attn.cu"
QUANT_SOURCE = "src/repro_torch/kernels/csrc/quant.cu"
REPLACES = {   # the wrapper in the JAX package that reaches pl.pallas_call
    "conv_fwd": "src/repro/kernels/conv.py:245",
    "conv_grad_x": "src/repro/kernels/conv.py:274",
    "conv_grad_w_predictor": "src/repro/kernels/conv.py:308",
    "conv_grad_w": "src/repro/kernels/conv.py:337",
    "predictor_matmul": "src/repro/kernels/psg_matmul.py:162",
    "psg_grad_w": "src/repro/kernels/psg_matmul.py:110",
    "flash_fwd": "src/repro/kernels/flash_attn.py:234",
    "flash_bwd_dq": "src/repro/kernels/flash_attn.py:344",
    "flash_bwd_dkv": "src/repro/kernels/flash_attn.py:464",
    "quantize": "src/repro/kernels/quant.py:32",
}
SOURCES = {n: CONV_SOURCE for n in list(REPLACES)[:4]}
SOURCES.update(predictor_matmul=PSG_SOURCE, psg_grad_w=PSG_SOURCE)
SOURCES.update({n: FLASH_SOURCE for n in list(REPLACES)[6:9]})
SOURCES.update(quantize=QUANT_SOURCE)
# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bf16 tensor cores (products of bf16 inputs)
INT8_OPS_PER_S = 1979e12        # the fastest integer rate of the card
# kernels 1 and 2 sum in fp32 in another order than the plain tap loop; the
# reductions are at most 576 terms (9 taps x 64 channels), whose rounding
# stays within a few 1e-7 of the largest magnitude
FP32_REL = 1e-5
DEPTH, WIDTH, BATCH = 74, 16, 128
LM_ARCH, LM_LAYERS, LM_BATCH, LM_SEQ = "qwen2_5_3b", 8, 2, 4096


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean time of ``fn`` on the card, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def site(s):
    """(B, Hp, C, dout, k, stride, Ho) of a conv as the PSG conv runs it:
    SAME-padded, with ``k < stride`` pre-subsampled to stride 1."""
    hw, k, stride = s.hw, s.k, s.stride
    if k < stride:
        hw, stride = -(-hw // stride), 1
    hp = hw + 2 * (k // 2)
    return s.batch, hp, s.cin, s.cout, k, stride, (hp - k) // stride + 1


def check_kernels(torch, K, shapes_all, shapes):
    """Phase 2: every kernel against its plain version, with times."""
    import torch.nn.functional as F
    from repro_torch.core.quant import codes, quantize

    mult = {s: shapes_all.count(s) for s in shapes}
    tot = {n: _zero_total() for n in list(REPLACES)[:4]}
    details = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in shapes:
        B, hp, C, dout, k, st, ho = site(s)
        p = k // 2
        x = torch.zeros(B, hp, hp, C, device="cuda")
        x[:, p:hp - p, p:hp - p] = torch.randn(B, hp - 2 * p, hp - 2 * p, C,
                                               device="cuda", generator=g)
        w = torch.randn(k * k * C, dout, device="cuda", generator=g) * 0.1
        gy = torch.randn(B, ho, ho, dout, device="cuda", generator=g) * 0.01
        xq, wq, gq = quantize(x, 8), quantize(w, 8), quantize(gy, 16)
        xm, _ = codes(x, 4)
        gm, _ = codes(gy, 10)
        xc, _ = codes(x, 8)
        gc, _ = codes(gy, 16)
        w_oihw = wq.reshape(C, k, k, dout).permute(3, 0, 1, 2).contiguous()
        x_nchw = xq.permute(0, 3, 1, 2)          # channels-last views
        g_nchw = gq.permute(0, 3, 1, 2)
        xm_f = xm.float().permute(0, 3, 1, 2)
        gm_f = gm.float().permute(0, 3, 1, 2)
        n_pos, rows = B * ho * ho, k * k * C
        macs = n_pos * rows * dout
        row = {"geometry": [B, hp, C, dout, k, st], "kind": s.kind,
               "sites_per_step": mult[s]}

        # kernel 1: forward
        y = K.conv_fwd(xq, wq, k, st)
        ref = K.conv_fwd_plain(xq, wq, k, st)
        err = float((y - ref).abs().max())
        if not err <= FP32_REL * float(ref.abs().max()):
            fail(f"conv_fwd at {row['geometry']}: max abs err {err}")
        cases = [("conv_fwd", err,
                  lambda: K.conv_fwd(xq, wq, k, st),
                  lambda: K.conv_fwd_plain(xq, wq, k, st),
                  lambda: F.conv2d(x_nchw, w_oihw, stride=st),
                  4 * (xq.numel() + wq.numel() + y.numel()), 2 * macs,
                  FP32_OPS_PER_S, mult[s])]

        # kernel 2: input gradient (the stem's image needs none)
        dx = K.conv_grad_x(gq, wq, k, st, hp, hp)
        ref = K.conv_grad_x_plain(gq, wq, k, st, hp, hp)
        err = float((dx - ref).abs().max())
        if not err <= FP32_REL * float(ref.abs().max()):
            fail(f"conv_grad_x at {row['geometry']}: max abs err {err}")
        cases.append(("conv_grad_x", err,
                      lambda: K.conv_grad_x(gq, wq, k, st, hp, hp),
                      lambda: K.conv_grad_x_plain(gq, wq, k, st, hp, hp),
                      lambda: torch.nn.grad.conv2d_input(
                          (B, C, hp, hp), w_oihw, g_nchw, stride=st),
                      4 * (gq.numel() + wq.numel() + dx.numel()), 2 * macs,
                      FP32_OPS_PER_S, 0 if C == 3 else mult[s]))

        # kernel 3: PSG predictor product, exact
        pred = K.conv_grad_w_predictor(xm, gm, k, st)
        if not torch.equal(pred, K.conv_grad_w_predictor_plain(xm, gm, k, st)):
            fail(f"conv_grad_w_predictor at {row['geometry']}: not identical")
        cases.append(("conv_grad_w_predictor", 0.0,
                      lambda: K.conv_grad_w_predictor(xm, gm, k, st),
                      lambda: K.conv_grad_w_predictor_plain(xm, gm, k, st),
                      lambda: torch.nn.grad.conv2d_weight(
                          xm_f, (dout, C, k, k), gm_f, stride=st),
                      xm.numel() + 2 * gm.numel() + 4 * pred.numel(),
                      2 * macs, INT8_OPS_PER_S, mult[s]))

        # kernel 4: PSG select, exact
        tau = 0.05 * pred.float().abs().amax()
        sign, stats = K.conv_grad_w(pred, xc, gc, tau, k, st)
        psign, pstats = K.conv_grad_w_plain(pred, xc, gc, tau, k, st)
        if not (torch.equal(sign, psign) and torch.equal(stats, pstats)):
            fail(f"conv_grad_w at {row['geometry']}: not identical")
        row["fallback_flags"] = float(stats.float().mean())
        cases.append(("conv_grad_w", 0.0,
                      lambda: K.conv_grad_w(pred, xc, gc, tau, k, st),
                      lambda: K.conv_grad_w_plain(pred, xc, gc, tau, k, st),
                      None,
                      4 * pred.numel() + xc.numel() + 2 * gc.numel() + 4
                      + sign.numel() + 4 * stats.numel(),
                      2 * macs, INT8_OPS_PER_S, mult[s]))

        time_cases(torch, cases, row, tot)
        details.append(row)
        torch.cuda.synchronize()
    return tot, details


def _zero_total():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops_s=0.0,
                max_abs_err=0.0)


def time_cases(torch, cases, row, tot):
    """Time each (kernel, plain, library) triple and add it, weighted by
    its sites per step, to the kernel's totals."""
    for name, err, kern, plain, lib, nbytes, ops, peak, m in cases:
        r = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
             "library_ms": time_ms(torch, lib) if lib else None,
             "bytes": nbytes, "ops": ops, "max_abs_err": err,
             "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)}
        row[name] = r
        t = tot[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        for key in ("ms", "plain_ms", "bytes"):
            t[key] += m * r[key]
        if lib is None:
            t["library_ms"] = None
        else:
            t["library_ms"] += m * r["library_ms"]
        t["ops_s"] += m * ops / peak


def lm_matmul_sites(d, heads, kv_heads, head_dim, d_ff, layers):
    """{(din, dout): PSG weight-matmul sites per step} of a dense qwen-style
    stack: q and o (d x d), k and v (d x kv), up and gate (d x d_ff),
    down (d_ff x d), per layer."""
    kv = kv_heads * head_dim
    sites = {}
    for geo in [(d, heads * head_dim), (heads * head_dim, d), (d, kv),
                (d, kv), (d, d_ff), (d, d_ff), (d_ff, d)]:
        sites[geo] = sites.get(geo, 0) + layers
    return sites


def check_psg_matmul_kernels(torch, PM, sites, padded, n_tokens):
    """Phase 3: kernels 5 and 6 against their plain versions at each weight
    matmul geometry, timed; the padded geometry is checked, not counted."""
    from repro_torch.core.quant import codes

    tot = {n: _zero_total() for n in ("predictor_matmul", "psg_grad_w")}
    details = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for (din, dout), m in list(sites.items()) + [(padded, 0)]:
        x = torch.randn(n_tokens, din, device="cuda", generator=g)
        gy = torch.randn(n_tokens, dout, device="cuda", generator=g) * 0.01
        xm, gm = codes(x, 4)[0], codes(gy, 10)[0]
        xq, gq = codes(x, 8)[0], codes(gy, 16)[0]
        del x, gy
        row = {"geometry": [n_tokens, din, dout], "sites_per_step": m}
        pred = PM.predictor_matmul(xm, gm)
        if not torch.equal(pred, PM.predictor_matmul_plain(xm, gm)):
            fail(f"predictor_matmul at {row['geometry']}: not identical")
        tau = 0.05 * pred.float().abs().amax()
        sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
        psign, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
        if not (torch.equal(sign, psign) and torch.equal(stats, pstats)):
            fail(f"psg_grad_w at {row['geometry']}: not identical")
        row["fallback_flags"] = float(stats.float().mean())
        ops = 2 * n_tokens * din * dout
        xm_f, gm_f = xm.float(), gm.float()
        cases = [
            ("predictor_matmul", 0.0,
             lambda: PM.predictor_matmul(xm, gm),
             lambda: PM.predictor_matmul_plain(xm, gm),
             lambda: torch.matmul(xm_f.T, gm_f),
             xm.numel() + 2 * gm.numel() + 4 * pred.numel(), ops,
             INT8_OPS_PER_S, m),
            ("psg_grad_w", 0.0,
             lambda: PM.psg_grad_w(pred, xq, gq, tau),
             lambda: PM.psg_grad_w_plain(pred, xq, gq, tau),
             None,
             4 * pred.numel() + xq.numel() + 2 * gq.numel() + 4
             + sign.numel() + 4 * stats.numel(), ops, INT8_OPS_PER_S, m)]
        time_cases(torch, cases, row, tot)
        details.append(row)
        del xm_f, gm_f
        torch.cuda.synchronize()
    return tot, details


# kernel 9's code products: a P or dS code flips where the kernel's q k^T
# sums in another order than the plain matmul, moving one product element by
# one code of the other operand; at most this share of elements may differ,
# by at most this share of the largest magnitude (tests/test_torch_cuda.py)
DKV_MISMATCH, DKV_REL = 1e-3, 1e-3


def bf16_one_ulp(torch, a, ref) -> bool:
    """Within one bf16 ulp of the larger magnitude, plus 1e-6 * max|ref| for
    the fp32 difference before both were rounded to bf16."""
    a, ref = a.double(), ref.double()
    big = torch.maximum(a.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((a - ref).abs() <= ulp + 1e-6 * ref.abs().max()).all())


def flash_geometries(m):
    """(name, B, S, nh, nkv, hd, dtype, causal, sites per step of kernels
    7, 8, 9): the qwen2.5-3b attention of the flash main path (kernel 7 runs
    twice per layer under remat="block"), then a padded MHA geometry and a
    non-causal one, checked and not counted."""
    return [("qwen", LM_BATCH, LM_SEQ, m.num_heads, m.num_kv_heads,
             m.resolved_head_dim, "bfloat16", True,
             (2 * LM_LAYERS, LM_LAYERS, LM_LAYERS)),
            ("padded", 2, 300, 8, 8, 32, "float32", True, (0, 0, 0)),
            ("noncausal", 1, 1024, 8, 2, 64, "bfloat16", False, (0, 0, 0))]


def check_flash_kernels(torch, FA, geometries):
    """Phase 4: kernels 7-9 against their plain versions, with times; kernel
    9 also bit for bit on small integer inputs."""
    import torch.nn.functional as F

    tot = {n: _zero_total() for n in FA.LAUNCHES}
    details = []
    lims = (127.0, 7.0, 32767.0, 511.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, B, S, nh, nkv, hd, dt, causal, sites in geometries:
        dtype = getattr(torch, dt)
        q = torch.randn(B, S, nh, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, S, nkv, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, S, nkv, hd, device="cuda", generator=gen).to(dtype)
        do = (torch.randn(B, S, nh, hd, device="cuda", generator=gen)
              * 0.1).to(dtype)
        row = {"geometry": [B, S, nh, nkv, hd, dt, causal], "name": name,
               "sites_per_step": dict(zip(FA.LAUNCHES, sites))}

        # kernel 7: o within one bf16 ulp (fp32: 1e-5 of max|o|), lse 1e-5
        o, lse = FA.flash_fwd(q, k, v, causal=causal)
        o_p, lse_p = FA.flash_attention_plain(q, k, v, causal=causal)
        err_o = float((o.float() - o_p.float()).abs().max())
        err_l = float((lse - lse_p).abs().max())
        ok = bf16_one_ulp(torch, o.float(), o_p.float()) if dt == "bfloat16" \
            else err_o <= FP32_REL * float(o_p.float().abs().max())
        if not (ok and err_l <= 1e-5):
            fail(f"flash_fwd at {name}: o err {err_o}, lse err {err_l}")
        row["flash_fwd_lse_err"] = err_l

        # kernel 8: dq within 1e-5 of max|dq|, on the plain version's lse
        delta = torch.einsum("bsnh,bsnh->bns", do.float(),
                             o_p.float()).contiguous()
        dq = FA.flash_bwd_dq(q, k, v, do, lse_p, delta, causal=causal)
        dq_p = FA.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal=causal)
        err_dq = float((dq - dq_p).abs().max())
        if not err_dq <= FP32_REL * float(dq_p.abs().max()):
            fail(f"flash_bwd_dq at {name}: max abs err {err_dq}")

        # kernel 9: the four code products
        scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8,
                                         bits_x_msb=4, bits_g=16,
                                         bits_g_msb=10)
        got = FA.flash_bwd_dkv(q, k, v, do, lse_p, delta, scales, lims=lims,
                               causal=causal)
        want = FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                      lims=lims, causal=causal)
        err_kv, stats = 0.0, []
        for pname, g_, w_ in zip(("dv_msb", "dv_full", "dk_msb", "dk_full"),
                                 got, want):
            diff = (g_ - w_).abs().double()
            share, top = float((diff > 0).double().mean()), float(diff.max())
            ref_max = float(w_.abs().max())
            stats.append({"product": pname, "mismatch_share": share,
                          "max_abs_err": top, "max_abs_ref": ref_max})
            if share > DKV_MISMATCH or top > DKV_REL * ref_max:
                fail(f"flash_bwd_dkv {pname} at {name}: {share} of elements "
                     f"differ, by up to {top} (max |ref| {ref_max})")
            err_kv = max(err_kv, top)
        row["flash_bwd_dkv_products"] = stats
        del got, want

        pairs = B * nh * (S * (S + 1) // 2 if causal else S * S)
        mm = BF16_OPS_PER_S if dt == "bfloat16" else FP32_OPS_PER_S
        prod = 2 * hd * pairs           # operations of one product over pairs
        e = q.element_size()
        qkv = e * (q.numel() + k.numel() + v.numel())
        rows = 4 * lse.numel()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def rate(*parts):
            ops = sum(n for n, _ in parts)
            return ops, ops / sum(n / r for n, r in parts)

        cases = [
            ("flash_fwd", err_o,
             lambda: FA.flash_fwd(q, k, v, causal=causal),
             lambda: FA.flash_attention_plain(q, k, v, causal=causal),
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True),
             qkv + e * o.numel() + rows,
             *rate((prod, mm), (prod, FP32_OPS_PER_S)), sites[0]),
            ("flash_bwd_dq", err_dq,
             lambda: FA.flash_bwd_dq(q, k, v, do, lse_p, delta,
                                     causal=causal),
             lambda: FA.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                           causal=causal),
             None, qkv + e * do.numel() + 2 * rows + 4 * dq.numel(),
             *rate((2 * prod, mm), (prod, FP32_OPS_PER_S)), sites[1]),
            ("flash_bwd_dkv", err_kv,
             lambda: FA.flash_bwd_dkv(q, k, v, do, lse_p, delta, scales,
                                      lims=lims, causal=causal),
             lambda: FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                            lims=lims, causal=causal),
             None, qkv + e * do.numel() + 2 * rows + 24 + 24 * k.numel(),
             *rate((2 * prod, mm), (4 * prod, INT8_OPS_PER_S)), sites[2])]
        time_cases(torch, cases, row, tot)
        details.append(row)
        del q, k, v, do, o, o_p, dq, dq_p, qt, kt, vt, cases
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # small integer q, k, v and dO: every score and dP is exact in any
    # summation order, so kernel 9's codes and products must be identical
    for dt in ("float32", "bfloat16"):
        q, k, v, do = (torch.randint(-2, 3, shape, device="cuda",
                                     generator=gen).to(getattr(torch, dt))
                       for shape in ((1, 256, 4, 128), (1, 256, 2, 128),
                                     (1, 256, 2, 128), (1, 256, 4, 128)))
        o, lse = FA.flash_attention_plain(q, k, v)
        delta = torch.einsum("bsnh,bsnh->bns", do.float(),
                             o.float()).contiguous()
        scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8,
                                         bits_x_msb=4, bits_g=16,
                                         bits_g_msb=10)
        got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims)
        want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales,
                                      lims=lims)
        if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
            fail(f"flash_bwd_dkv on integer {dt} inputs: not identical")
        details.append({"name": f"integer_{dt}", "flash_bwd_dkv": "identical",
                        "nonzero_products": [int((w_ != 0).sum())
                                             for w_ in want]})
    return tot, details


def attention_ab(torch, m):
    """Phase 4b: one qwen2.5-3b attention sub-block (q/k/v projections, rope,
    attention, output projection) forward and backward at batch 2 x 4096
    under PSG, through the materialized softmax and through the flash
    kernels, timed in turns (materialized, flash, flash, materialized) by
    CUDA events, with the peak memory each allocates above what it starts
    from."""
    from repro_torch.core import psg
    from repro_torch.core.config import PSGConfig
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(3)
    attn = L.Attention(m, gen)
    x = torch.randn(LM_BATCH, LM_SEQ, m.d_model, device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_(True)
    gy = (torch.randn(LM_BATCH, LM_SEQ, m.d_model, device="cuda",
                      generator=gen) * 0.01).to(torch.bfloat16)

    def step(fused):
        cfg = PSGConfig(enabled=True, fused_attention=fused)
        with psg.enable(cfg, psg.zero_probe("cuda")):
            y = L.attention_fwd(attn, x, m)
        y.backward(gy)

    out = {"materialized": {"ms": [], "peak_gb": []},
           "flash": {"ms": [], "peak_gb": []}}
    for fused in (False, True, True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r = out["flash" if fused else "materialized"]
        r["ms"].append(time_ms(torch, lambda: step(fused), reps=3))
        r["peak_gb"].append((torch.cuda.max_memory_allocated() - base) / 1e9)
    del attn, x, gy
    torch.cuda.empty_cache()
    return out


def quant_geometries(m):
    """(name, shape, dtype, bits, calls counted).  Counted: the input the
    kernel microbenchmark quantizes, kernel 10's main path (``bench_x``, x
    of ``bench_kernels.psg_operands`` in full mode, fp32 at 8 bits).
    Checked and timed, not counted: the qwen2.5-3b weight-matmul operands
    at N = 8192 (x, w and gy of the d_ff matmuls) and a ResNet-74 batch-128
    activation, which the training paths quantize in PyTorch
    (``core/quant``); checked only: the JAX package's test shapes at 2-16
    bits and inputs that are not 16-byte aligned."""
    n = LM_BATCH * LM_SEQ
    geos = [("bench_x", (2048, 1024), "float32", 8, 1),
            ("qwen_x", (n, m.d_model), "bfloat16", 8, 0),
            ("qwen_w", (m.d_model, m.d_ff), "float32", 8, 0),
            ("qwen_gy", (n, m.d_ff), "bfloat16", 16, 0),
            ("resnet_act", (BATCH, 32, 32, WIDTH), "float32", 8, 0)]
    for shape in ((128, 256), (7, 300), (1000,), (4, 4, 64)):
        for bits in (2, 4, 8, 10, 16):
            geos.append((f"test_{'x'.join(map(str, shape))}_{bits}bit", shape,
                         "float32", bits, 0))
    geos.append(("unaligned", (1000,), "float32", 8, 0))
    geos.append(("unaligned_bf16", (7, 300), "bfloat16", 8, 0))
    return geos


def check_quant_kernel(torch, Q, geometries):
    """Phase 4c: kernel 10 bit for bit against its plain version, timed
    beside it and beside ``fake_quantize_per_tensor_affine`` (which takes
    fp32 and bf16 on the card); the times include the scale's reduction in
    all three."""
    from repro_torch.core.quant import qscale
    from repro_torch.launch.bench_kernels import psg_operands

    tot = {"quantize": _zero_total()}
    details = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    bits_view = {"float32": torch.int32, "bfloat16": torch.int16}
    for name, shape, dt, bits, m in geometries:
        dtype = getattr(torch, dt)
        n = math.prod(shape)
        if name == "bench_x":       # the microbenchmark's own input
            x = psg_operands(False, "cuda")[0]
            assert tuple(x.shape) == shape and x.dtype == dtype
        elif name.startswith("unaligned"):    # a view 4 or 2 bytes in
            x = torch.randn(n + 1, device="cuda", generator=gen).to(dtype)
            x = x[1:].view(shape)
        else:
            x = (torch.randn(shape, device="cuda", generator=gen)
                 * 3.0).to(dtype)
        out = Q.quantize(x, bits)
        ref = Q.quantize_plain(x, qscale(x, bits), bits)
        iv = bits_view[dt]
        if out.shape != x.shape or not torch.equal(out.view(iv), ref.view(iv)):
            diff = int((out.view(iv) != ref.view(iv)).sum())
            fail(f"quantize at {name}: {diff} of {n} elements differ")
        lim = int(2 ** (bits - 1) - 1)
        zp = torch.zeros(1, dtype=torch.int32, device="cuda")
        row = {"geometry": [list(shape), dt, bits], "name": name,
               "calls_counted": m}
        if n >= 2 ** 20:    # the elementwise pass alone, on a scale computed before
            s = qscale(x, bits)
            row["pass_only_ms"] = time_ms(
                torch, lambda: Q.quantize_scaled(x, s, bits))
            row["library_pass_only_ms"] = time_ms(
                torch, lambda: torch.fake_quantize_per_tensor_affine(
                    x, s.reshape(1), zp, -lim, lim))
        # bytes: one read of x, one write of the output, the scale; about
        # four operations an element (divide, round, clamp, multiply)
        time_cases(torch, [("quantize", 0.0,
                            lambda: Q.quantize(x, bits),
                            lambda: Q.quantize_plain(x, qscale(x, bits), bits),
                            lambda: torch.fake_quantize_per_tensor_affine(
                                x, qscale(x, bits).reshape(1), zp, -lim, lim),
                            2 * x.element_size() * n + 4, 4 * n,
                            FP32_OPS_PER_S, m)], row, tot)
        details.append(row)
        del x, out, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return tot, details


def dispatch_check(torch, mods):
    """Phase 4d: ``dispatch.psg_grad_w`` at each ResNet-74 im2col geometry
    of the full kernel microbenchmark (batch 16) under the three backends:
    kernels launched under ``cuda`` and only there, ``cuda`` and ``plain``
    equal in signs and tile ratio, ``reference``'s element-level ratio and
    sign agreement recorded."""
    from repro_torch.configs.paper_cnns import resnet_conv_shapes
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels import dispatch

    cfg = PSGConfig(enabled=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for geo in dict.fromkeys(c.im2col for c in
                             resnet_conv_shapes(DEPTH, WIDTH, 16)):
        N, din, dout = geo
        x = torch.randn(N, din, device="cuda", generator=gen)
        gy = torch.randn(N, dout, device="cuda", generator=gen) * 0.01
        got = {}
        for backend in ("cuda", "plain", "reference"):
            reset_all(mods)
            with dispatch.override_backend(backend):
                sign, fb = dispatch.psg_grad_w(x, gy, cfg)
            torch.cuda.synchronize()
            launches = sum(c for mod in mods for c in mod.LAUNCHES.values())
            if (launches > 0) != (backend == "cuda"):
                fail(f"dispatch under {backend} at {geo}: {launches} "
                     "kernel launches")
            got[backend] = (sign, float(fb), launches)
        (s_c, r_c, _), (s_p, r_p, _), (s_r, r_r, _) = \
            got["cuda"], got["plain"], got["reference"]
        if not (torch.equal(s_c, s_p) and r_c == r_p):
            fail(f"dispatch at {geo}: cuda and plain differ (ratios {r_c}, "
                 f"{r_p})")
        rows.append({"geometry": list(geo), "cuda_launches": got["cuda"][2],
                     "tile_ratio": r_c, "element_ratio_reference": r_r,
                     "sign_agreement_reference": float(
                         (s_r == s_c).float().mean())})
    return rows


def cli_check(torch, mods):
    """Phase 4e: the kernel microbenchmark CLI in full mode, as a user runs
    it; every counter zeroed before and read after."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.kernels import quant as Q
    from repro_torch.launch import bench_kernels

    reset_all(mods)
    t0 = time.perf_counter()
    rows = bench_kernels.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    for name in list(Q.LAUNCHES) + list(PM.LAUNCHES) + list(FA.LAUNCHES):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the microbenchmark")
    families = ("kernel/psg_pallas,", "kernel/quantize,",
                "kernel/psg_resnet74_im2col/", "kernel/flash_attn,")
    if not all(any(r.startswith(f) for r in rows) for f in families):
        fail(f"microbenchmark rows incomplete: {rows}")
    return {"rows": rows, "launches": launches, "wall_s": wall}


def reference_check(torch, e2train="full", fused_conv=None):
    """Phase 5: one train step of a small ResNet on the card and on the CPU
    from the same parameters, batch and SLU decisions, under an
    ``--e2train`` preset and ``fused_conv``."""
    from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
    from repro_torch.launch.train import E2TRAIN, experiment
    from repro_torch.training.train_step import init_train_state, make_train_step

    exp = experiment(depth=14, width=8, batch=8, steps=4,
                     e2=E2TRAIN[e2train], fused_conv=fused_conv)
    batch = make_image_batch(GaussianImageTask(snr=2.0), 0, 0, 0, 8, "cpu")
    keep = [True] * 6
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(exp, seed=0, device=dev)
        state, met = make_train_step(exp)(
            state, {k: v.to(dev) for k, v in batch.items()}, keep=keep)
        out[dev] = ({k: float(v) for k, v in met.items()},
                    {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    return compare_steps(mc, pc, mg, pg)


def compare_steps(mc, pc, mg, pg):
    """Card step vs CPU step: loss within 1e-2 and at least 90% of the
    updated parameter elements equal."""
    # 8-bit activation codes can flip at a rounding boundary between the two
    # summation orders; see tests/test_torch_resnet.py for these bounds
    if not abs(mc["loss"] - mg["loss"]) <= 1e-2 * max(1.0, abs(mc["loss"])):
        fail(f"card loss {mg['loss']} vs CPU {mc['loss']}")
    same = sum(int((pc[k] - pg[k]).abs().le(1e-6).sum()) for k in pc)
    agree = same / sum(p.numel() for p in pc.values())
    if agree < 0.9:
        fail(f"updated parameters agree on only {agree:.3f} of elements")
    return {"loss_cpu": mc["loss"], "loss_cuda": mg["loss"],
            "fallback_cpu": mc.get("psg_fallback_ratio"),
            "fallback_cuda": mg.get("psg_fallback_ratio"),
            "param_agreement": agree}


def lm_reference_check(torch, fused_attention=None):
    """Phase 5: one train step of the reduced qwen2.5-3b on the card and on
    the CPU from the same parameters and batch; SLU decisions come from the
    same step key on both.  ``fused_attention`` is the PSG config's."""
    import copy

    from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
    from repro_torch.launch.train import lm_experiment
    from repro_torch.tasks import get_task
    from repro_torch.training.train_step import make_train_step, train_state_for

    exp = lm_experiment(LM_ARCH, smoke=True, steps=4,
                        fused_attention=fused_attention)
    tc = exp.train
    batch = make_lm_batch(MarkovLMTask(vocab=exp.model.vocab_size), tc.seed,
                          0, 0, tc.global_batch, tc.seq_len, "cpu")
    model = get_task("lm").init(exp, 0, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        state = train_state_for(exp, copy.deepcopy(model).to(dev))
        state, met = make_train_step(exp)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: float(v) for k, v in met.items()},
                    {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    return compare_steps(mc, pc, mg, pg)


def reset_all(mods):
    for mod in mods:
        mod.reset_launches()


def main_path(torch, build, mods, kernels, absent=(), execute=4, smd=True):
    """Phases 6-7: build the trainer for the nominal steps that execute
    ``execute`` (one warm-up, the rest timed; SMD seed 0, p = 0.5, when
    ``smd``) and run them, with every launch counter zeroed just before and
    read just after; fail unless each of ``kernels`` ran and none of
    ``absent`` did."""
    from repro_torch.core.smd import smd_keep_host

    steps, kept = 0, 0
    while kept < execute:
        kept += smd_keep_host(0, steps, 0.5) if smd else 1
        steps += 1
    trainer = build(steps)
    # host cost of one batch: the threefry draws in numpy plus the copy
    t0 = time.perf_counter()
    for step in range(3):
        trainer.make_batch(step, 0)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0) / 3
    reset_all(mods)
    t0 = time.perf_counter()
    hist = trainer.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    if trainer.executed_steps < execute:
        fail(f"only {trainer.executed_steps} steps executed")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for name in absent:
        if launches[name] != 0:
            fail(f"kernel {name} was launched {launches[name]} times on a "
                 "path that should not run it")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("loss", "total_loss")):
            fail(f"non-finite loss at step {h['step']}: {h}")
    fb = trainer.measured_psg_fallback()
    if trainer.exp.e2.psg.enabled and (fb is None or not 0.0 <= fb <= 1.0):
        fail(f"psg_fallback_ratio {fb} outside [0, 1]")
    if not trainer.exp.e2.psg.enabled and fb is not None:
        fail(f"psg_fallback_ratio {fb} measured with PSG off")
    timed = [h["wall_s"] for h in hist[1:]]
    return trainer, {
        "nominal_steps": steps, "executed": trainer.executed_steps,
        "dropped": trainer.dropped_steps, "launches": launches,
        "ms_per_executed_step_first": 1e3 * hist[0]["wall_s"],
        "ms_per_executed_step": 1e3 * sum(timed) / len(timed),
        "host_batch_ms": batch_ms,
        "run_wall_s": wall, "losses": [h["loss"] for h in hist],
        "slu_exec_ratio": [h["slu_exec_ratio"] for h in hist],
        "psg_fallback_ratio": fb,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_executed_step": {
            n: c / trainer.executed_steps for n, c in launches.items()}}


def profile_step(torch, trainer):
    """One more executed step of a main path under torch.profiler: device
    time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    steps = 1
    while not trainer.keeps(trainer.state.step + steps - 1):
        steps += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    from collections import defaultdict

    from torch.autograd import DeviceType

    # device-side events only (kernels, memsets, copies); busy time is the
    # union of their intervals, so overlapping work is not counted twice
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, calls = defaultdict(float), defaultdict(int)
    busy_us, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        t0, t1 = e.time_range.start, e.time_range.end
        by_name[e.name] += t1 - t0
        calls[e.name] += 1
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"step_wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3 if dev else None,
            "device_idle_share": 1 - busy_us / 1e3 / wall_ms if dev else None,
            "top": [{"ms": us / 1e3, "calls": calls[n], "name": n[:80]}
                    for n, us in top]}


def run_path(torch, name, build, mods, kernels, **kw):
    """A main path, its energy report and its profile."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, main = main_path(torch, build, mods, kernels, **kw)
    print(json.dumps({"phase": name, **main}), flush=True)
    print(trainer.energy_report(steps=main["nominal_steps"]).summary(),
          flush=True)
    prof = profile_step(torch, trainer)
    print(json.dumps({"phase": f"{name}_profile", **prof}), flush=True)
    return main, prof


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card to run on")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py")
    pin = os.environ.get("REPRO_TORCH_KERNEL_BACKEND", "").strip()
    if pin:     # plain or reference would hide the kernels; cuda the CPU halves
        fail(f"REPRO_TORCH_KERNEL_BACKEND={pin!r}: run without a pin, the "
             "tensors' device picks the kernels")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}", flush=True)
    from repro_torch.configs import get_experiment
    from repro_torch.configs.paper_cnns import resnet_conv_shapes
    from repro_torch.kernels import build
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.kernels import quant as Q
    from repro_torch.launch.train import E2TRAIN, build_lm_trainer, build_trainer
    t0 = time.perf_counter()
    build.build(list(build.SOURCES), verbose=True)
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)

    shapes_all = resnet_conv_shapes(DEPTH, WIDTH, BATCH, unique=False)
    tot, details = check_kernels(torch, K, shapes_all,
                                 resnet_conv_shapes(DEPTH, WIDTH, BATCH))
    for row in details:
        print(json.dumps(row), flush=True)
    m = get_experiment(LM_ARCH).model
    sites = lm_matmul_sites(m.d_model, m.num_heads, m.num_kv_heads,
                            m.resolved_head_dim, m.d_ff, LM_LAYERS)
    ptot, pdetails = check_psg_matmul_kernels(torch, PM, sites, (200, 328),
                                              LM_BATCH * LM_SEQ)
    tot.update(ptot)
    for row in pdetails:
        print(json.dumps(row), flush=True)
    ftot, fdetails = check_flash_kernels(torch, FA, flash_geometries(m))
    tot.update(ftot)
    for row in fdetails:
        print(json.dumps(row), flush=True)
    ab = attention_ab(torch, m)
    print(json.dumps({"phase": "attention_ab", **ab}), flush=True)
    mods = (K, PM, FA, Q)
    qtot, qdetails = check_quant_kernel(torch, Q, quant_geometries(m))
    tot.update(qtot)
    for row in qdetails:
        print(json.dumps(row), flush=True)
    disp = dispatch_check(torch, mods)
    print(json.dumps({"phase": "dispatch", "rows": disp}), flush=True)
    cli = cli_check(torch, mods)
    print(json.dumps({"phase": "bench_kernels", **cli}), flush=True)
    ref = reference_check(torch)
    print(json.dumps({"phase": "reference", **ref}), flush=True)
    ref_im2col = reference_check(torch, fused_conv=False)
    print(json.dumps({"phase": "reference_im2col", **ref_im2col}), flush=True)
    ref_off = reference_check(torch, e2train="off")
    print(json.dumps({"phase": "reference_psg_off", **ref_off}), flush=True)
    lm_ref = lm_reference_check(torch)
    print(json.dumps({"phase": "lm_reference", **lm_ref}), flush=True)
    lm_flash_ref = lm_reference_check(torch, fused_attention=True)
    print(json.dumps({"phase": "lm_flash_reference", **lm_flash_ref}),
          flush=True)

    main, prof = run_path(
        torch, "main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda"),
        mods, list(K.LAUNCHES))
    im2col_main, im2col_prof = run_path(
        torch, "im2col_main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda",
                                    fused_conv=False),
        mods, list(PM.LAUNCHES), absent=list(K.LAUNCHES), execute=3)
    off_main, off_prof = run_path(
        torch, "psg_off_main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda",
                                    e2=E2TRAIN["off"]),
        mods, [], absent=[n for mod in mods for n in mod.LAUNCHES],
        execute=3, smd=False)
    lm_main, lm_prof = run_path(
        torch, "lm_main_path",
        lambda steps: build_lm_trainer(LM_ARCH, num_layers=LM_LAYERS,
                                       batch=LM_BATCH, seq=LM_SEQ,
                                       steps=steps, device="cuda"),
        mods, list(PM.LAUNCHES))
    lm_flash_main, lm_flash_prof = run_path(
        torch, "lm_flash_main_path",
        lambda steps: build_lm_trainer(LM_ARCH, num_layers=LM_LAYERS,
                                       batch=LM_BATCH, seq=LM_SEQ,
                                       steps=steps, device="cuda",
                                       fused_attention=True),
        mods, list(PM.LAUNCHES) + list(FA.LAUNCHES))

    kernels = []
    for name in REPLACES:
        t = tot[name]
        bytes_ms = 1e3 * t["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * t["ops_s"]
        path = main if name in K.LAUNCHES else \
            lm_main if name in PM.LAUNCHES else \
            lm_flash_main if name in FA.LAUNCHES else cli
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "geometries": details,
         "lm_geometries": pdetails, "flash_geometries": fdetails,
         "attention_ab": ab, "quant_geometries": qdetails,
         "dispatch": disp, "bench_kernels": cli, "reference": ref,
         "reference_im2col": ref_im2col, "reference_psg_off": ref_off,
         "lm_reference": lm_ref,
         "lm_flash_reference": lm_flash_ref, "main_path": main,
         "profile": prof, "im2col_main_path": im2col_main,
         "im2col_profile": im2col_prof, "psg_off_main_path": off_main,
         "psg_off_profile": off_prof,
         "lm_main_path": lm_main, "lm_profile": lm_prof,
         "lm_flash_main_path": lm_flash_main,
         "lm_flash_profile": lm_flash_prof, "kernels": kernels,
         "note": "conv kernel times are summed over the conv sites of one "
                 "ResNet-74 batch-128 step, PSG matmul kernel times over the "
                 "weight-matmul sites of one qwen2.5-3b 8-layer step at "
                 "N = 8192 tokens, flash kernel times over the attention "
                 "sites of one qwen2.5-3b 8-layer step at batch 2 x 4096 "
                 "(kernel 7 twice per layer), with every block executed; "
                 "quantize times over one call at its main path's input, "
                 "the microbenchmark's x (2048 x 1024 fp32, 8 bits), the "
                 "scale's reduction included; its launches are the "
                 "microbenchmark CLI's (the other geometries are in "
                 "quant_geometries, not counted)",
         "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
