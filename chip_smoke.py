#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. report the card (name, power limit) and build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once);
   refuse to run under any ``REPRO_TORCH_KERNEL_BACKEND`` pin (``plain``
   and ``reference`` would hide the kernels, ``cuda`` fail the CPU halves
   of phase 5);
1b. show with ``cuobjdump -sass`` that the tensor-core kernels carry
   tensor-core instructions: IMMA in kernel 1's 8-bit kernel
   (``conv_fwd_mma_kernel``), kernel 2's (``conv_dx_mma_kernel``), kernel 3
   (``conv_pred_mma_kernel``), kernel 4 (``conv_sign_mma_kernel``), kernel 5
   (``pred_mma_kernel``) and kernel 6 (``sign_mma_kernel``), HMMA in
   kernel 7's and kernel 8's bf16 kernels (``flash_fwd_mma_kernel``,
   ``flash_bwd_dq_mma_kernel``), HMMA and IMMA
   in kernel 9's (``flash_bwd_dkv_mma_kernel``), in every instantiation; a
   missing ``cuobjdump`` is reported as not checked;
2. run each of the four conv kernels at every ResNet-74 batch-128 conv
   geometry the training path gives it, hold it against its plain PyTorch
   version (kernels 3 and 4 bit for bit, also against the emulations of
   their padded-grid arithmetic, kernel 3 also with every code at its limit,
   kernel 4 also at tau 0 and above every |pred|;
   kernels 1 and 2 within ``FP32_REL`` of the reference's largest
   magnitude and bit for bit against the emulations of their integer
   arithmetic, kernel 2 also with every code at its limit) and time it with CUDA events next to the plain
   version, a PyTorch library call and its bound, and, it and the library
   call, alone on the device (one call captured in a CUDA graph and
   replayed; so in phases 3-4c too); then, checked and not
   counted, kernel 1 on 16-bit codes (its fp32 kernel) and kernel 3 past
   the size its int32 sums once refused (batch 640 at 32 x 32);
3. the same for the two PSG matmul kernels (bit for bit, signs and flags
   included) at every qwen2.5-3b weight-matmul geometry with N = 8192
   tokens, plus a padded one and the ResNet-74 batch-128 im2col ones
   (checked and timed, not counted), and kernels 5 and 6 alone with every
   code at its limit at N = 700,000 tokens, past the size their int32 sums
   once refused (kernel 6's int64 product also against the exact one), and
   kernel 4 likewise at the ResNet-74 stage-1 conv (147,968 grid positions,
   past one 65,536-position split) at both extreme taus;
4. the same for the three flash-attention kernels at the qwen2.5-3b
   attention geometry (batch 2, 4096 tokens, 16 heads over 2 kv heads, hd
   128, bf16, causal), a padded one (fp32: kernel 7 on the CUDA cores) and
   a non-causal one (limits in ``check_flash_kernels``), plus kernel 9 bit
   for bit on integer inputs and kernel 8 on inputs whose dq cancels (its
   bf16 kernel and, on the same values in fp32, its CUDA-core kernel);
   kernel 7 is timed beside ``scaled_dot_product_attention``; then one
   qwen2.5-3b attention sub-block forward and backward, materialized softmax
   against flash kernels, timed in turns with its peak memory;
4c. the same for the quantize kernels (bit for bit, the scale too) at the
   input of their main path, the kernel microbenchmark's x (2048 x 1024
   fp32, 8 bits), the one their times in the ``kernels`` line are of; also
   at the qwen2.5-3b weight-matmul operands (N = 8192), a ResNet-74
   batch-128 activation, the JAX package's test shapes at 2 to 16 bits and
   inputs holding a NaN, an inf, only zeros or only -0.0; timed beside
   ``fake_quantize_per_tensor_affine``, the reduction and the pass also
   alone on the device, and the kernels one call launches counted by the
   profiler;
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
6b. eval: after ResNet-74's fused run, held-out accuracy
   (``training/evaluate.py``) and predict time on the card with the live
   and the SWA weights (``eval_params``), each against a CPU predict on
   copies within ``EVAL_REL``, and the SWA model's BatchNorm recalibration
   over two training batches on the card and on the CPU (statistics within
   ``BN_REL``, SLU decisions equal);
7. the same as 6 for qwen2.5-3b at full width, 8 of its 36 layers, batch 2
   x sequence 4096 (``build_lm_trainer``), once through the materialized
   softmax and once through the flash kernels (``fused_attention=True``);
   then the flash model's held-out accuracy and predict time (SWA weights),
   and the reduced qwen2.5-3b's logits on the card against the CPU within
   ``LM_EVAL_REL``;
8. the flash LM path at batch 8 x 4096 in 4 microbatches of 2 x 4096
   (``microbatches=4``), as in 7, with every kernel's launches checked
   against the executed sub-blocks of its 4 forward passes per step, and
   the flash path's likewise;
9. one ``microbatches=2`` step on the card against the CPU (ResNet-14 as
   in 5, the reduced qwen2.5-3b on the flash kernels), and the reduced LM's
   ``m=2`` step against its ``m=1`` step under ``sgdm`` on the card within
   ``MB_REL``;
10. resume: the JAX package's kill-and-restart through the port's launcher
   (ResNet-74, ``--e2train full``, fused convs, ``--ckpt-every 1``): a
   ``Supervisor`` world of two workers on the card whose last rank dies at
   step 6 of 10, shrunk to one that resumes from the last intact
   checkpoint, beside two uninterrupted runs; the three final checkpoints
   must be equal bit for bit (checkpoints in a temporary directory);
11. chunked: ``slu_decide`` (the port's own kernel, ``graph_cond.cu``)
   against its plain version on 10**6 random (u, p) pairs, the boundary
   cases and the main path's 0-d shape; ResNet-74 (fused convs, width 16,
   batch 128) through the per-step loop and through
   ``Trainer(chunk_steps=4)`` from the same init over the same nominal
   steps (16 executed), losses, SLU flags, counts, parameters, BatchNorm
   statistics and the SWA average equal bit for bit, every launch counter
   zeroed just before the chunked run (one captured CUDA graph whose
   gated blocks are IF nodes set by ``slu_decide``; kernels 1-4 and
   ``slu_decide`` launched into it), ms per executed step of both (the
   first chunk apart), the replays' device time, capture time, peak
   memory, ``host_batch_ms`` and the idle share of two profiled chunks
   (and of as many per-step steps), compared bit for bit again after; one
   more chunk under
   ``torch.cuda.set_sync_debug_mode("error")``; the im2col and PSG-off
   paths the same at 8 executed steps, and so the flash qwen2.5-3b
   (8 layers, batch 2 x 4096), whose kernel 7 launches show the remat
   recompute inside the captured backward; and ``launch.train
   --chunk-steps 4``;
12. mobilenetv2 (published widths, batch 128, ``--e2train full``): kernels
   1-4 at each of its 21 conv geometries against their plain versions as
   in phase 2 (times summed over its 36 sites, ``mobilenetv2_geometries``
   in chip_smoke.json), and its 17 depthwise convs (plain PyTorch) against
   and beside ``F.conv2d(groups=C)``; one step at batch 8 on the card
   against the CPU with PSG off (loss, updates) and on (loss only: one
   flipped 8-bit code reaches every later one); the fused trainer for at least 4 executed
   steps with 36/35/36/36 launches of kernels 1-4 per executed step and no
   ``slu_decide``, profiled; held-out predict on the card against the CPU
   (live and SWA weights); the im2col path (kernels 5-6, no 1-4); the
   per-step loop against the chunked loop (K=4, no IF node) bit for bit
   over 8 executed steps, one more chunk under
   ``set_sync_debug_mode("error")``; ``launch.train --cnn mobilenetv2`` and
   ``launch.bench_cnn --fast --steps 8``.

The second line from the end is a JSON object ``{"kernels": [...]}``, the
line before it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a card, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
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
GRAPH_COND_SOURCE = "src/repro_torch/kernels/csrc/graph_cond.cu"
# no TPU kernel: slu_decide takes the place of the keep draw that the JAX
# package's chunked step runs under lax.cond
SLU_DECISION = "src/repro/models/resnet.py:205"
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
L2_BYTES = 50e6                 # the L2 cache
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
    """Mean time of ``fn`` on the card, by CUDA events, after one warm-up.
    Where the host enqueues a call more slowly than the card runs it, this
    is the host's time per call."""
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


@functools.lru_cache(maxsize=None)
def side_stream(torch):
    """One side stream for every warm-up: PyTorch keeps a cuBLAS workspace
    for each stream a call runs on."""
    return torch.cuda.Stream()


def device_ms(torch, fn, reps: int = 20, calls: int = 1) -> float:
    """Mean device time of one call of ``fn``: ``calls`` calls captured
    once in a CUDA graph (after two warm-up calls on a side stream) and
    replayed, so that no host work lies between its kernels.  With one
    call a graph, a call of a few microseconds takes at least the host's
    time to replay the graph; twenty a graph spread that time."""
    side = side_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, reps) / calls


def site(s):
    """(B, Hp, C, dout, k, stride, Ho) of a conv as the PSG conv runs it:
    SAME-padded, with ``k < stride`` pre-subsampled to stride 1."""
    hw, k, stride = s.hw, s.k, s.stride
    if k < stride:
        hw, stride = -(-hw // stride), 1
    hp = hw + 2 * (k // 2)
    return s.batch, hp, s.cin, s.cout, k, stride, (hp - k) // stride + 1


# the tensor-core instruction each redesigned kernel must carry, by library
TENSOR_CORE_KERNELS = (("conv", "conv_fwd_mma_kernel", "IMMA"),
                       ("conv", "conv_dx_mma_kernel", "IMMA"),
                       ("conv", "conv_pred_mma_kernel", "IMMA"),
                       ("conv", "conv_sign_mma_kernel", "IMMA"),
                       ("psg_matmul", "pred_mma_kernel", "IMMA"),
                       ("psg_matmul", "sign_mma_kernel", "IMMA"),
                       ("flash_attn", "flash_fwd_mma_kernel", "HMMA"),
                       ("flash_attn", "flash_bwd_dq_mma_kernel", "HMMA"),
                       ("flash_attn", "flash_bwd_dkv_mma_kernel", "HMMA"),
                       ("flash_attn", "flash_bwd_dkv_mma_kernel", "IMMA"))


def sass_check(build):
    """Phase 1b: ``cuobjdump -sass`` of the built libraries shows IMMA in
    the MMA kernels of kernels 1-6, HMMA in kernel 7's and
    kernel 8's bf16 kernels and both in kernel 9's (every instantiation).  A missing
    cuobjdump is reported as not checked."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"checked": False, "why": "cuobjdump not found: tensor-core "
                "instructions not checked"}
    out = {"checked": True}
    sass = {}
    for lib, kernel, op in TENSOR_CORE_KERNELS:
        if lib not in sass:
            sass[lib] = subprocess.run(
                [tool, "-sass", str(build.library_path(lib))],
                capture_output=True, text=True, timeout=300, check=True).stdout
        text = sass[lib]
        funcs = [f for f in text.split("Function : ")[1:]
                 if kernel in f.split("\n", 1)[0]]
        counts = [sum(any(w.startswith(op) for w in line.split())
                      for line in f.splitlines()) for f in funcs]
        if not funcs or not all(counts):
            fail(f"cuobjdump -sass of lib{lib}: {kernel} has no {op} "
                 f"instruction ({len(funcs)} instantiations, counts {counts})")
        out.setdefault(kernel, {"library": lib, "instantiations": len(funcs)})
        out[kernel][f"{op}_per_instantiation"] = counts
    return out


def check_kernels(torch, K, shapes_all, shapes, uncounted=True):
    """Phase 2: every kernel against its plain version, with times (and,
    with ``uncounted``, :func:`conv_uncounted_checks`)."""
    import torch.nn.functional as F
    from repro_torch.core.quant import codes, quantize

    mult = {s: shapes_all.count(s) for s in shapes}
    tot = {n: _zero_total() for n in list(REPLACES)[:4]}
    tot["conv_fwd"]["bound_fp32_ms"] = 0.0
    tot["conv_grad_x"]["bound_fp32_ms"] = 0.0
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
        wq, gq = quantize(w, 8), quantize(gy, 16)
        xc, sx = codes(x, 8)
        wc, sw = codes(w, 8)
        xq = xc.float() * sx                      # quantize(x, 8), bit for bit
        xm, _ = codes(x, 4)
        gm, _ = codes(gy, 10)
        gc, sg = codes(gy, 16)
        w_oihw = wq.reshape(C, k, k, dout).permute(3, 0, 1, 2).contiguous()
        x_nchw = xq.permute(0, 3, 1, 2)          # channels-last views
        g_nchw = gq.permute(0, 3, 1, 2)
        xm_f = xm.float().permute(0, 3, 1, 2)
        gm_f = gm.float().permute(0, 3, 1, 2)
        n_pos, rows = B * ho * ho, k * k * C
        macs = n_pos * rows * dout
        row = {"geometry": [B, hp, C, dout, k, st], "kind": s.kind,
               "sites_per_step": mult[s]}

        # kernel 1: forward on 8-bit codes (int8 tensor cores)
        y = K.conv_fwd(xc, sx, wc, sw, k, st)
        ref = K.conv_fwd_plain(xq, wq, k, st)
        err = float((y - ref).abs().max())
        if not err <= FP32_REL * float(ref.abs().max()):
            fail(f"conv_fwd at {row['geometry']}: max abs err {err}")
        if not torch.equal(y, K.conv_fwd_codes_plain(xc, sx, wc, sw, k, st)):
            fail(f"conv_fwd at {row['geometry']}: differs from the emulation "
                 "of its integer arithmetic")
        # the fp32 kernel's bound: fp32 operands, operations at the fp32 rate
        row["conv_fwd_bound_fp32_ms"] = 1e3 * max(
            4 * (xq.numel() + wq.numel() + y.numel()) / HBM_BYTES_PER_S,
            2 * macs / FP32_OPS_PER_S)
        tot["conv_fwd"]["bound_fp32_ms"] += \
            mult[s] * row["conv_fwd_bound_fp32_ms"]
        cases = [("conv_fwd", err,
                  lambda: K.conv_fwd(xc, sx, wc, sw, k, st),
                  lambda: K.conv_fwd_plain(xc.float() * sx, wc.float() * sw,
                                           k, st),
                  lambda: F.conv2d(x_nchw, w_oihw, stride=st),
                  xc.numel() + wc.numel() + 4 * y.numel() + 8, 2 * macs,
                  INT8_OPS_PER_S, mult[s])]

        # kernel 2: input gradient on the g and weight codes (int8 tensor
        # cores; the stem's image needs none)
        dx = K.conv_grad_x(gc, sg, wc, sw, k, st, hp, hp)
        ref = K.conv_grad_x_plain(gq, wq, k, st, hp, hp)
        err = float((dx - ref).abs().max())
        if not err <= FP32_REL * float(ref.abs().max()):
            fail(f"conv_grad_x at {row['geometry']}: max abs err {err}")
        if not torch.equal(dx, K.conv_grad_x_codes_plain(gc, sg, wc, sw, k,
                                                         st, hp, hp)):
            fail(f"conv_grad_x at {row['geometry']}: differs from the "
                 "emulation of its integer arithmetic")
        row["conv_grad_x_at_limits"] = grad_x_at_limits(torch, K, gc, wc, k,
                                                        st, hp, g)
        # the fp32 kernel's bound: fp32 operands, operations at the fp32 rate
        m2 = 0 if C == 3 else mult[s]
        row["conv_grad_x_bound_fp32_ms"] = 1e3 * max(
            4 * (gq.numel() + wq.numel() + dx.numel()) / HBM_BYTES_PER_S,
            2 * macs / FP32_OPS_PER_S)
        tot["conv_grad_x"]["bound_fp32_ms"] += \
            m2 * row["conv_grad_x_bound_fp32_ms"]
        cases.append(("conv_grad_x", err,
                      lambda: K.conv_grad_x(gc, sg, wc, sw, k, st, hp, hp),
                      lambda: K.conv_grad_x_plain(gc.float() * sg,
                                                  wc.float() * sw, k, st, hp,
                                                  hp),
                      lambda: torch.nn.grad.conv2d_input(
                          (B, C, hp, hp), w_oihw, g_nchw, stride=st),
                      2 * gc.numel() + wc.numel() + 4 * dx.numel() + 8,
                      2 * macs, INT8_OPS_PER_S, m2))

        # kernel 3: PSG predictor product (int8 tensor cores), exact
        pred = K.conv_grad_w_predictor(xm, gm, k, st)
        if not (torch.equal(pred, K.conv_grad_w_predictor_plain(xm, gm, k, st))
                and torch.equal(pred, K.conv_grad_w_predictor_grid_plain(
                    xm, gm, k, st))):
            fail(f"conv_grad_w_predictor at {row['geometry']}: not identical")
        xl = (7 * torch.sign(x)).to(torch.int8)          # codes at their limits
        gl = (511 * torch.where(gy < 0, -1, 1)).to(torch.int16)
        if not torch.equal(K.conv_grad_w_predictor(xl, gl, k, st),
                           K.conv_grad_w_predictor_plain(xl, gl, k, st)):
            fail(f"conv_grad_w_predictor at {row['geometry']} with the codes "
                 "at their limits: not identical")
        del xl, gl
        cases.append(("conv_grad_w_predictor", 0.0,
                      lambda: K.conv_grad_w_predictor(xm, gm, k, st),
                      lambda: K.conv_grad_w_predictor_plain(xm, gm, k, st),
                      lambda: torch.nn.grad.conv2d_weight(
                          xm_f, (dout, C, k, k), gm_f, stride=st),
                      xm.numel() + 2 * gm.numel() + 4 * pred.numel(),
                      2 * macs, INT8_OPS_PER_S, mult[s]))

        # kernel 4: PSG select on the fp32 predictor, exact; also at the
        # two extreme taus (every sign from pred, every sign from the full
        # product) and against the emulation of its grid arithmetic
        big = pred.float().abs().amax()
        for tau in (torch.zeros((), device="cuda"), 2 * big + 1, 0.05 * big):
            sign, stats = K.conv_grad_w(pred, xc, gc, tau, k, st)
            psign, pstats = K.conv_grad_w_plain(pred, xc, gc, tau, k, st)
            gsign, gstats = K.conv_grad_w_grid_plain(pred, xc, gc, tau, k, st)
            if not (torch.equal(sign, psign) and torch.equal(stats, pstats)
                    and torch.equal(sign, gsign)
                    and torch.equal(stats, gstats)):
                fail(f"conv_grad_w at {row['geometry']}, tau {float(tau)}: "
                     "not identical")
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
    if uncounted:
        details.append(conv_uncounted_checks(torch, K, g))
    return tot, details


def grad_x_at_limits(torch, K, gc, wc, k, st, hp, g):
    """Kernel 2 with every g code at +-32767 and every weight code at
    +-127, the signs aligned a channel (3x3 dout-64 sums reach 2.4e9, past
    int32): bit for bit its emulation.  Returns the largest |dx|."""
    dout = gc.shape[-1]
    sigma = torch.where(torch.randn(dout, device="cuda", generator=g) < 0,
                        -1, 1)
    gl = (32767 * sigma).expand(gc.shape).to(torch.int16).contiguous()
    wl = (-127 * sigma).expand(wc.shape).to(torch.int8).contiguous()
    sg, sw = (torch.tensor(v, device="cuda") for v in (3.1e-7, 7.9e-3))
    dx = K.conv_grad_x(gl, sg, wl, sw, k, st, hp, hp)
    if not torch.equal(dx, K.conv_grad_x_codes_plain(gl, sg, wl, sw, k, st,
                                                     hp, hp)):
        fail(f"conv_grad_x with the codes at their limits at k={k}, "
             f"stride={st}, dout={dout}: differs from its emulation")
    return float(dx.abs().max() / (sg * sw))


def conv_uncounted_checks(torch, K, g):
    """Phase 2, checked and not counted: kernels 1 and 2 on 12-bit codes
    (their fp32 kernels, within ``FP32_REL``) at a ResNet-74 body geometry,
    and kernel 3
    bit for bit at batch 640 of 32 x 32 images (C 3, dout 16, every code at
    its limit: sums up to 640 * 1024 * 7 * 511 pass 2**31)."""
    from repro_torch.core.quant import codes

    x = torch.randn(128, 18, 18, 32, device="cuda", generator=g)
    w = torch.randn(288, 32, device="cuda", generator=g) * 0.1
    (xc, sx), (wc, sw) = codes(x, 12), codes(w, 12)
    y = K.conv_fwd(xc, sx, wc, sw, 3, 1)
    ref = K.conv_fwd_plain(xc.float() * sx, wc.float() * sw, 3, 1)
    err16 = float((y - ref).abs().max())
    if xc.dtype != torch.int16 or not err16 <= FP32_REL * float(ref.abs().max()):
        fail(f"conv_fwd on int16 codes: max abs err {err16}")
    gc, sg = codes(torch.randn(128, 16, 16, 32, device="cuda", generator=g)
                   * 0.01, 16)
    dx = K.conv_grad_x(gc, sg, wc, sw, 3, 1, 18, 18)
    ref = K.conv_grad_x_plain(gc.float() * sg, wc.float() * sw, 3, 1, 18, 18)
    err_dx16 = float((dx - ref).abs().max())
    if not err_dx16 <= FP32_REL * float(ref.abs().max()):
        fail(f"conv_grad_x on int16 weight codes: max abs err {err_dx16}")
    x = torch.randn(640, 34, 34, 3, device="cuda", generator=g)
    gy = torch.randn(640, 32, 32, 16, device="cuda", generator=g)
    xm = (7 * torch.sign(x)).to(torch.int8)
    gm = (511 * torch.where(gy < 0, -1, 1)).to(torch.int16)
    pred = K.conv_grad_w_predictor(xm, gm, 3, 1)
    want = K.conv_grad_w_predictor_plain(xm, gm, 3, 1)
    if not torch.equal(pred, want):
        fail("conv_grad_w_predictor at batch 640: not identical")
    return {"name": "checked_not_counted", "conv_fwd_int16_codes":
            {"geometry": [128, 18, 32, 32, 3, 1], "max_abs_err": err16},
            "conv_grad_x_int16_weight_codes":
            {"geometry": [128, 18, 32, 32, 3, 1], "max_abs_err": err_dx16},
            "conv_grad_w_predictor_batch640": {
                "geometry": [640, 34, 3, 16, 3, 1], "identical": True,
                "max_abs": float(want.abs().max())}}


def _zero_total():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops_s=0.0,
                max_abs_err=0.0, device_ms=0.0, library_device_ms=0.0)


def time_cases(torch, cases, row, tot):
    """Time each (kernel, plain, library) triple and add it, weighted by
    its sites per step, to the kernel's totals; the kernel's call and the
    library's are also timed alone on the device (:func:`device_ms`)."""
    for name, err, kern, plain, lib, nbytes, ops, peak, m in cases:
        r = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
             "library_ms": time_ms(torch, lib) if lib else None,
             "device_ms": device_ms(torch, kern),
             "library_device_ms": device_ms(torch, lib) if lib else None,
             "bytes": nbytes, "ops": ops, "max_abs_err": err,
             "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)}
        row[name] = r
        t = tot[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        for key in ("ms", "plain_ms", "bytes", "device_ms"):
            t[key] += m * r[key]
        for key in ("library_ms", "library_device_ms"):
            t[key] = None if lib is None else t[key] + m * r[key]
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


def check_psg_matmul_kernels(torch, PM, sites, padded, n_tokens, im2col):
    """Phase 3: kernels 5 and 6 against their plain versions at each weight
    matmul geometry, timed; the padded geometry and the ResNet-74 im2col
    ones (``im2col``: {(N, din, dout): sites per step}) are checked and
    timed, not counted (the im2col step's sums go to ``im2col_totals``);
    then kernels 5 and 6 alone at the worst-case magnitude
    (``worst_case_check``, ``sign_worst_case_check``)."""
    from repro_torch.core.quant import codes

    tot = {n: _zero_total() for n in ("predictor_matmul", "psg_grad_w")}
    im2col_tot = {n: _zero_total() for n in tot}
    details = []
    g = torch.Generator(device="cuda").manual_seed(1)
    geos = [((n_tokens, din, dout), m, tot) for (din, dout), m in sites.items()]
    geos.append(((n_tokens, *padded), 0, tot))
    geos += [(geo, m, im2col_tot) for geo, m in im2col.items()]
    for (N, din, dout), m, into in geos:
        x = torch.randn(N, din, device="cuda", generator=g)
        gy = torch.randn(N, dout, device="cuda", generator=g) * 0.01
        xm, gm = codes(x, 4)[0], codes(gy, 10)[0]
        xq, gq = codes(x, 8)[0], codes(gy, 16)[0]
        del x, gy
        row = {"geometry": [N, din, dout], "sites_per_step": m,
               "path": "im2col" if into is im2col_tot else "qwen"}
        pred = PM.predictor_matmul(xm, gm)
        if not torch.equal(pred, PM.predictor_matmul_plain(xm, gm)):
            fail(f"predictor_matmul at {row['geometry']}: not identical")
        tau = 0.05 * pred.float().abs().amax()
        sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
        psign, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
        if not (torch.equal(sign, psign) and torch.equal(stats, pstats)):
            fail(f"psg_grad_w at {row['geometry']}: not identical")
        row["fallback_flags"] = float(stats.float().mean())
        ops = 2 * N * din * dout
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
        time_cases(torch, cases, row, into)
        details.append(row)
        del xm_f, gm_f
        torch.cuda.synchronize()
    details.append(worst_case_check(torch, PM))
    details.append(sign_worst_case_check(torch, PM))
    details.append(conv_sign_worst_case_check(torch))
    return tot, details, im2col_tot


def worst_case_check(torch, PM, din=48, dout=160, N=700_000):
    """Kernel 5 bit for bit with every 4-bit x code at +-7 and every 10-bit
    g code at +-511, signed so that every output element is +-N * 7 * 511
    (2.5e9 at N = 700,000: past 2**31, the size the int32 sums once
    refused, and past 2**24, where the fp32 output rounds); where g is -511
    (hi = -2, lo = 1) the high plane's sum is 256 times larger still.  dout
    160 takes the 128 x 128 tiles with the token axis split across blocks
    (int64 atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def sign(*shape):
        return torch.randint(0, 2, shape, device="cuda", generator=gen) * 2 - 1

    tok = sign(N, 1)
    xm = (7 * tok * sign(1, din)).to(torch.int8)
    gm = (511 * tok * sign(1, dout)).to(torch.int16)
    pred = PM.predictor_matmul(xm, gm)
    want = PM.predictor_matmul_plain(xm, gm)
    top = torch.tensor(float(N * 7 * 511), device="cuda")   # rounded to fp32
    if not (torch.equal(pred, want) and bool((want.abs() == top).all())):
        diff = int((pred != want).sum())
        fail(f"predictor_matmul at the worst case N={N}: {diff} of "
             f"{want.numel()} elements differ")
    return {"geometry": [N, din, dout], "path": "worst_case",
            "predictor_matmul": "identical", "max_abs": float(top)}


def sign_worst_case_check(torch, PM, din=48, dout=160, N=700_000):
    """Kernel 6 with every 8-bit x code at +-127 and every 16-bit g code at
    +-32767, signed so that every element of the full product is +-N * 127
    * 32767 (2.9e12 at N = 700,000: past 65,536 tokens per split and past
    2**31); tau lies above every |pred|, so every sign comes from the full
    product.  Its int64 product (``psg_full_product``, the same pre-pass
    and MMA kernel) must equal the exact ``_code_product``, and its signs
    and flags those of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def sign(*shape):
        return torch.randint(0, 2, shape, device="cuda", generator=gen) * 2 - 1

    tok = sign(N, 1)
    xq = (127 * tok * sign(1, din)).to(torch.int8)
    gq = (32767 * tok * sign(1, dout)).to(torch.int16)
    full = PM.psg_full_product(xq, gq)
    want = PM._code_product(xq, gq).to(torch.int64)
    if not (torch.equal(full, want)
            and bool((want.abs() == N * 127 * 32767).all())):
        diff = int((full != want).sum())
        fail(f"psg_full_product at the worst case N={N}: {diff} of "
             f"{want.numel()} elements differ")
    pred = torch.randn(din, dout, device="cuda", generator=gen)
    tau = 2 * pred.abs().amax()
    s, stats = PM.psg_grad_w(pred, xq, gq, tau)
    ps, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
    if not (torch.equal(s, ps) and torch.equal(stats, pstats)
            and torch.equal(s, torch.sign(full).to(torch.int8))):
        fail(f"psg_grad_w at the worst case N={N}: not identical")
    return {"geometry": [N, din, dout], "path": "sign_worst_case",
            "psg_full_product": "identical", "psg_grad_w": "identical",
            "max_abs": int(want.abs().max())}


def conv_sign_worst_case_check(torch, B=128, hw=32, C=16, dout=16):
    """Kernel 4 at the ResNet-74 stage-1 conv (batch 128, 3x3, 16 -> 16:
    147,968 grid positions, past one 65,536-position split) with every
    8-bit x code at +-127 and every 16-bit g code at +-32767, signed per
    image and per channel or column so that every element of the full
    product is +-(its tap's positions) * 127 * 32767 (up to 5.5e11, past
    2**31); at tau above every |pred| every sign comes from the full product
    and every flag is set, at tau 0 every sign from pred and no flag.  Signs
    and flags must equal the plain version's, and at the high tau the signs
    of the exact product."""
    from repro_torch.kernels import conv as K

    gen = torch.Generator(device="cuda").manual_seed(8)

    def sign(*shape):
        return torch.randint(0, 2, shape, device="cuda", generator=gen) * 2 - 1

    img = sign(B, 1, 1, 1)
    xq = torch.zeros(B, hw + 2, hw + 2, C, device="cuda", dtype=torch.int8)
    xq[:, 1:-1, 1:-1] = (127 * img * sign(1, 1, 1, C)).to(torch.int8)
    gq = (32767 * img * sign(1, 1, 1, dout)).expand(B, hw, hw, dout) \
        .to(torch.int16).contiguous()
    exact = K._code_product(xq, gq, 3, 1)
    pred = torch.randn(9 * C, dout, device="cuda", generator=gen)
    out = {"geometry": [B, hw + 2, C, dout, 3, 1], "path": "conv_sign_worst_case",
           "grid_positions": B * (hw + 2) ** 2,
           "max_abs": float(exact.abs().max())}
    for name, tau in (("tau_above_pred", 2 * pred.abs().amax()),
                      ("tau_zero", torch.zeros((), device="cuda"))):
        s, stats = K.conv_grad_w(pred, xq, gq, tau, 3, 1)
        ps, pstats = K.conv_grad_w_plain(pred, xq, gq, tau, 3, 1)
        want = torch.sign(exact if name == "tau_above_pred" else pred)
        if not (torch.equal(s, ps) and torch.equal(stats, pstats)
                and torch.equal(s, want.to(torch.int8))
                and bool((stats == int(name == "tau_above_pred")).all())):
            fail(f"conv_grad_w at the worst case, {name}: not identical")
        out[name] = "identical"
    return out


# kernel 9's code products: a P or dS code flips where the kernel's q k^T
# sums in another order than the plain matmul, moving one product element by
# one code of the other operand; at most this share of elements may differ,
# by at most this share of the largest magnitude (tests/test_torch_cuda.py)
DKV_MISMATCH, DKV_REL = 1e-3, 1e-3


def bf16_ulp_ratio(torch, a, ref) -> float:
    """The largest ``|a - ref|`` as a share of its slack: one bf16 ulp of
    the larger magnitude, plus 1e-6 * max|ref| for the fp32 difference
    before both were rounded to bf16.  At most 1 holds the contract."""
    a, ref = a.double(), ref.double()
    big = torch.maximum(a.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((a - ref).abs() / (ulp + 1e-6 * ref.abs().max())).max())


def bf16_one_ulp(torch, a, ref) -> bool:
    return bf16_ulp_ratio(torch, a, ref) <= 1.0


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
    tot["flash_bwd_dq"]["bound_fp32_ms"] = 0.0
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
        row["flash_bwd_dq_max_abs_ref"] = float(dq_p.abs().max())

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
             # bf16: q k^T and the two P v products of the split P, on the
             # tensor cores; fp32: q k^T and P v on the CUDA cores
             *(rate((3 * prod, mm)) if dt == "bfloat16"
               else rate((prod, mm), (prod, FP32_OPS_PER_S))), sites[0]),
            ("flash_bwd_dq", err_dq,
             lambda: FA.flash_bwd_dq(q, k, v, do, lse_p, delta,
                                     causal=causal),
             lambda: FA.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                           causal=causal),
             None, qkv + e * do.numel() + 2 * rows + 4 * dq.numel(),
             # bf16: q k^T, dO v^T and the three dS k products of the split
             # dS, on the tensor cores; fp32: dS k on the CUDA cores too
             *(rate((5 * prod, mm)) if dt == "bfloat16"
               else rate((2 * prod, mm), (prod, FP32_OPS_PER_S))), sites[1]),
            ("flash_bwd_dkv", err_kv,
             lambda: FA.flash_bwd_dkv(q, k, v, do, lse_p, delta, scales,
                                      lims=lims, causal=causal),
             lambda: FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                            lims=lims, causal=causal),
             None, qkv + e * do.numel() + 2 * rows + 24 + 32 * k.numel(),
             *rate((2 * prod, mm), (4 * prod, INT8_OPS_PER_S)), sites[2])]
        time_cases(torch, cases, row, tot)
        # the CUDA-core kernel's bound (dS k at the fp32 rate), as before
        # the tensor-core kernel
        row["flash_bwd_dq_bound_fp32_ms"] = 1e3 * max(
            row["flash_bwd_dq"]["bytes"] / HBM_BYTES_PER_S,
            2 * prod / mm + prod / FP32_OPS_PER_S)
        tot["flash_bwd_dq"]["bound_fp32_ms"] += \
            sites[1] * row["flash_bwd_dq_bound_fp32_ms"]
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
    details.append(dq_cancel_check(torch, FA, geometries[0]))
    details.append(dkv_past_guard(torch, FA, gen, lims))
    details.append(split_p_adversarial(torch, FA, geometries[0], gen))
    return tot, details


def dq_cancel_check(torch, FA, geometry):
    """Kernel 8 at ``geometry`` (the qwen2.5-3b one) on inputs whose dq
    cancels (``FA.dq_cancel_inputs``: keys with a common component 8 times
    their spread): its bf16 kernel (three bf16 parts of dS) and its
    CUDA-core kernel on the same values in fp32, each within ``FP32_REL``
    of max|dq| of the plain version; returns each error as a share of that
    limit (the margin is its inverse)."""
    _, B, S, nh, nkv, hd, _, causal, _ = geometry
    q, k, v, do = FA.dq_cancel_inputs(B, S, nh, nkv, hd, device="cuda")
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    want = FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    limit = FP32_REL * float(want.abs().max())
    share = {}
    for kind, args in (("bf16_tensor_cores", (q, k, v, do)),
                       ("fp32_cuda_cores", tuple(t.float()
                                                 for t in (q, k, v, do)))):
        got = FA.flash_bwd_dq(*args, lse, delta, causal=causal)
        share[kind] = float((got - want).abs().max()) / limit
        del got
    out = {"name": "dq_cancel", "geometry": [B, S, nh, nkv, hd, causal],
           "max_abs_dq": float(want.abs().max()),
           "share_of_limit": share}
    if not all(v <= 1.0 for v in share.values()):
        fail(f"flash_bwd_dq on cancelling inputs: {out}")
    del q, k, v, do, o, want
    torch.cuda.empty_cache()
    return out


def dkv_past_guard(torch, FA, gen, lims, S=9472, nh=64, hd=16):
    """Kernel 9 bit for bit on small integer inputs at S g = 606,208 query
    rows per kv head (g = nh, one kv head), past the 600,358 its int32
    predictor sums once refused."""
    q, k, v, do = (torch.randint(-2, 3, shape, device="cuda",
                                 generator=gen).to(torch.bfloat16)
                   for shape in ((1, S, nh, hd), (1, S, 1, hd),
                                 (1, S, 1, hd), (1, S, nh, hd)))
    o, lse = FA.flash_attention_plain(q, k, v)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8, bits_x_msb=4,
                                     bits_g=16, bits_g_msb=10)
    got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=lims)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales, lims=lims)
    if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
        fail(f"flash_bwd_dkv at S g = {S * nh}: not identical")
    out = {"name": "dkv_past_guard", "geometry": [1, S, nh, 1, hd],
           "flash_bwd_dkv": "identical",
           "max_abs": [float(w_.abs().max()) for w_ in want]}
    del q, k, v, do, o, got, want
    torch.cuda.empty_cache()
    return out


def split_p_adversarial(torch, FA, geometry, gen):
    """Kernel 7 at ``geometry`` (the qwen2.5-3b one) with v built against
    its split P (``FA.split_p_adversarial_v``: in each column one query
    row's rounding terms all add while its o cancels): o within one bf16
    ulp plus 1e-6 * max|o| of the plain version, lse within 1e-5; returns
    the largest error as a share of that slack (the margin is its
    inverse)."""
    _, B, S, nh, nkv, hd, dt, causal, _ = geometry
    q = torch.randn(B, S, nh, hd, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, nkv, hd, device="cuda", generator=gen).to(torch.bfloat16)
    v = FA.split_p_adversarial_v(q, k, causal=causal)
    o, lse = FA.flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = FA.flash_attention_plain(q, k, v, causal=causal)
    ratio = bf16_ulp_ratio(torch, o.float(), o_p.float())
    err_l = float((lse - lse_p).abs().max())
    g = nh // nkv

    def targets(t):      # the element of each column's target row
        return torch.stack([t[:, S - 1 - d // g, n * g + d % g, d].float()
                            for n in range(nkv) for d in range(hd)])

    t_k, t_p = targets(o), targets(o_p)
    big = torch.maximum(t_k.abs(), t_p.abs()).clamp_min(1e-30).double()
    slack = torch.exp2(torch.floor(torch.log2(big)) - 7) \
        + 1e-6 * float(o_p.float().abs().max())
    out = {"name": "split_p_adversarial", "geometry": [B, S, nh, nkv, hd, dt],
           "share_of_slack": ratio, "lse_err": err_l,
           "max_abs_err": float((o.float() - o_p.float()).abs().max()),
           "target_share_of_slack": float(((t_k - t_p).abs().double()
                                           / slack).max()),
           "target_median_abs_o": float(t_p.abs().median()),
           "max_abs_o": float(o_p.float().abs().max())}
    if not (ratio <= 1.0 and err_l <= 1e-5):
        fail(f"flash_fwd on the split-P adversarial v: {out}")
    del q, k, v, o, o_p
    torch.cuda.empty_cache()
    return out


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
    at N = 8192 (x, w and gy of the d_ff matmuls; gy, 180 MB of bf16, is
    above the 50 MB L2) and a ResNet-74 batch-128 activation, which the
    training paths quantize in PyTorch (``core/quant``); checked only: the
    JAX package's test shapes at 2-16 bits, inputs that are not 16-byte
    aligned and inputs holding a NaN, an inf, only zeros or only -0.0."""
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
    for dt in ("float32", "bfloat16"):
        for special in ("nan", "inf", "zero", "negzero"):
            geos.append((f"{special}_{dt}", (3, 1000), dt, 8, 0))
    return geos


def quant_input(torch, name, shape, dtype, gen):
    """The input of one quantize geometry (``quant_geometries``)."""
    from repro_torch.launch.bench_kernels import psg_operands

    n = math.prod(shape)
    if name == "bench_x":       # the microbenchmark's own input
        x = psg_operands(False, "cuda")[0]
        assert tuple(x.shape) == shape and x.dtype == dtype
        return x
    if name.startswith("unaligned"):    # a view 4 or 2 bytes in
        x = torch.randn(n + 1, device="cuda", generator=gen).to(dtype)
        return x[1:].view(shape)
    x = (torch.randn(shape, device="cuda", generator=gen) * 3.0).to(dtype)
    special = name.split("_")[0]
    if special in ("zero", "negzero"):
        x.fill_(-0.0 if special == "negzero" else 0.0)
    elif special in ("nan", "inf"):
        x.view(-1)[n // 2] = float(special)
    return x


def launches_per_call(torch, fn) -> int:
    """Device kernels that one call of ``fn`` launches, counted by the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def check_quant_kernel(torch, Q, geometries):
    """Phase 4c: kernel 10 bit for bit against its plain version (its scale
    against ``qscale``), timed beside it and beside
    ``fake_quantize_per_tensor_affine`` (which takes fp32 and bf16 on the
    card); the times include the scale's reduction in all three.  Above
    1M elements the reduction (``absmax``) and the pass
    (``quantize_scaled``) are also timed apart, eager and alone on the
    device, and at the counted geometry the kernels of one call are
    counted."""
    from repro_torch.core.quant import qscale

    tot = {"quantize": _zero_total()}
    tot["quantize"]["bound_single_read_ms"] = 0.0
    details = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    bits_view = {"float32": torch.int32, "bfloat16": torch.int16}
    for name, shape, dt, bits, m in geometries:
        dtype = getattr(torch, dt)
        n = math.prod(shape)
        x = quant_input(torch, name, shape, dtype, gen)
        out, s = Q.quantize_with_scale(x, bits)
        want_s = qscale(x, bits)
        if out.shape != x.shape or not torch.equal(s.view(torch.int32),
                                                   want_s.view(torch.int32)):
            fail(f"quantize at {name}: scale {float(s)} against qscale's "
                 f"{float(want_s)}")
        ref = Q.quantize_plain(x, want_s, bits)
        iv = bits_view[dt]
        if not torch.equal(out.view(iv), ref.view(iv)):
            diff = int((out.view(iv) != ref.view(iv)).sum())
            fail(f"quantize at {name}: {diff} of {n} elements differ")
        row = {"geometry": [list(shape), dt, bits], "name": name,
               "calls_counted": m, "scale": float(s)}
        if not math.isfinite(float(s)) or float(x.float().abs().max()) == 0:
            details.append(row)        # special values: checked only
            continue
        lim = int(2 ** (bits - 1) - 1)
        zp = torch.zeros(1, dtype=torch.int32, device="cuda")
        if n >= 2 ** 20:    # the reduction and the pass apart
            row["reduce_ms"] = time_ms(torch, lambda: Q.absmax(x))
            row["pass_only_ms"] = time_ms(
                torch, lambda: Q.quantize_scaled(x, s, bits))
            for key, fn in (("reduce", lambda: Q.absmax(x)),
                            ("pass", lambda: Q.quantize_scaled(x, s, bits)),
                            ("call", lambda: Q.quantize(x, bits))):
                row[f"{key}_device_ms_graph20"] = device_ms(torch, fn,
                                                            calls=20)
            row["library_pass_only_ms"] = time_ms(
                torch, lambda: torch.fake_quantize_per_tensor_affine(
                    x, s.reshape(1), zp, -lim, lim))
            row["launches_per_call"] = launches_per_call(
                torch, lambda: Q.quantize(x, bits))
        # bytes: one read of x, one write of the output, the scale, and a
        # second read of x where x is above the L2 (the amax must read all
        # of x before any output is written); about four operations an
        # element (divide, round, clamp, multiply)
        nx = x.element_size() * n
        nbytes = 2 * nx + 4 + (nx if nx > L2_BYTES else 0)
        row["bound_single_read_ms"] = 1e3 * max(
            (2 * nx + 4) / HBM_BYTES_PER_S, 4 * n / FP32_OPS_PER_S)
        tot["quantize"]["bound_single_read_ms"] += \
            m * row["bound_single_read_ms"]
        time_cases(torch, [("quantize", 0.0,
                            lambda: Q.quantize(x, bits),
                            lambda: Q.quantize_plain(x, qscale(x, bits), bits),
                            lambda: torch.fake_quantize_per_tensor_affine(
                                x, qscale(x, bits).reshape(1), zp, -lim, lim),
                            nbytes, 4 * n, FP32_OPS_PER_S, m)], row, tot)
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


def reference_check(torch, e2train="full", fused_conv=None, microbatches=1):
    """Phase 5: one train step of a small ResNet on the card and on the CPU
    from the same parameters, batch and SLU decisions, under an
    ``--e2train`` preset, ``fused_conv`` and ``microbatches`` (the injected
    decisions hold for every microbatch)."""
    import dataclasses

    from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
    from repro_torch.launch.train import E2TRAIN, experiment
    from repro_torch.training.train_step import init_train_state, make_train_step

    exp = experiment(depth=14, width=8, batch=8, steps=4,
                     e2=E2TRAIN[e2train], fused_conv=fused_conv)
    exp = exp.replace(train=dataclasses.replace(exp.train,
                                                microbatches=microbatches))
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


def lm_reference_check(torch, fused_attention, microbatches=1):
    """Phase 5: one train step of the reduced qwen2.5-3b on the card and on
    the CPU from the same parameters and batch; SLU decisions come from the
    same step key on both.  ``fused_attention`` is the PSG config's,
    ``microbatches`` the train config's."""
    import copy

    from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
    from repro_torch.launch.train import lm_experiment
    from repro_torch.tasks import get_task
    from repro_torch.training.train_step import make_train_step, train_state_for

    exp = lm_experiment(LM_ARCH, smoke=True, steps=4,
                        fused_attention=fused_attention,
                        microbatches=microbatches)
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
    return trainer, main, prof


EVAL_REL = 1e-5        # ResNet predict logits, card against CPU, of max |logit|
# the LM's softmax rounds its probabilities to bf16 (the JAX package's
# _softmax_lowp): a probability within an fp32 rounding of a bf16 boundary
# rounds one way on the card and the other on the CPU, a step of 2^-8 of it
LM_EVAL_REL = 1e-3
BN_REL = 1e-4          # recalibrated BatchNorm statistics, of max |buffer|
MB_REL = 1e-5          # LM m=2 against m=1 under sgdm, of max |parameter|
RECAL_BATCHES = 2
LM_MICRO = 4           # microbatches of the microbatched LM path
RESUME_STEPS, RESUME_KILL = 10, 6


def rel_err(a, ref) -> float:
    """max |a - ref| over max |ref|, in float64 on the host."""
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def heldout_card(torch, exp, model):
    """Held-out accuracy (``evaluate.accuracy``) of ``model`` on the card,
    ms per held-out batch of its predict (after one warm-up), and the
    logits of held-out batch 0."""
    from repro_torch.tasks import get_task
    from repro_torch.training import evaluate

    predict = get_task(exp.task).make_predict(exp)
    batches = [evaluate.heldout_batch(exp, i, "cuda")
               for i in range(evaluate.HELDOUT_BATCHES)]
    predict(model, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [predict(model, b) for b in batches]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    acc = evaluate.accuracy(exp, model, "cuda")
    return {"accuracy": acc, "ms_per_heldout_batch": ms}, logits[0], batches[0]


def card_against_cpu(torch, exp, model, what, limit=EVAL_REL):
    """``model``'s held-out accuracy and predict time on the card, and its
    held-out batch-0 logits against a CPU predict on a copy (the padded
    vocabulary's masked columns left out)."""
    import copy

    from repro_torch.tasks import get_task

    out, logits, batch = heldout_card(torch, exp, model)
    cpu = get_task(exp.task).make_predict(exp)(
        copy.deepcopy(model).to("cpu"), {k: v.cpu() for k, v in batch.items()})
    n = exp.model.vocab_size
    err = rel_err(logits[..., :n], cpu[..., :n])
    if not err <= limit:
        fail(f"{what}: card logits differ from the CPU's by {err:.3g} of "
             f"max |logit| (limit {limit})")
    same = float((logits[..., :n].argmax(-1).cpu() == cpu[..., :n].argmax(-1))
                 .float().mean())
    return {**out, "logits_rel_err_vs_cpu": err, "argmax_agreement": same}


def eval_check(torch, trainer):
    """Phase eval (ResNet-74, after the main path's run): held-out accuracy
    and predict time on the card with the live weights and with the SWA
    weights (``eval_params``), each held against a CPU predict on copies of
    the same parameters and BatchNorm statistics; then the SWA model's
    BatchNorm recalibration over training batches on the card and on the
    CPU (statistics within ``BN_REL``, SLU decisions equal)."""
    import copy

    from repro_torch.core import rng
    from repro_torch.training.train_step import (eval_params,
                                                 recalibrate_model_state)

    exp, state = trainer.exp, trainer.state
    live = card_against_cpu(torch, exp, state.model, "live weights")
    swa_model = eval_params(state, exp)
    if swa_model is state.model:
        fail("eval_params returned the live model with SWA on")
    swa = card_against_cpu(torch, exp, swa_model, "SWA weights")
    batches = [trainer.make_batch(s, trainer.shard)
               for s in range(RECAL_BATCHES)]
    key = rng.PRNGKey(exp.train.seed)
    decided, bufs, models, recal_ms = {}, {}, {}, 0.0
    for dev in ("cuda", "cpu"):
        bs = [{k: v.to(dev) for k, v in b.items()} for b in batches]
        probe = copy.deepcopy(swa_model).to(dev)
        with torch.no_grad():     # a train-mode forward decides as recal does
            decided[dev] = [probe(b["image"], key=rng.fold_in(key, i))[1]
                            ["slu_executed"].tolist()
                            for i, b in enumerate(bs)]
        models[dev] = copy.deepcopy(swa_model).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bufs[dev] = recalibrate_model_state(exp, models[dev], bs)
        torch.cuda.synchronize()
        if dev == "cuda":
            recal_ms = 1e3 * (time.perf_counter() - t0)
    if decided["cuda"] != decided["cpu"]:
        fail(f"recalibration's SLU decisions differ: card {decided['cuda']}, "
             f"CPU {decided['cpu']}")
    err = max(rel_err(bufs["cuda"][k], bufs["cpu"][k]) for k in bufs["cpu"])
    if not err <= BN_REL:
        fail(f"recalibrated statistics differ by {err:.3g} (limit {BN_REL})")
    recal = card_against_cpu(torch, exp, models["cuda"], "recalibrated SWA")
    return {"live": live, "swa": swa, "recalibrated_swa": recal,
            "recalibration_batches": RECAL_BATCHES,
            "recalibration_ms": recal_ms, "bn_rel_err_vs_cpu": err,
            "slu_executed": decided["cuda"], "card": card_line(),
            "limits": {"logits": EVAL_REL, "bn": BN_REL}}


def lm_eval_check(torch, trainer):
    """Phase eval (LM): held-out accuracy and predict time of the trained
    8-layer qwen2.5-3b's SWA weights on the card; then the reduced
    qwen2.5-3b's logits on the card against the CPU (a full-width CPU
    forward is too slow for this script)."""
    import copy

    from repro_torch.launch.train import lm_experiment
    from repro_torch.tasks import get_task
    from repro_torch.training.train_step import eval_params

    exp = trainer.exp
    full = heldout_card(torch, exp, eval_params(trainer.state, exp))[0]
    small = lm_experiment(LM_ARCH, smoke=True, steps=4)
    model = get_task("lm").init(small, 0, "cpu")
    reduced = card_against_cpu(torch, small, copy.deepcopy(model).to("cuda"),
                               "reduced LM", LM_EVAL_REL)
    return {"full_width": full, "reduced": reduced, "card": card_line(),
            "limit": LM_EVAL_REL}


def lm_microbatch_equivalence(torch):
    """The reduced qwen2.5-3b under ``sgdm`` with PSG off on the card: one
    ``microbatches=2`` step against one ``microbatches=1`` step from the
    same parameters and batch (every row holds as many valid labels)."""
    import copy
    import dataclasses

    from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
    from repro_torch.launch.train import E2TRAIN, lm_experiment
    from repro_torch.tasks import get_task
    from repro_torch.training.train_step import make_train_step, train_state_for

    base = lm_experiment(LM_ARCH, smoke=True, steps=4, e2=E2TRAIN["off"])
    if base.train.optimizer != "sgdm":
        fail(f"the reduced LM trains with {base.train.optimizer}, not sgdm")
    tc = base.train
    batch = make_lm_batch(MarkovLMTask(vocab=base.model.vocab_size), tc.seed,
                          0, 0, tc.global_batch, tc.seq_len, "cuda")
    model = get_task("lm").init(base, 0, "cuda")
    out = {}
    for m in (1, 2):
        exp = base.replace(train=dataclasses.replace(tc, microbatches=m))
        state, met = make_train_step(exp)(
            train_state_for(exp, copy.deepcopy(model)), batch)
        out[m] = (float(met["loss"]), dict(state.model.named_parameters()))
    err = max(rel_err(out[2][1][k], p) for k, p in out[1][1].items())
    if not err <= MB_REL:
        fail(f"LM m=2 step differs from its m=1 step by {err:.3g} (limit "
             f"{MB_REL})")
    return {"param_rel_err": err, "loss_m1": out[1][0], "loss_m2": out[2][0]}


def sub_block_launches(main, m):
    """The flash LM path's launches as its executed sub-blocks account for
    them: per executed attention sub-block kernel 7 twice (the forward and
    its recompute), kernels 8 and 9 once, kernels 5 and 6 four times (q, k,
    v, o); per executed MLP sub-block kernels 5 and 6 three times (up, gate,
    down).  The executed sub-blocks come from the SLU execution ratios of
    the ``executed * m`` forward passes; fails unless every count holds."""
    passes = main["executed"] * m
    subs = round(sum(main["slu_exec_ratio"]) * 2 * LM_LAYERS * m)
    got = main["launches"]
    attn = got["flash_bwd_dq"]
    mlp = subs - attn
    want = {"flash_fwd": 2 * attn, "flash_bwd_dq": attn,
            "flash_bwd_dkv": attn, "predictor_matmul": 4 * attn + 3 * mlp,
            "psg_grad_w": 4 * attn + 3 * mlp}
    if any(got[k] != v for k, v in want.items()) or not (
            2 * passes <= min(attn, mlp) <= max(attn, mlp)
            <= LM_LAYERS * passes):
        fail(f"launches {got} do not match {passes} passes of {attn} "
             f"attention and {mlp} MLP sub-blocks: {want}")
    return {"passes": passes, "attention_sub_blocks": attn,
            "mlp_sub_blocks": mlp,
            "launches_per_pass": {k: got[k] / passes for k in want},
            "launches_per_executed_step": {k: got[k] / main["executed"]
                                           for k in want}}


def _log_value(path, prefix, index=0):
    """The ``index``-th number on the last line of a log starting with
    ``prefix`` (``None`` if there is none)."""
    import re
    try:
        lines = [ln for ln in Path(path).read_text().splitlines()
                 if ln.startswith(prefix)]
    except OSError:
        return None
    nums = re.findall(r"[-+]?\d+(?:\.\d+)?", lines[-1]) if lines else []
    return float(nums[index]) if len(nums) > index else None


def resume_check(torch):
    """Phase resume: the JAX package's kill-and-restart through the port's
    launcher on the card (ResNet-74, width 16, batch 128, ``--e2train
    full``, fused convs, ``--ckpt-every 1``, ``RESUME_STEPS`` nominal
    steps): a ``Supervisor`` world of two workers whose rank 1 dies at step
    ``RESUME_KILL``, shrunk to one that resumes from the last intact
    checkpoint; beside it, two uninterrupted runs.  The two uninterrupted
    final checkpoints must be equal bit for bit, and the resumed one equal
    to them.  Checkpoints go to a temporary directory."""
    import shlex
    import subprocess
    import tempfile
    import threading

    import numpy as np

    from repro_torch.ft import faults
    from repro_torch.ft.checkpoint import latest_intact_step
    from repro_torch.ft.supervisor import Supervisor

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def launcher(log, *args):
        argv = [sys.executable, "-m", "repro_torch.launch.train",
                "--depth", str(DEPTH), "--width", str(WIDTH), "--batch",
                str(BATCH), "--e2train", "full", "--fused-conv", "on",
                "--steps", str(RESUME_STEPS), "--ckpt-every", "1", *args]
        return ["sh", "-c", f'exec "$@" > {shlex.quote(log)} 2>&1', "sh",
                *argv]

    with tempfile.TemporaryDirectory() as d:
        dirs = {n: os.path.join(d, n) for n in ("ckpt", "scratch", "ref1",
                                                 "ref2")}
        logs = {n: os.path.join(d, f"{n}.log") for n in ("ref1", "ref2")}
        t0 = time.perf_counter()
        refs = {n: subprocess.Popen(launcher(logs[n], "--ckpt", dirs[n]),
                                    env=env) for n in ("ref1", "ref2")}
        ref_wall = {}

        def reap(name, proc):       # each run's own wall, while others run
            proc.wait(timeout=600)
            ref_wall[name] = time.perf_counter() - t0

        reapers = [threading.Thread(target=reap, args=item)
                   for item in refs.items()]
        for th in reapers:
            th.start()

        def make_cmd(world, rank, resume):
            name = f"world{world}_rank{rank}"
            logs[name] = os.path.join(d, f"{name}.log")
            # the last rank owns the supervised stream and is the one
            # killed first, so the restart resumes from the middle of the
            # run whatever the other rank's pace
            args = ["--ckpt", dirs["ckpt"] if rank == world - 1
                    else dirs["scratch"]]
            if resume is not None:
                args.append("--resume")
            elif world > 1 and rank == world - 1:
                args += ["--ft-kill-at-step", str(RESUME_KILL)]
            return launcher(logs[name], *args)

        sup = Supervisor(make_cmd, world=2, ckpt_dir=dirs["ckpt"], env=env,
                         worker_timeout_s=600)
        attempts = sup.run()
        for th in reapers:
            th.join()
        for n, p in refs.items():
            if p.returncode != 0:
                fail(f"uninterrupted run {n} exited {p.returncode}: "
                     + Path(logs[n]).read_text()[-2000:])
        if [a.world for a in attempts] != [2, 1] or \
                faults.KILL_EXIT_CODE not in attempts[0].exit_codes or \
                attempts[1].resume_step is None:
            fail(f"kill-and-restart went otherwise: {sup.summary()}")
        last = RESUME_STEPS - 1
        if latest_intact_step(dirs["ckpt"]) != last:
            fail(f"the resumed run's last intact step is "
                 f"{latest_intact_step(dirs['ckpt'])}, not {last}")
        final = {n: dict(np.load(os.path.join(dirs[n], f"step_{last:08d}.npz")))
                 for n in ("ckpt", "ref1", "ref2")}

        def differing(a, b):
            if set(a) != set(b):
                fail(f"checkpoint key sets differ: {sorted(set(a) ^ set(b))}")
            return {k: float(np.max(np.abs(a[k].astype(np.float64)
                                           - b[k].astype(np.float64))))
                    for k in a if not np.array_equal(a[k], b[k])}

        refs_diff = differing(final["ref1"], final["ref2"])
        resumed_diff = differing(final["ckpt"], final["ref1"])
        if refs_diff:
            fail(f"two uninterrupted card runs differ in {len(refs_diff)} "
                 f"keys: {sorted(refs_diff.items())[:5]}")
        if resumed_diff:
            fail(f"the resumed run differs from the uninterrupted one in "
                 f"{len(resumed_diff)} keys: {sorted(resumed_diff.items())[:5]}")
        workers = {n: {"wall_s": _log_value(log, "wall"),
                       "saves": _log_value(log, "checkpoints:"),
                       "save_ms_each": _log_value(log, "checkpoints:", 1),
                       "resumed_from": _log_value(log, "resumed from")}
                   for n, log in logs.items()}
        return {"attempts": [a.to_dict() for a in attempts],
                "resume_step": attempts[1].resume_step,
                "keys": len(final["ref1"]), "bitwise_equal": True,
                "uninterrupted_process_wall_s": ref_wall, "workers": workers,
                "card": card_line()}


# ---------------------------------------------------------------------------
# phase 11: the chunked loop (one captured CUDA graph, SLU on the card)
# ---------------------------------------------------------------------------

CHUNK_K = 4
CHUNK_EXECUTED = 16         # executed steps of the fused path in each mode
CHUNK_SMALL_EXECUTED = 8    # the im2col, PSG-off and LM paths


def nominal_steps(executed: int, smd: bool = True) -> int:
    """The nominal steps (SMD seed 0, p = 0.5) that execute ``executed``."""
    from repro_torch.core.smd import smd_keep_host

    steps, kept = 0, 0
    while kept < executed:
        kept += smd_keep_host(0, steps, 0.5) if smd else 1
        steps += 1
    return steps


def same_runs(torch, a, b, what: str) -> dict:
    """Fail unless trainers ``a`` (per step) and ``b`` (chunked) agree bit
    for bit: losses, SLU flags, counts, parameters, buffers, SWA."""
    for key in ("loss", "total_loss", "slu_executed"):
        if [h[key] for h in a.history] != [h[key] for h in b.history]:
            fail(f"{what}: {key} differs between the per-step and the "
                 f"chunked loop: {[h[key] for h in a.history]} against "
                 f"{[h[key] for h in b.history]}")
    counts = [(t.executed_steps, t.dropped_steps, t.state.step)
              for t in (a, b)]
    if counts[0] != counts[1]:
        fail(f"{what}: executed/dropped/step {counts[0]} against {counts[1]}")
    tensors = []
    for name, fn in (("parameters", "named_parameters"),
                     ("buffers", "named_buffers")):
        pa = dict(getattr(a.state.model, fn)())
        pb = dict(getattr(b.state.model, fn)())
        bad = [n for n in pa if not torch.equal(pa[n], pb[n])]
        if bad:
            fail(f"{what}: {len(bad)} {name} differ, e.g. {bad[:3]}")
        tensors.append(len(pa))
    if a.state.swa is not None:
        bad = [n for n, v in a.state.swa["avg"].items()
               if not torch.equal(v, b.state.swa["avg"][n])]
        if bad or a.state.swa["count"] != b.state.swa["count"]:
            fail(f"{what}: the SWA average differs ({bad[:3]})")
    return {"bitwise_equal": True, "parameters": tensors[0],
            "buffers": tensors[1], "executed": a.executed_steps,
            "dropped": a.dropped_steps}


def slu_decide_check(torch, GC):
    """``slu_decide`` against its plain version: at the main path's shape
    (0-d), on 10**6 random (u, p) pairs and on the boundary cases (p = u,
    one ulp either side, 0, 1, the ``min_keep_prob`` floor, NaN), forced
    and not; timed at the main path's shape beside ``torch.lt``."""
    from repro_torch.core.config import SLUConfig

    gen = torch.Generator(device="cuda").manual_seed(11)
    u = torch.rand(10 ** 6, device="cuda", generator=gen)
    p = torch.rand(10 ** 6, device="cuda", generator=gen)
    ub = torch.rand(64, device="cuda", generator=gen)
    one, zero = torch.ones_like(ub), torch.zeros_like(ub)
    floor = torch.full_like(ub, SLUConfig().min_keep_prob)
    pb = [ub, torch.nextafter(ub, one), torch.nextafter(ub, zero), zero, one,
          floor, torch.full_like(ub, float("nan"))]
    cases = [(u, p)] + [(ub, q) for q in pb] + [(floor, floor)]
    worst = 0.0
    for uu, pp in cases:
        for force in (False, True):
            got = GC.slu_decide(uu, pp, force)
            want = GC.slu_decide_plain(uu, pp, force)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"slu_decide differs from its plain version (force "
                     f"{force}) in {int((got != want).sum())} of "
                     f"{got.numel()} elements")
            worst = max(worst, float((got - want).abs().max()))
    u0, p0 = u[0].clone(), p[0].clone()
    if not torch.equal(GC.slu_decide(u0, p0), GC.slu_decide_plain(u0, p0)):
        fail("slu_decide differs from its plain version at the 0-d shape")
    timed = {"ms": time_ms(torch, lambda: GC.slu_decide(u0, p0)),
             "device_ms": device_ms(torch, lambda: GC.slu_decide(u0, p0)),
             "plain_ms": time_ms(torch,
                                 lambda: GC.slu_decide_plain(u0, p0)),
             "library_ms": time_ms(torch, lambda: torch.lt(u0, p0)),
             "library_device_ms": device_ms(torch, lambda: torch.lt(u0, p0)),
             "ms_1e6": time_ms(torch, lambda: GC.slu_decide(u, p)),
             "bound_ms_1e6": 1e3 * 12 * u.numel() / HBM_BYTES_PER_S}
    # u and p read, the flag written, 4 bytes each, at the main path's shape
    timed["bound_ms"] = 1e3 * 12 / HBM_BYTES_PER_S
    return {"max_abs_err": worst, "pairs": u.numel(),
            "boundary_cases": len(cases) - 1, **timed}


def profile_run(torch, trainer, executed: int) -> dict:
    """The next nominal steps that execute ``executed`` steps under
    torch.profiler: the device's busy time (union of device events) and
    idle share over the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps, kept = 0, 0
    while kept < executed:
        kept += trainer.keeps(trainer.state.step + steps)
        steps += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for e in dev:
        t0, t1 = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    busy = busy_us / 1e3 if dev else None
    return {"executed": executed, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if dev else None}


def chunked_pair(torch, build, mods, kernels, executed, what, smd=True,
                 profile=False, gated=None):
    """The same nominal steps from the same init through the per-step loop
    and through ``Trainer(chunk_steps=CHUNK_K)``, compared bit for bit, with
    every launch counter zeroed just before the chunked run and read just
    after (the launches of the warm-up and of the capture: a replay runs
    the captured kernels without their wrappers).  A chunked step's time is
    its chunk's interval on the device's clock after the first chunk
    (``Trainer`` ``wall_s``); the per-step loop's excludes the batch draw,
    as in phase 6.  The captured graph must hold IF nodes where the model
    has gated blocks under SLU (``gated``, default ``smd``) and none
    where it has none."""
    import gc
    steps = nominal_steps(executed, smd)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per = build(steps, 1)
    per.run(steps)
    torch.cuda.synchronize()
    per_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    chunked = build(steps, CHUNK_K)
    reset_all(mods)
    chunked.run(steps)
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{what}: kernel {name} was not launched in the chunked run")
    out = same_runs(torch, per, chunked, what)
    cf = chunked._chunk_fn
    gated = smd if gated is None else gated
    if cf.graph is None or (gated and cf.cond.nodes == 0):
        fail(f"{what}: the chunked run holds no graph with IF nodes")
    if gated is False and cf.cond.nodes:
        fail(f"{what}: {cf.cond.nodes} IF nodes in a model without gates")
    later = chunked.history[CHUNK_K:]
    dev = [h["device_s"] for h in later if "device_s" in h]
    ph = per.history
    out.update({
        "nominal_steps": steps, "launches": launches,
        "per_step_ms_per_executed_step_first": 1e3 * ph[0]["wall_s"],
        "per_step_ms_per_executed_step":
            1e3 * sum(h["wall_s"] for h in ph[1:]) / (len(ph) - 1),
        "per_step_peak_memory_gb": per_peak,
        "chunked_ms_per_executed_step_first_chunk":
            1e3 * sum(h["wall_s"] for h in chunked.history[:CHUNK_K])
            / CHUNK_K,
        "chunked_ms_per_executed_step":
            1e3 * sum(h["wall_s"] for h in later) / len(later),
        "chunked_device_ms_per_replayed_step": 1e3 * sum(dev) / len(dev),
        "chunked_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "warmup_step_s": cf.warmup_s, "capture_s": cf.capture_s,
        "if_nodes": cf.cond.nodes,
        "losses": [h["loss"] for h in chunked.history]})
    if profile:
        out["chunked_profile"] = profile_run(torch, chunked, 2 * CHUNK_K)
        out["per_step_profile"] = profile_run(torch, per, 2 * CHUNK_K)
        same_runs(torch, per, chunked, f"{what} (after the profiled runs)")
    return per, chunked, out


def release(trainer) -> None:
    """Drop a chunked trainer's graph and its bodies' memory pool."""
    trainer._chunk_fn.release()


def sync_free_chunk(torch, trainer) -> dict:
    """One more chunk through the trainer's captured graph under
    ``torch.cuda.set_sync_debug_mode("error")``: a read back to the host
    anywhere in the chunk raises."""
    import numpy as np

    from repro_torch.training.loop import stack_batches
    st = trainer.state.step
    batches = stack_batches([trainer.make_host_batch(st + i, 0)
                             for i in range(CHUNK_K)])
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.state, met = trainer._chunk_fn(
            trainer.state, batches, np.ones(CHUNK_K, np.int64))
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    losses = met["loss"].tolist()
    if not all(math.isfinite(x) for x in losses):
        fail(f"the sync-checked chunk gave losses {losses}")
    return {"steps": CHUNK_K, "losses": losses, "sync_debug_mode": "error"}


def chunked_cli(torch) -> dict:
    """``launch.train --chunk-steps 4`` on the card for a few steps."""
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--depth",
         str(DEPTH), "--steps", "16", "--chunk-steps", str(CHUNK_K),
         "--log-every", "4"], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=env)
    if proc.returncode != 0 or f"chunked K={CHUNK_K}" not in proc.stdout:
        fail(f"launch.train --chunk-steps {CHUNK_K} exited "
             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("throughput:"))
    ms = re.search(r"([0-9.]+) ms per executed step after", line)
    return {"wall_s": time.perf_counter() - t0, "throughput_line": line,
            "ms_per_executed_step": float(ms.group(1)) if ms else None}


def chunked_check(torch, mods, GC):
    """Phase 11: the chunked loop on the card."""
    from repro_torch.data.synthetic import host_image_batch
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch.train import (E2TRAIN, build_lm_trainer,
                                          build_trainer, experiment)
    from repro_torch.training import evaluate

    versions = GC.cuda_versions()
    if min(versions.values()) < 12040:
        fail(f"conditional graph nodes need CUDA 12.4, have {versions}")
    decide = slu_decide_check(torch, GC)
    print(json.dumps({"phase": "slu_decide", **decide}), flush=True)
    task = evaluate.data_task(experiment(DEPTH, WIDTH, BATCH, 1))
    host_image_batch(task, 0, 0, 0, BATCH, pin=True)    # the pinned pool
    t0 = time.perf_counter()
    for step in range(1, 4):
        host_image_batch(task, 0, step, 0, BATCH, pin=True)
    host_batch_ms = 1e3 * (time.perf_counter() - t0) / 3
    fused_per, fused, main = chunked_pair(
        torch, lambda steps, k: build_trainer(DEPTH, WIDTH, BATCH, steps,
                                              device="cuda", chunk_steps=k),
        mods, list(K.LAUNCHES) + ["slu_decide"], CHUNK_EXECUTED,
        "fused ResNet-74", profile=True)
    main["host_batch_ms"] = host_batch_ms
    main["sync_free_chunk"] = sync_free_chunk(torch, fused)
    release(fused)
    del fused_per, fused
    _, chunked, im2col = chunked_pair(
        torch, lambda steps, k: build_trainer(DEPTH, WIDTH, BATCH, steps,
                                              device="cuda", chunk_steps=k,
                                              fused_conv=False),
        mods, list(PM.LAUNCHES) + ["slu_decide"], CHUNK_SMALL_EXECUTED,
        "im2col ResNet-74")
    release(chunked)
    _, chunked, off = chunked_pair(
        torch, lambda steps, k: build_trainer(DEPTH, WIDTH, BATCH, steps,
                                              device="cuda", chunk_steps=k,
                                              e2=E2TRAIN["off"]),
        mods, [], CHUNK_SMALL_EXECUTED, "PSG-off ResNet-74", smd=False)
    release(chunked)
    del chunked
    _, chunked, lm = chunked_pair(
        torch, lambda steps, k: build_lm_trainer(
            LM_ARCH, num_layers=LM_LAYERS, batch=LM_BATCH, seq=LM_SEQ,
            steps=steps, device="cuda", fused_attention=True, chunk_steps=k),
        mods, list(PM.LAUNCHES) + list(FA.LAUNCHES) + ["slu_decide"],
        CHUNK_SMALL_EXECUTED, "flash qwen2.5-3b")
    # remat="block": kernel 7 runs in each attention sub-block's forward and
    # again in its backward's recompute, so the eager warm-up launches it
    # twice per executed attention sub-block and the capture twice per
    # layer, the recompute inside the backward's IF node
    warm = chunked.history[0]["slu_executed"]
    want = 2 * int(sum(warm[0::2])) + 2 * LM_LAYERS
    if lm["launches"]["flash_fwd"] != want:
        fail(f"flash_fwd launched {lm['launches']['flash_fwd']} times in the "
             f"chunked LM run, not {want}: the recompute is not where the "
             "captured backward should hold it")
    lm["flash_fwd_launches_expected"] = want
    release(chunked)
    del chunked
    cli = chunked_cli(torch)
    return {"cuda_versions": versions, "slu_decide": decide,
            "fused": main, "im2col": im2col, "psg_off": off, "lm": lm,
            "cli": cli, "card": card_line()}


MBV2_BATCH = 128
MBV2_EXECUTED = 4           # executed steps of MobileNetV2's fused main path
# kernel launches per executed step: 36 conv sites, the stem's image has no
# input gradient
MBV2_LAUNCHES = {"conv_fwd": 36, "conv_grad_x": 35,
                 "conv_grad_w_predictor": 36, "conv_grad_w": 36}
# eval-mode logits, card against CPU: plain fp32 products through 52
# BatchNorms and 17 depthwise convs, summed in other orders (measured 6e-7)
MBV2_EVAL_REL = 1e-4
# with PSG on, one flipped 8-bit code reaches every later code: a 1e-6
# relative change of the image moves the step's loss by 4.3% at batch 2 on
# the CPU (tests/test_torch_mobilenet.py), so only the loss is compared
MBV2_PSG_LOSS_REL = 0.05
# with PSG off each parameter's update within 0.1 of its norm, or within
# 1e-5 where the gradient is zero up to rounding (each bn3.bias): the fp32
# gradient's own conditioning at small batch (tests/test_torch_mobilenet.py)
MBV2_UPDATE_REL, MBV2_UPDATE_ABS = 0.1, 1e-5


def kernel_totals(tot):
    """Each conv kernel's summed times over a step's sites with its bound."""
    out = {}
    for name, t in tot.items():
        bytes_ms = 1e3 * t["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * t["ops_s"]
        out[name] = {k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                        "library_ms", "library_device_ms",
                                        "max_abs_err")}
        out[name].update(bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations")
    return out


def depthwise_times(torch):
    """MobileNetV2's 17 depthwise convs at batch 128 (``models/resnet.
    depthwise``, plain PyTorch, as the JAX package computes them outside
    any kernel): forward against ``F.conv2d(groups=C)`` on the same
    values within ``FP32_REL``, and forward plus backward timed beside that
    library call, summed over the blocks."""
    import torch.nn.functional as F

    from repro_torch.core.cost import mbv2_layout
    from repro_torch.models.resnet import depthwise

    g = torch.Generator(device="cuda").manual_seed(3)
    hw, out = 32, {"ms": 0.0, "library_ms": 0.0, "max_rel_err": 0.0}
    for _, hidden, _, stride, _ in mbv2_layout():
        x = torch.randn(MBV2_BATCH, hw, hw, hidden, device="cuda",
                        generator=g, requires_grad=True)
        w = torch.randn(9, hidden, device="cuda", generator=g,
                        requires_grad=True)
        gy = torch.randn(MBV2_BATCH, hw // stride, hw // stride, hidden,
                         device="cuda", generator=g)
        w4 = w.detach().t().reshape(hidden, 1, 3, 3).requires_grad_(True)

        def lib():
            return F.conv2d(x.permute(0, 3, 1, 2), w4, stride=stride,
                            padding=1, groups=hidden).permute(0, 2, 3, 1)

        err = rel_err(depthwise(x, w, stride), lib())
        if not err <= FP32_REL:
            fail(f"depthwise at {hw}x{hidden}, stride {stride}: {err:.3g} "
                 "of max |y| from F.conv2d(groups=C)")
        out["max_rel_err"] = max(out["max_rel_err"], err)
        out["ms"] += time_ms(torch, lambda: torch.autograd.backward(
            depthwise(x, w, stride), gy))
        out["library_ms"] += time_ms(torch, lambda: torch.autograd.backward(
            lib(), gy))
        hw //= stride
    return out


def mobilenet_reference_check(torch):
    """Phase 12: one MobileNetV2 train step at batch 8 on the card and on
    the CPU from the same init and batch.  PSG off (``sgdm``, fp32): the
    loss within 1e-4 and each parameter's update within
    ``MBV2_UPDATE_REL`` of its norm or ``MBV2_UPDATE_ABS``.  ``--e2train full`` (fused kernels on
    the card): the loss within ``MBV2_PSG_LOSS_REL``, and the share of
    equal update signs reported."""
    from repro_torch.data.synthetic import GaussianImageTask, make_image_batch
    from repro_torch.launch.train import E2TRAIN, experiment
    from repro_torch.training.train_step import init_train_state, make_train_step

    batch = make_image_batch(GaussianImageTask(snr=2.0), 0, 0, 0, 8, "cpu")
    out = {}
    for preset in ("off", "full"):
        exp = experiment(0, 0, 8, 4, e2=E2TRAIN[preset], cnn="mobilenetv2")
        run = {}
        for dev in ("cpu", "cuda"):
            state = init_train_state(exp, seed=0, device=dev)
            p0 = {k: p.detach().cpu().clone()
                  for k, p in state.model.named_parameters()}
            state, met = make_train_step(exp)(
                state, {k: v.to(dev) for k, v in batch.items()})
            run[dev] = ({k: float(v) for k, v in met.items()},
                        {k: p.detach().cpu() - p0[k]
                         for k, p in state.model.named_parameters()})
        (mc, uc), (mg, ug) = run["cpu"], run["cuda"]
        loss_rel = abs(mc["loss"] - mg["loss"]) / abs(mc["loss"])
        floor = MBV2_UPDATE_ABS / MBV2_UPDATE_REL
        worst = max(float((ug[k] - uc[k]).norm()
                          / uc[k].norm().clamp_min(floor)) for k in uc)
        signs = sum(int((ug[k].sign() == uc[k].sign()).sum()) for k in uc) \
            / sum(u.numel() for u in uc.values())
        if preset == "off" and not (loss_rel <= 1e-4
                                    and worst <= MBV2_UPDATE_REL):
            fail(f"MobileNetV2 PSG-off step: loss {mg['loss']} against the "
                 f"CPU's {mc['loss']}, worst update {worst:.3g} of its norm")
        if preset == "full" and not loss_rel <= MBV2_PSG_LOSS_REL:
            fail(f"MobileNetV2 PSG step: loss {mg['loss']} against the "
                 f"CPU's {mc['loss']}")
        out[preset] = {"loss_cpu": mc["loss"], "loss_cuda": mg["loss"],
                       "loss_rel": loss_rel, "worst_update_rel": worst,
                       "update_sign_agreement": signs,
                       "fallback_cpu": mc.get("psg_fallback_ratio"),
                       "fallback_cuda": mg.get("psg_fallback_ratio")}
    return out


def mobilenet_cli(torch) -> dict:
    """``launch.train --cnn mobilenetv2`` on the card for a few steps."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--cnn",
         "mobilenetv2", "--steps", "6"], capture_output=True, text=True,
        timeout=600, cwd=ROOT, env=env)
    if proc.returncode != 0 or "energy report: mobilenetv2" not in \
            proc.stdout or "held-out accuracy" not in proc.stdout:
        fail(f"launch.train --cnn mobilenetv2 exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("model ", "throughput:", "final loss"))]
    return {"wall_s": time.perf_counter() - t0, "lines": lines}


def bench_cnn_check(torch, mods) -> dict:
    """``launch.bench_cnn --fast --steps 8`` in this process, every counter
    zeroed before and read after: the reference's three rows, and the conv
    kernels launched by its E2-Train row."""
    from repro_torch.kernels import conv as K
    from repro_torch.launch import bench_cnn

    reset_all(mods)
    t0 = time.perf_counter()
    rows = bench_cnn.main(["--fast", "--steps", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    names = [r.split(",", 1)[0] for r in rows]
    if names != ["tab4/resnet14_smb", "tab4/resnet14_e2train",
                 "tab4/mobilenetv2_fwd"] or \
            not rows[2].endswith("logits_finite=True"):
        fail(f"bench_cnn rows: {rows}")
    for name in K.LAUNCHES:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by bench_cnn")
    return {"rows": rows, "launches": launches, "wall_s": wall}


def mobilenet_check(torch, mods):
    """Phase 12: MobileNetV2 (published widths, batch 128) on the card."""
    import gc

    from repro_torch.configs.paper_cnns import mobilenet_conv_shapes
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch.train import build_trainer
    from repro_torch.training.train_step import eval_params

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sites = mobilenet_conv_shapes(MBV2_BATCH, unique=False)
    tot, details = check_kernels(torch, K, sites,
                                 mobilenet_conv_shapes(MBV2_BATCH),
                                 uncounted=False)
    geometries = {"rows": details, "totals": kernel_totals(tot),
                  "sites": len(sites), "card": card_line()}
    geometries["depthwise"] = depthwise_times(torch)
    print(json.dumps({"phase": "mobilenetv2_geometries",
                      "totals": geometries["totals"],
                      "depthwise": geometries["depthwise"]}), flush=True)
    ref = mobilenet_reference_check(torch)
    print(json.dumps({"phase": "mobilenetv2_reference", **ref}), flush=True)

    def build(steps, k=1, **kw):
        return build_trainer(batch=MBV2_BATCH, steps=steps, device="cuda",
                             cnn="mobilenetv2", chunk_steps=k, **kw)

    trainer, main, prof = run_path(torch, "mobilenetv2_main_path", build,
                                   mods, list(K.LAUNCHES),
                                   absent=["slu_decide"],
                                   execute=MBV2_EXECUTED)
    per_step = main["launches_per_executed_step"]
    if any(per_step[n] != c for n, c in MBV2_LAUNCHES.items()):
        fail(f"MobileNetV2 launches per executed step {per_step}, not "
             f"{MBV2_LAUNCHES}")
    exp = trainer.exp
    predict = {"live": card_against_cpu(torch, exp, trainer.state.model,
                                        "MobileNetV2 live weights",
                                        MBV2_EVAL_REL),
               "swa": card_against_cpu(torch, exp,
                                       eval_params(trainer.state, exp),
                                       "MobileNetV2 SWA weights",
                                       MBV2_EVAL_REL)}
    print(json.dumps({"phase": "mobilenetv2_predict", **predict}), flush=True)
    del trainer
    im2col, im2col_prof = run_path(
        torch, "mobilenetv2_im2col_main_path",
        lambda steps: build(steps, fused_conv=False), mods,
        list(PM.LAUNCHES), absent=list(K.LAUNCHES), execute=3)[1:]
    per, chunked, pair = chunked_pair(
        torch, build, mods, list(K.LAUNCHES), 2 * CHUNK_K,
        "fused MobileNetV2", profile=True, gated=False)
    pair["sync_free_chunk"] = sync_free_chunk(torch, chunked)
    release(chunked)
    del per, chunked
    print(json.dumps({"phase": "mobilenetv2_chunked",
                      **{k: v for k, v in pair.items() if k != "losses"}}),
          flush=True)
    cli = mobilenet_cli(torch)
    print(json.dumps({"phase": "mobilenetv2_cli", **cli}), flush=True)
    bench = bench_cnn_check(torch, mods)
    print(json.dumps({"phase": "bench_cnn", **bench}), flush=True)
    return geometries, {
        "reference": ref, "main_path": main, "profile": prof,
        "predict": predict, "im2col_main_path": im2col,
        "im2col_profile": im2col_prof, "chunked": pair, "cli": cli,
        "bench_cnn": bench, "launches_expected": MBV2_LAUNCHES,
        "limits": {"eval": MBV2_EVAL_REL, "psg_loss": MBV2_PSG_LOSS_REL,
                   "update": MBV2_UPDATE_REL},
        "seconds": time.perf_counter() - t_start, "card": card_line()}


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
    from repro_torch.kernels import graph_cond as GC
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.kernels import quant as Q
    from repro_torch.launch.train import E2TRAIN, build_lm_trainer, build_trainer
    t0 = time.perf_counter()
    build.build(list(build.SOURCES), verbose=True)
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)
    sass = sass_check(build)
    print(json.dumps({"phase": "sass", **sass}), flush=True)

    shapes_all = resnet_conv_shapes(DEPTH, WIDTH, BATCH, unique=False)
    tot, details = check_kernels(torch, K, shapes_all,
                                 resnet_conv_shapes(DEPTH, WIDTH, BATCH))
    for row in details:
        print(json.dumps(row), flush=True)
    m = get_experiment(LM_ARCH).model
    sites = lm_matmul_sites(m.d_model, m.num_heads, m.num_kv_heads,
                            m.resolved_head_dim, m.d_ff, LM_LAYERS)
    im2col = {}
    for c in shapes_all:
        im2col[c.im2col] = im2col.get(c.im2col, 0) + 1
    ptot, pdetails, im2col_tot = check_psg_matmul_kernels(
        torch, PM, sites, (200, 328), LM_BATCH * LM_SEQ, im2col)
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
    lm_ref = lm_reference_check(torch, fused_attention=False)
    print(json.dumps({"phase": "lm_reference", **lm_ref}), flush=True)
    lm_flash_ref = lm_reference_check(torch, fused_attention=True)
    print(json.dumps({"phase": "lm_flash_reference", **lm_flash_ref}),
          flush=True)

    trainer, main, prof = run_path(
        torch, "main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda"),
        mods, list(K.LAUNCHES))
    ev = eval_check(torch, trainer)
    print(json.dumps({"phase": "eval", **ev}), flush=True)
    del trainer
    im2col_main, im2col_prof = run_path(
        torch, "im2col_main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda",
                                    fused_conv=False),
        mods, list(PM.LAUNCHES), absent=list(K.LAUNCHES), execute=3)[1:]
    off_main, off_prof = run_path(
        torch, "psg_off_main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda",
                                    e2=E2TRAIN["off"]),
        mods, [], absent=[n for mod in mods for n in mod.LAUNCHES],
        execute=3, smd=False)[1:]
    lm_main, lm_prof = run_path(
        torch, "lm_main_path",
        lambda steps: build_lm_trainer(LM_ARCH, num_layers=LM_LAYERS,
                                       batch=LM_BATCH, seq=LM_SEQ,
                                       steps=steps, device="cuda",
                                       fused_attention=False),
        mods, list(PM.LAUNCHES))[1:]
    lm_trainer, lm_flash_main, lm_flash_prof = run_path(
        torch, "lm_flash_main_path",
        lambda steps: build_lm_trainer(LM_ARCH, num_layers=LM_LAYERS,
                                       batch=LM_BATCH, seq=LM_SEQ,
                                       steps=steps, device="cuda",
                                       fused_attention=True),
        mods, list(PM.LAUNCHES) + list(FA.LAUNCHES))
    lm_ev = lm_eval_check(torch, lm_trainer)
    print(json.dumps({"phase": "lm_eval", **lm_ev}), flush=True)
    del lm_trainer
    lm_mb_main, lm_mb_prof = run_path(
        torch, "lm_microbatch_main_path",
        lambda steps: build_lm_trainer(LM_ARCH, num_layers=LM_LAYERS,
                                       batch=LM_MICRO * LM_BATCH, seq=LM_SEQ,
                                       steps=steps, device="cuda",
                                       fused_attention=True,
                                       microbatches=LM_MICRO),
        mods, list(PM.LAUNCHES) + list(FA.LAUNCHES), execute=3)[1:]
    lm_mb_launches = {"lm_flash_main_path": sub_block_launches(lm_flash_main, 1),
                      "lm_microbatch_main_path": sub_block_launches(
                          lm_mb_main, LM_MICRO)}
    print(json.dumps({"phase": "lm_microbatch_launches", **lm_mb_launches}),
          flush=True)
    mb_ref = {"resnet": reference_check(torch, microbatches=2),
              "lm": lm_reference_check(torch, fused_attention=True,
                                       microbatches=2),
              "lm_sgdm_m2_vs_m1": lm_microbatch_equivalence(torch)}
    print(json.dumps({"phase": "microbatch_reference", **mb_ref}), flush=True)
    resume = resume_check(torch)
    print(json.dumps({"phase": "resume", **resume}), flush=True)
    chunked = chunked_check(torch, mods + (GC,), GC)
    print(json.dumps({"phase": "chunked", **{k: v for k, v in chunked.items()
                                             if k != "slu_decide"}}),
          flush=True)
    mbv2_geometries, mbv2 = mobilenet_check(torch, mods + (GC,))

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
    d = chunked["slu_decide"]
    kernels.append({
        "name": "slu_decide", "route": "cuda", "source": GRAPH_COND_SOURCE,
        "replaces": SLU_DECISION, "launches":
            chunked["fused"]["launches"]["slu_decide"],
        "max_abs_err": d["max_abs_err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": "bytes", "library_ms": d["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "geometries": details,
         "sass": sass, "lm_geometries": pdetails,
         "im2col_psg_matmul_totals": im2col_tot, "flash_geometries": fdetails,
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
         "lm_flash_profile": lm_flash_prof, "eval": ev, "lm_eval": lm_ev,
         "lm_microbatch_main_path": lm_mb_main,
         "lm_microbatch_profile": lm_mb_prof,
         "lm_microbatch_launches": lm_mb_launches,
         "microbatch_reference": mb_ref, "resume": resume,
         "chunked": chunked, "mobilenetv2_geometries": mbv2_geometries,
         "mobilenetv2": mbv2, "kernels": kernels,
         "device_ms": {n: tot[n]["device_ms"] for n in REPLACES},
         "library_device_ms": {n: tot[n]["library_device_ms"]
                               for n in REPLACES},
         "conv_fwd_bound_fp32_ms": tot["conv_fwd"]["bound_fp32_ms"],
         "conv_grad_x_bound_fp32_ms": tot["conv_grad_x"]["bound_fp32_ms"],
         "flash_bwd_dq_bound_fp32_ms": tot["flash_bwd_dq"]["bound_fp32_ms"],
         "quantize_bound_single_read_ms":
             tot["quantize"]["bound_single_read_ms"],
         "note": "conv kernel times are summed over the conv sites of one "
                 "ResNet-74 batch-128 step (device_ms, for every kernel: "
                 "the same calls each replayed from a CUDA graph, device "
                 "time alone; library_device_ms the same for the library "
                 "calls; "
                 "kernel 1's bound counts its int8 codes in and fp32 y out "
                 "and its operations at the int8 rate, "
                 "conv_fwd_bound_fp32_ms the fp32 operands at the fp32 "
                 "rate; kernel 2's likewise its int16 g codes and int8 "
                 "weight codes in and fp32 dx out, "
                 "conv_grad_x_bound_fp32_ms the fp32 kernel's), PSG matmul "
                 "kernel times over the "
                 "weight-matmul sites of one qwen2.5-3b 8-layer step at "
                 "N = 8192 tokens (im2col_psg_matmul_totals: the same two "
                 "kernels over the 75 im2col sites of one ResNet-74 "
                 "batch-128 step), flash kernel times over the attention "
                 "sites of one qwen2.5-3b 8-layer step at batch 2 x 4096 "
                 "(kernel 7 twice per layer; its bf16 bound counts q k^T "
                 "and the two P v products of the split P at the bf16 "
                 "rate; kernel 8's q k^T, dO v^T and the three dS k "
                 "products of the split dS at the bf16 rate, "
                 "flash_bwd_dq_bound_fp32_ms with dS k at the fp32 rate), "
                 "with every block executed; "
                 "quantize times over one call at its main path's input, "
                 "the microbenchmark's x (2048 x 1024 fp32, 8 bits), the "
                 "scale's reduction included; its bound counts a second "
                 "read of x where x is above the 50 MB L2 "
                 "(quantize_bound_single_read_ms: one read, the bound "
                 "before the reduction was a kernel); its launches are the "
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
