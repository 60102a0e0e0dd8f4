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
   ``launch.bench_cnn --fast --steps 8``;
13. paper_benches: the paper's experiments through the driver's benches
   (``launch/bench_run``), in this process, in fast mode at an eighth of
   the reference's nominal steps (``PAPER_STEPS``): ``smd``, ``slu``,
   ``psg``, ``e2train``, ``convergence`` and ``throughput``, each
   with every launch counter zeroed before and read after (kernels 5-9
   launched by the PSG benches on the bench LM, no kernel by the others);
   the row names are the reference's (``PAPER_ROWS``), every derived field
   parses, ``tab2/psg`` carries its measured fallback and ``tab3/*`` the
   published savings; first kernels 5-9 against their plain versions on
   the operands of one ``tab2/fixed8`` step (tau 0) and one ``tab2/psg``
   step at the bench LM's 28 weight-matmul sites and 4 attention
   backwards (``bench_lm_kernels_check``, its tolerances stated there);
   then ``--json`` (ResNet-14 over 12 steps, the record's fast run;
   kernels 1-4 launched; the Table 3 sweep
   within ``TABLE3_REL`` of ``TABLE3_*``, the JAX package's values) and
   ``--json-throughput`` into a temporary directory; then the CPU: a CPU
   ``run_lm`` of every configuration that draws SMD drops without PSG (a
   PSG one's drops are the same draws, and its CPU re-run the longest)
   and of the energy record's run (worker processes) must execute the
   card's steps,
   the SMD rows' ``energy_ratio`` follows, and ``tab2/sgd32``'s first 8
   losses from the card's initial weights on the CPU are within
   ``SGD32_REL`` of the card's; recorded: the device's idle share of a
   profiled ``sgd32`` and ``psg`` step;
14. dense_archs: llama3-8b (2 x 4096, flash), starcoder2-15b (4 x 4096 in
   its config's 4 microbatches, 48 heads on 4 kv heads, flash) and
   h2o-danube-3-4b (1 x 16384, a 4096-token sliding window, query-chunked
   softmax, kernels 7-9 absent) at their published widths, 2 layers (cut
   from 4 for the script's time), ``--e2train full``, ``remat="block"``
   (``dense_archs_check``): kernels
   5-6 at each one's weight-matmul geometries (dout 960 among them) and
   7-9 at its attention geometry against their plain versions, timed, not
   counted in the ``kernels`` line (kernel 9 also bit for bit on integer
   inputs at g = 12); a reduced step on the card against the CPU (the
   windowed model also query-chunked at 8,492 tokens); each main path as
   in 7, its launches checked against its executed sub-blocks; then the
   fault-injection record (``launch/bench_ft``) on the card, every fault
   recovered, without its kill-and-restart (phase 18 kills and restarts
   the launcher on the card, bit for bit);
15. encdec_vlm_moe: whisper-small (encoder-decoder, 12 + 12 layers, 8 x
   4096 tokens + 8 x 1500 frames), phi-3-vision-4.2b (VLM, 2 layers (cut
   from 4), 2 x 4096 tokens + 576 patches, head dim 96) and
   deepseek-moe-16b (2 layers (cut from 4),
   2 x 4096, 64 experts top-6 + 2 shared) at their published widths,
   ``--e2train full``, ``remat="block"`` (``encdec_vlm_moe_check``):
   kernels 5-6 bit for bit at the MoE models' expert geometries (960 rows
   of deepseek's, 1,280 of grok-1-314b's, one launch an expert) and on an
   expert with no token, kernels 7-9 at phi-3-vision's attention (hd 96)
   and whisper-small's decoder (g = 1) with phase 4's limits (kernel 9
   also bit for bit on integer inputs at hd 96), timed, not counted in
   the ``kernels`` line; a reduced step of each of the four archs on the
   card against the CPU; each main path as in 7, its launches checked
   against its executed sub-blocks (an MoE sub-block's three per expert,
   the encoder's per pass); grok-1-314b's one layer is not trained: its
   parameters and optimizer state, reckoned from its config
   (``reckoned_state_bytes``), do not fit the card; last, the reduced
   deepseek-moe-16b and whisper-small through the chunked loop (K = 4,
   gated sub-blocks as IF nodes) against the per-step loop bit for bit,
   losses, the MoE aux loss (0 where an IF node skipped the MoE) and SLU
   flags included;
16. ssm: the SSM family (``ssm_check``): each mixer at full width (Mamba2
   at zamba2-1.2b's, mLSTM and sLSTM at xlstm-350m's), 1 x 4096 tokens,
   fp32, forward and input gradient on the card against the CPU within
   ``MIXER_REL`` (the chaotic sLSTM over its first ``SLSTM_SEQ`` tokens),
   each timed; kernels 5-6 at zamba2-1.2b's shared-attention projections
   and 7-9 at its attention geometry with phase 4's limits, timed, not
   counted; a reduced step of xlstm-350m and of zamba2-1.2b at 512 tokens
   (two chunks) on the card against the CPU; the main paths (``SSM_PATHS``,
   ``--e2train full``, ``remat="block"``, bf16, two executed steps):
   zamba2-1.2b's first unit of 19 blocks (of its 38), 4 x 2048 in its 4
   microbatches, its kernel 5-9 launches equal to its one shared-attention
   call a microbatch, and xlstm-350m's unit of 4 layers at 4 x 1024 (its
   sLSTM loops over the tokens on the host), launching none of
   the ten kernels, each with its reckoned
   state and profiled (device events only); last, both reduced archs
   through the chunked loop against the per-step loop bit for bit, with
   IF nodes on the Mamba2 and LSTM sub-blocks and none on the shared
   attention;
17. serving (``serving_check``): every arch of ``ARCH_IDS`` reduced, fp32,
   ``prefill_to_state`` and 4 greedy ``decode_step``s on the card against
   the CPU (whisper against its encoder's memory, phi-3-vision with its
   patches); then ``ServeEngine`` at full width and full depth, bf16,
   greedy (``serve_paths``): qwen2.5-3b (36 layers) over 8 requests of
   1,024-2,048 tokens in waves of 4 slots (left-padded), ``max_new`` 32
   and 16; qwen2.5-3b at ``prefill_32k``'s 32,768 tokens with its batch
   cut to 1 (64 query chunks a layer), 16 new tokens; zamba2-1.2b (38
   blocks: Mamba2 states and two shared-attention caches), 4 x 1,024, 32
   new tokens; h2o-danube-3-4b (24 layers) over 6,144 tokens, its
   4,096-slot ring wrapped, 16 new tokens.  Each with every launch
   counter zeroed just before and read after (serving reaches no kernel:
   each stays 0), every request given exactly its ``max_new`` tokens and
   the clones dropped, the decode state's bytes allocated equal to those
   reckoned from the config, one decode step under
   ``set_sync_debug_mode("error")`` and one profiled, and the handoff at
   full width (``decode_step`` after ``prefill_to_state(S)`` against
   ``prefill_to_state(S + 1)``, ``handoff_check``); recorded: prefill ms a
   wave, decode ms a step, host ms a decode step, output tokens/s, peak
   memory, the profiled step's launches and idle share, and
   ``decode_32k``'s KV at batch 128 reckoned (it does not fit the card);
18. distribution (``distributed_check``): kernels 3-6 as a mesh runs them,
   each on half the rows with the other half's int64 sums added before the
   rounding and the select, against their plain versions on all the rows
   bit for bit, at every ResNet-74 conv geometry and the qwen2.5-3b weight-
   matmul ones (``reduce_path_check``); a one-rank NCCL world in this
   process and ``Trainer(mesh=make_mesh((1, 1)))``, ResNet-74 fused
   (``--e2train full``, batch 128) and the flash qwen2.5-3b (8 layers, 2 x
   4096), each through the chunked loop beside the same run without a mesh:
   losses, SLU flags, parameters, buffers and SWA bit for bit, every launch
   counter equal; then two ranks on the one card (gloo on CUDA tensors,
   ``DIST_RANK_FLAG`` children of this script), ResNet-74 at batch 128 (64
   rows a rank): every conv's first-step PSG signs and fallback flags,
   replayed on one rank on the same rows of x and gy, bit for bit; SMD
   counts and the first step's SLU decisions equal; the losses, step by
   step, within ``DIST_LOSS_REL`` (PSG off under ``sgdm``: the JAX
   package's own mesh tolerance ``DIST_SGDM_REL``) plus twice the one-rank
   run's own spread, the distance of its curve from its curves on the same
   batches with their rows in another order (the same global steps, every
   batch sum in another order, which is all two ranks change; PSG's 8-bit
   activation codes turn BatchNorm's other summation order into code flips,
   and the PSG-off losses diverge at lr 0.1); the model-level first-step
   signs that differ (beside the reordered runs'), the later SLU decisions
   and the collectives' share of one profiled step recorded; the same
   ranks then train qwen2.5-3b on sharded parameters (``lm_dist_run``:
   full width, ``DIST_LM_LAYERS`` layers, flash, ``--e2train full`` with
   ``int8_gather``, 2 x 4096, one row a rank, ``DIST_LM_EXECUTED``
   executed steps) and once more with every parameter replicated, beside
   one rank's run (``compare_lm_worlds``): per rank the bytes allocated
   between steps against the shard reckoning (and the old whole-copy
   placement's), a step's peak, the gathers' peak of whole bytes, their
   wire bytes by dtype and kernels 5-9's launches; last, the
   launcher's ``--devices 2 --mesh-data 2`` (ResNet-20, batch 128) on the
   card killed at a step and resumed on one rank (``reshard_state``) to its
   last step, and on two ranks to the uninterrupted two-rank run's last
   checkpoint bit for bit;
19. analysis (``analysis_check``): the static cost audits of the ``audit``
   bench record on the card (``launch/bench_audit``: ResNet-74,
   ResNet-110, MobileNetV2 and the smoke llama3-8b at batch 4, the lowered
   program's column for ResNet-74 and the smoke LM), each passing, each
   group's MACs equal to a CPU audit's bit for bit, and no kernel launched
   (their predict programs run outside PSG); the ResNet-74 main path's
   energy report with ``validate_against_hlo=True`` reading True; the
   kernel lint (``analysis/kernel_lint``) over every shipped kernel, the
   ten and ``slu_decide``, at its lint geometries with no finding (shared
   memory, spills, occupancy, sentinel-filled outputs against the plain
   versions, declared accumulators), one line a kernel with its resource
   figures and the launch table in ``chiprun_out/kernel_lint_h100.json``;
   the hot-loop lint of ResNet-14's and the smoke LM's chunk, every rule of
   ``CHUNK_CONTRACT`` true (``no-host-callback`` under
   ``set_sync_debug_mode("error")``); and the repo lint with no finding;
20. the dry run and the roofline (``dryrun_check``): (a) the dry-run CLI
   (``python -m repro_torch.launch.dryrun``) for qwen2.5-3b at full depth
   on the ``16x16`` production mesh, cells ``train_4k`` and
   ``decode_32k``, one subprocess a cell on the host, started before phase
   19 (they need no card), its ``--out`` under ``chiprun_out/``, both
   ``ok``; (b) in a subprocess on the card (``MEASURE_FLAG``), with
   nothing left allocated by this process, rank 0's local program of both
   cells run for
   real (``launch/dryrun.card_program``: the same world of fake ranks and
   placements, real CUDA shards; the fake group's collectives move
   nothing; the train cell on the plain PSG program the dry run traced,
   decode outside PSG), one warm-up call, then one whose
   ``torch.cuda.max_memory_allocated()`` must be within ``DRYRUN_PEAK_REL``
   of the record's ``bytes_per_device.peak`` (its span between two CUDA
   events printed), then one under ``torch.profiler`` whose device-busy
   time (the union of its kernels' intervals) must be at least
   ``max(compute_s, memory_s)`` of its roofline; (c) the
   ``roofline`` bench's analytic ResNet-74 row (``launch/bench_roofline``)
   under phase 11's chunked ResNet-74 replay, the ratio printed;
21. the conv and attention benches and the two examples
   (``bench_conv_attn_examples_check``): ``bench_run --json-conv
   --json-attn`` in fast mode, in a process of its own, into a temporary
   directory (exit 0; every path's byte accounting of both records passes
   ``assert_complete``; both paths' device ms and device-busy ms at the
   paper totals positive, from profiles that lost no launch; the byte
   models' launch grids of kernels 1-9 held against the card's at the 8
   ResNet-74 geometries and ``PAPER_LM``); ``bench_run --only
   conv,attn``'s rows made from those records, their names the
   reference's;
   ``launch/finetune_split`` (80 / 60 / 240 steps) and
   ``launch/quickstart`` (60 / 120 steps) on the card, their losses,
   energy units and the Sec. 4.5 verdict printed, kernels 5-9 launched by
   their PSG runs, and the first ``EXAMPLE_STEPS`` pre-training losses
   (sgdm, fp32, no PSG) from the card's initial weights on the CPU within
   ``EXAMPLE_REL`` of the card's; the phase's seconds.

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
# phase 20: the dry run's cells, checked on the card
DRYRUN_ARCH, DRYRUN_SHAPES = "qwen2_5_3b", ("train_4k", "decode_32k")
DRYRUN_PEAK_REL = 0.10
MEASURE_FLAG = "--measure-cells"


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


def lm_matmul_sites(d, heads, kv_heads, head_dim, d_ff, layers, glu=True):
    """{(din, dout): PSG weight-matmul sites per step} of a dense decoder
    stack: q and o (d x d), k and v (d x kv), up (d x d_ff), with ``glu``
    also gate (d x d_ff), and down (d_ff x d), per layer."""
    kv = kv_heads * head_dim
    sites = {}
    for geo in [(d, heads * head_dim), (heads * head_dim, d), (d, kv),
                (d, kv), (d, d_ff)] + [(d, d_ff)] * glu + [(d_ff, d)]:
        sites[geo] = sites.get(geo, 0) + layers
    return sites


def check_psg_matmul_kernels(torch, PM, sites, padded, n_tokens, im2col,
                             path="qwen", worst_cases=True):
    """Phase 3: kernels 5 and 6 against their plain versions at each weight
    matmul geometry of ``path``, timed; the padded geometry (if any) and
    the ResNet-74 im2col ones (``im2col``: {(N, din, dout): sites per
    step}) are checked and timed, not counted (the im2col step's sums go
    to ``im2col_totals``); then, with ``worst_cases``, kernels 5 and 6
    alone at the worst-case magnitude (``worst_case_check``,
    ``sign_worst_case_check``)."""
    from repro_torch.core.quant import codes

    tot = {n: _zero_total() for n in ("predictor_matmul", "psg_grad_w")}
    im2col_tot = {n: _zero_total() for n in tot}
    details = []
    g = torch.Generator(device="cuda").manual_seed(1)
    geos = [((n_tokens, din, dout), m, tot) for (din, dout), m in sites.items()]
    if padded:
        geos.append(((n_tokens, *padded), 0, tot))
    geos += [(geo, m, im2col_tot) for geo, m in im2col.items()]
    for (N, din, dout), m, into in geos:
        x = torch.randn(N, din, device="cuda", generator=g)
        gy = torch.randn(N, dout, device="cuda", generator=g) * 0.01
        xm, gm = codes(x, 4)[0], codes(gy, 10)[0]
        xq, gq = codes(x, 8)[0], codes(gy, 16)[0]
        del x, gy
        row = {"geometry": [N, din, dout], "sites_per_step": m,
               "path": "im2col" if into is im2col_tot else path}
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
    if not worst_cases:
        return tot, details, im2col_tot
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


def attention_geometry(name, m, batch, seq, layers, passes=1):
    """(name, B, S, nh, nkv, hd, dtype, causal, sites per step of kernels
    7, 8, 9) of model ``m``'s flash main path at ``batch`` x ``seq`` per
    forward pass, ``passes`` passes a step (its microbatches): kernel 7
    runs twice per layer under remat="block"."""
    return (name, batch, seq, m.num_heads, m.num_kv_heads,
            m.resolved_head_dim, "bfloat16", True,
            (2 * layers * passes, layers * passes, layers * passes))


def flash_geometries(m):
    """The qwen2.5-3b attention of the flash main path, then a padded MHA
    geometry and a non-causal one, checked and not counted."""
    return [attention_geometry("qwen", m, LM_BATCH, LM_SEQ, LM_LAYERS),
            ("padded", 2, 300, 8, 8, 32, "float32", True, (0, 0, 0)),
            ("noncausal", 1, 1024, 8, 2, 64, "bfloat16", False, (0, 0, 0))]


DKV_LIMS = (127.0, 7.0, 32767.0, 511.0)   # kernel 9's code limits


def check_flash_kernels(torch, FA, geometries, extra_checks=True):
    """Phase 4: kernels 7-9 against their plain versions, with times; with
    ``extra_checks``, kernel 9 also bit for bit on small integer inputs,
    kernel 8 on cancelling inputs and kernel 7 on the split-P adversarial
    v at the first geometry, and kernel 9 past its old guard."""
    import torch.nn.functional as F

    tot = {n: _zero_total() for n in FA.LAUNCHES}
    tot["flash_bwd_dq"]["bound_fp32_ms"] = 0.0
    details = []
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
        got = FA.flash_bwd_dkv(q, k, v, do, lse_p, delta, scales,
                               lims=DKV_LIMS, causal=causal)
        want = FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                      lims=DKV_LIMS, causal=causal)
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
                                      lims=DKV_LIMS, causal=causal),
             lambda: FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                            lims=DKV_LIMS, causal=causal),
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
    if not extra_checks:
        return tot, details

    for dt in ("float32", "bfloat16"):
        details.append(dkv_integer_check(
            torch, FA, (dt, 1, 256, 4, 2, 128, dt, True, None), gen))
    details.append(dq_cancel_check(torch, FA, geometries[0]))
    # S g = 606,208 query rows per kv head, past the 600,358 its int32
    # predictor sums once refused
    details.append(dkv_integer_check(
        torch, FA, ("past_guard", 1, 9472, 64, 1, 16, "bfloat16", True, None),
        gen))
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


def dkv_integer_check(torch, FA, geometry, gen):
    """Kernel 9 bit for bit on small integer q, k, v and dO at
    ``geometry`` (name, B, S, nh, nkv, hd, dtype, causal, _): every score
    and dP is exact in any summation order, so its codes and products must
    be identical to the plain version's."""
    name, B, S, nh, nkv, hd, dt, causal, _ = geometry
    q, k, v, do = (torch.randint(-2, 3, shape, device="cuda",
                                 generator=gen).to(getattr(torch, dt))
                   for shape in ((B, S, nh, hd), (B, S, nkv, hd),
                                 (B, S, nkv, hd), (B, S, nh, hd)))
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal)
    delta = torch.einsum("bsnh,bsnh->bns", do.float(), o.float()).contiguous()
    scales = FA.attention_psg_scales(q, v, do, delta, bits_x=8, bits_x_msb=4,
                                     bits_g=16, bits_g_msb=10)
    got = FA.flash_bwd_dkv(q, k, v, do, lse, delta, scales, lims=DKV_LIMS,
                           causal=causal)
    want = FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scales,
                                  lims=DKV_LIMS, causal=causal)
    if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
        fail(f"flash_bwd_dkv on integer inputs at {name} ({B}, {S}, {nh}, "
             f"{nkv}, {hd}, {dt}): not identical")
    out = {"name": f"integer_{name}", "geometry": [B, S, nh, nkv, hd, dt],
           "query_rows_per_kv_head": S * nh // nkv,
           "flash_bwd_dkv": "identical",
           "nonzero_products": [int((w_ != 0).sum()) for w_ in want],
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


def lm_reference_check(torch, fused_attention, microbatches=1, arch=LM_ARCH,
                       batch=None, seq=None):
    """Phase 5: one train step of the reduced ``arch`` on the card and on
    the CPU from the same parameters and batch; SLU decisions come from the
    same step key on both.  ``fused_attention`` is the PSG config's,
    ``microbatches`` the train config's, ``batch`` x ``seq`` the step's
    tokens (default: the reduced experiment's, 2 x 16); the attention path
    taken is in the result."""
    import copy

    from repro_torch.data.synthetic import (MarkovLMTask, make_lm_batch,
                                            with_frontend)
    from repro_torch.launch.train import lm_experiment
    from repro_torch.models.layers import attention_path
    from repro_torch.tasks import get_task
    from repro_torch.training.train_step import make_train_step, train_state_for

    exp = lm_experiment(arch, smoke=True, steps=4, batch=batch, seq=seq,
                        fused_attention=fused_attention,
                        microbatches=microbatches)
    tc = exp.train
    batch = with_frontend(make_lm_batch(
        MarkovLMTask(vocab=exp.model.vocab_size), tc.seed, 0, 0,
        tc.global_batch, tc.seq_len, "cpu"), exp.model, 0)
    model = get_task("lm").init(exp, 0, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        state = train_state_for(exp, copy.deepcopy(model).to(dev))
        state, met = make_train_step(exp)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: float(v) for k, v in met.items()},
                    {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    return {"arch": arch, "tokens": [tc.global_batch, tc.seq_len],
            "attention": attention_path(exp.model, exp.e2.psg, tc.seq_len),
            "sliding_window": exp.model.sliding_window,
            **compare_steps(mc, pc, mg, pg)}


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


def profile_step(torch, trainer, cpu_ops=True):
    """One more executed step of a main path under torch.profiler: device
    time by kernel and the device's busy share; ``cpu_ops=False`` records
    the device's events alone (no host op events: for steps that launch
    hundreds of thousands of kernels)."""
    steps = 1
    while not trainer.keeps(trainer.state.step + steps - 1):
        steps += 1
    return profile_fn(torch, lambda: trainer.run(steps), cpu_ops)


def profile_fn(torch, fn, cpu_ops=True):
    """``fn()`` under torch.profiler, from a synchronized start to a
    synchronized end: device time by kernel, the device's busy share and
    the device events (kernels, memsets, copies) it launched;
    ``cpu_ops=False`` records the device's events alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + \
        ([ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    return {"step_wall_ms": wall_ms, "device_events": len(dev),
            "device_busy_ms": busy_us / 1e3 if dev else None,
            "device_idle_share": 1 - busy_us / 1e3 / wall_ms if dev else None,
            "top": [{"ms": us / 1e3, "calls": calls[n], "name": n[:80]}
                    for n, us in top]}


def run_path(torch, name, build, mods, kernels, cpu_ops=True, **kw):
    """A main path, its energy report and its profile (``cpu_ops``: of
    :func:`profile_step`)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, main = main_path(torch, build, mods, kernels, **kw)
    print(json.dumps({"phase": name, **main}), flush=True)
    print(trainer.energy_report(steps=main["nominal_steps"]).summary(),
          flush=True)
    prof = profile_step(torch, trainer, cpu_ops)
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


def sub_block_launches(main, m, layers=LM_LAYERS, mlp_sites=3, flash=True,
                       fixed=0):
    """An LM path's launches as its executed sub-blocks account for them:
    per executed attention sub-block kernel 7 twice (the forward and its
    recompute), kernels 8 and 9 once (none of the three without ``flash``),
    kernels 5 and 6 four times (q, k, v, o); per executed MLP sub-block
    kernels 5 and 6 ``mlp_sites`` times (up, gate and down; no gate in a
    non-gated MLP; an MoE FFN's three per expert, routed and shared); and
    per forward pass ``fixed`` more of kernels 5 and 6 (the ungated
    encoder's).  The executed sub-blocks come from the SLU execution
    ratios of the ``executed * m`` forward passes of ``layers`` layers;
    without the flash kernels the attention sub-blocks are what kernel 5's
    count leaves; fails unless every count holds."""
    passes = main["executed"] * m
    subs = round(sum(main["slu_exec_ratio"]) * 2 * layers * m)
    got = main["launches"]
    attn = got["flash_bwd_dq"] if flash else \
        (got["predictor_matmul"] - fixed * passes - mlp_sites * subs) \
        // (4 - mlp_sites)
    mlp = subs - attn
    fl = int(flash)
    psg = 4 * attn + mlp_sites * mlp + fixed * passes
    want = {"flash_fwd": 2 * fl * attn, "flash_bwd_dq": fl * attn,
            "flash_bwd_dkv": fl * attn, "predictor_matmul": psg,
            "psg_grad_w": psg}
    if any(got[k] != v for k, v in want.items()) or not (
            2 * passes <= min(attn, mlp) <= max(attn, mlp)
            <= layers * passes):
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


# ---------------------------------------------------------------------------
# phase 13: the paper's benchmarks (launch/bench_run and its benches)
# ---------------------------------------------------------------------------

# the JAX package's rows, in order (benchmarks/bench_*.py)
PAPER_ROWS = {
    "smd": ["fig3a/smb@1.00", "fig3a/smb@0.83", "fig3a/smb@0.67",
            "fig3a/smd@1.00", "fig3a/smd@0.83", "fig3a/smd@0.67",
            "fig3b/smb_lr0.1", "fig3b/smb_lr0.14", "fig3b/smb_lr0.2"],
    "slu": ["fig4/slu_mild", "fig4/slu_strong", "fig4/sd_skip20",
            "fig4/sd_skip40"],
    "psg": ["tab2/sgd32", "tab2/fixed8", "tab2/signsgd", "tab2/psg"],
    "e2train": ["tab3/e2train_skip20", "tab3/e2train_skip40",
                "tab3/e2train_skip60"],
    "convergence": ["fig5/smb", "fig5/slu", "fig5/slu_smd", "fig5/e2train"],
    "throughput": ["throughput_resnet14_cifar",
                   "throughput_resnet14_overhead_bound"],
}
PSG_BENCHES = ("psg", "e2train", "convergence")   # kernels 5-9, tiny LM
# nominal steps of each bench in this phase: an eighth of the reference's
# fast-mode budgets (smd 100, slu 100, psg 60, e2train 160, convergence
# 60; tab2/sgd32 keeps the SGD32_STEPS it is compared over), so that the
# script stays within its time limit on a slow host (the bench LM is
# host-bound: 120 s for the phase at half the budgets); None: fast mode
PAPER_STEPS = {"smd": 12, "slu": 12, "psg": 8, "e2train": 20,
               "convergence": 8, "throughput": None}
TAB3_PAPER = ["0.8027", "0.8520", "0.9013"]
SGD32_STEPS = 8      # tab2/sgd32's first steps, card against CPU
SGD32_REL = 1e-4     # fp32, TF32 off, no quantization: summation order only
TABLE3_REL = 1e-12
# the CPU's counts: one single-threaded worker a run (the bench LM's ops
# are too small to gain from threads), the card's host cores all busy
CPU_WORKERS, CPU_THREADS = 8, 1
# ResNet-74's Table 3 reports from the config alone (bench_run.
# table3_config_derived), the JAX package's values:
# tests/test_torch_bench_paper.py holds these against its EnergyLedger
TABLE3_COMMON = {
    "model": "resnet74", "task": "cifar_cnn", "steps": 64000, "batch": 128,
    "fwd_macs_per_example": 168919680.0, "params": 1147226,
    "gated_fraction": 0.953682128689801,
    "smd": {"name": "smd", "enabled": True, "assumed": 0.6666666666666666,
            "measured": None},
    "psg": {"name": "psg", "enabled": True, "assumed": 0.4, "measured": None},
    "psg_factor_assumed": 0.09369565217391303, "psg_factor_measured": None,
    "computational_savings_measured": None,
    "energy_pj_baseline": 1.9799315793408004e+16, "energy_pj_measured": None,
    "energy_savings_measured": None, "validated_against_hlo": None,
    "straggler_dropped": 0}
# skip: (computational_savings_assumed, paper_composition,
#        energy_pj_assumed, energy_savings_assumed)
TABLE3_POINTS = {
    0.2: (0.9500289855072463, 0.8037333333333333, 1060737089202176.0,
          0.9464255684251807),
    0.4: (0.9625217391304348, 0.8528, 811478259525632.1, 0.9590148332400554),
    0.6: (0.9750144927536232, 0.9018666666666667, 562219429849088.0,
          0.9716040980549301)}


def table3_pinned() -> list:
    rows = []
    for skip, (comp, paper, e_pj, e_save) in TABLE3_POINTS.items():
        row = json.loads(json.dumps(TABLE3_COMMON))
        row["slu"] = {"name": "slu", "enabled": True, "assumed": skip,
                      "measured": None}
        row.update(computational_savings_assumed=comp,
                   paper_composition=paper, energy_pj_assumed=e_pj,
                   energy_savings_assumed=e_save)
        rows.append(row)
    return rows


def same_record(got, want, rel: float, where: str) -> None:
    """``got`` equals ``want``: the same keys, floats within ``rel``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            fail(f"{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_record(got[k], want[k], rel, f"{where}.{k}")
    elif isinstance(want, float):
        if not isinstance(got, float) or abs(got - want) > rel * abs(want):
            fail(f"{where}: {got!r} != {want!r} (rel {rel})")
    elif got != want or type(got) is not type(want):
        fail(f"{where}: {got!r} != {want!r}")


def row_fields(row: str) -> dict:
    """The parsed ``derived`` fields of one CSV row; fails unless every
    field parses (floats, a curve of floats, a throughput speedup)."""
    import re

    name, us, derived = row.split(",", 2)
    if not math.isfinite(float(us)) or float(us) <= 0:
        fail(f"{name}: us_per_call {us}")
    out = {}
    for kv in derived.split(";"):
        key, value = kv.split("=", 1)
        if key == "curve":
            out[key] = [float(v) for v in value.split("|")]
        elif key == "speedup":
            m = re.fullmatch(r"(\d+\.\d+)x_per_step=(\d+\.\d+)/s", value)
            if m is None:
                fail(f"{name}: speedup field {value!r}")
            out[key], out["per_step"] = float(m[1]), float(m[2])
        else:
            out[key] = float(value)
        values = out[key] if key == "curve" else [out[key]]
        if not all(math.isfinite(v) for v in values):
            fail(f"{name}: {key}={value}")
    return out


class RunRecorder:
    """Wraps each bench module's ``run_lm``: what every run was (config,
    steps, arguments) and did (executed and dropped steps, losses)."""

    def __init__(self, mods):
        self.mods, self.runs, self._saved = mods, [], {}

    def __enter__(self):
        for mod in self.mods:
            self._saved[mod] = mod.run_lm
            mod.run_lm = self._wrap(mod.__name__.rsplit(".", 1)[1],
                                    mod.run_lm)
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved.items():
            mod.run_lm = fn

    def _wrap(self, bench, run_lm):
        def recorded(e2, steps, **kw):
            hist, tr, wall = run_lm(e2, steps, **kw)
            self.runs.append({
                "bench": bench, "e2": e2, "steps": steps, "kw": kw,
                "executed": tr.executed_steps, "dropped": tr.dropped_steps,
                "losses": [h["loss"] for h in hist], "wall_s": wall})
            return hist, tr, wall
        return recorded


def cpu_executed(e2, steps, kw):
    """``(executed, dropped)`` of a CPU ``run_lm`` of the same configuration
    (a worker process's job)."""
    import torch
    torch.set_num_threads(CPU_THREADS)
    from repro_torch.launch.bench_common import run_lm
    _, tr, _ = run_lm(e2, steps, **{**kw, "device": "cpu"})
    return tr.executed_steps, tr.dropped_steps


def cpu_energy_record(fast: bool):
    """The energy record's measured run on the CPU (a worker's job)."""
    import torch
    torch.set_num_threads(CPU_THREADS)
    from repro_torch.launch.bench_run import energy_json
    return energy_json(fast, "cpu")["measured_run"]


def bench_lm_kernels_check(torch, PM, FA, dev):
    """Kernels 5-9 at the bench LM's own shapes, on the operands one
    executed step of ``tab2/fixed8`` (beta 0) and one of ``tab2/psg`` (beta
    0.05) gave the dispatch layer: 28 PSG weight-matmul sites a step (N =
    512 tokens, din/dout 32-128, one padded 128x128 flag tile each) and 4
    attention backwards (fp32, 4 q heads on 2 kv heads, head_dim 16, seq
    32: the CUDA-core kernels, one padded kv block).  Tolerances:
    kernel 5 bit for bit; kernel 6 signs and flags bit for bit, at tau 0
    every element confident (no flag) and sign 0 where pred is 0; kernel 7
    o within ``FP32_REL`` of max|o|, lse within 1e-5; kernel 8 dq within
    ``FP32_REL`` of max|dq| (on the plain version's lse); kernel 9 at most
    ``DKV_MISMATCH`` of each product's elements differing, by at most
    ``DKV_REL`` of its max|ref| (as phase 4; here one flipped P or dS code
    moves head_dim = 16 of a product's 16,384 elements, so the limit admits
    one flip a product).  Checked, not counted."""
    from repro_torch.core.config import E2TrainConfig, PSGConfig
    from repro_torch.core.quant import codes
    from repro_torch.kernels import dispatch
    from repro_torch.launch import bench_common, bench_psg

    out = {}
    for run, e2, opt in (
            ("fixed8", bench_psg.FIXED8, "signsgd"),
            ("psg", E2TrainConfig(psg=PSGConfig(enabled=True)), "psg")):
        matmuls, attns = [], []
        grad_w, attn_bwd = dispatch.psg_grad_w, dispatch.attention_bwd

        def capture_w(x2, gy2, cfg):
            matmuls.append((x2.detach().float().clone(),
                            gy2.detach().float().clone(), cfg))
            return grad_w(x2, gy2, cfg)

        def capture_attn(q, k, v, o, lse, do, cfg, *, causal=True):
            attns.append(([t.detach().clone() for t in (q, k, v, do)],
                          cfg, causal))
            return attn_bwd(q, k, v, o, lse, do, cfg, causal=causal)

        dispatch.psg_grad_w, dispatch.attention_bwd = capture_w, capture_attn
        try:
            bench_common.run_lm(e2, 1, lr=0.03, optimizer=opt, device=dev)
        finally:
            dispatch.psg_grad_w, dispatch.attention_bwd = grad_w, attn_bwd
        if len(matmuls) != 7 * 4:      # q, k, v, o, up, gate, down x 4
            fail(f"{run}: {len(matmuls)} PSG matmul sites in a bench LM "
                 "step, not 28")
        if len(attns) != 4:
            fail(f"{run}: {len(attns)} attention backwards, not 4")
        geometries, zero_pred, flagged = {}, 0, 0
        for x2, gy2, cfg in matmuls:
            xm, xq = codes(x2, cfg.bits_x_msb)[0], codes(x2, cfg.bits_x)[0]
            gm, gq = codes(gy2, cfg.bits_g_msb)[0], codes(gy2, cfg.bits_g)[0]
            xm, gm, xq, gq = (t.contiguous() for t in (xm, gm, xq, gq))
            geo = (x2.shape[0], x2.shape[1], gy2.shape[1])
            pred = PM.predictor_matmul(xm, gm)
            if not torch.equal(pred, PM.predictor_matmul_plain(xm, gm)):
                fail(f"predictor_matmul at {geo} ({run}): not identical")
            tau = cfg.beta * pred.float().abs().amax()
            sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
            psign, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
            if not (torch.equal(sign, psign) and torch.equal(stats, pstats)):
                fail(f"psg_grad_w at {geo} ({run}): not identical")
            if cfg.beta == 0.0:
                zeros = pred == 0
                if float(tau) != 0.0 or int(stats.abs().sum()) != 0:
                    fail(f"psg_grad_w at tau {float(tau)} at {geo}: "
                         "a tile fell back")
                if not torch.equal(sign[zeros],
                                   torch.zeros_like(sign[zeros])):
                    fail(f"psg_grad_w at tau 0 at {geo}: nonzero sign at "
                         "pred 0")
                zero_pred += int(zeros.sum())
            flagged += int((stats != 0).any())
            geometries[str(geo)] = geometries.get(str(geo), 0) + 1
        attn_rows = []
        for (q, k, v, do), cfg, causal in attns:
            geo = [*q.shape[:3], k.shape[2], q.shape[3], str(q.dtype),
                   causal]
            o, lse = FA.flash_fwd(q, k, v, causal=causal)
            o_p, lse_p = FA.flash_attention_plain(q, k, v, causal=causal)
            err_o = float((o.float() - o_p.float()).abs().max())
            err_l = float((lse - lse_p).abs().max())
            if not (err_o <= FP32_REL * float(o_p.float().abs().max())
                    and err_l <= 1e-5):
                fail(f"flash_fwd at {geo} ({run}): o err {err_o}, lse err "
                     f"{err_l}")
            delta = torch.einsum("bsnh,bsnh->bns", do.float(),
                                 o_p.float()).contiguous()
            dq = FA.flash_bwd_dq(q, k, v, do, lse_p, delta, causal=causal)
            dq_p = FA.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                         causal=causal)
            err_dq = float((dq - dq_p).abs().max())
            if not err_dq <= FP32_REL * float(dq_p.abs().max()):
                fail(f"flash_bwd_dq at {geo} ({run}): max abs err {err_dq}")
            scales = FA.attention_psg_scales(
                q, v, do, delta, bits_x=cfg.bits_x, bits_x_msb=cfg.bits_x_msb,
                bits_g=cfg.bits_g, bits_g_msb=cfg.bits_g_msb)
            lims = tuple(FA.qlim(b) for b in (cfg.bits_x, cfg.bits_x_msb,
                                              cfg.bits_g, cfg.bits_g_msb))
            got = FA.flash_bwd_dkv(q, k, v, do, lse_p, delta, scales,
                                   lims=lims, causal=causal)
            want = FA.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scales,
                                          lims=lims, causal=causal)
            shares = []
            for pname, g_, w_ in zip(("dv_msb", "dv_full", "dk_msb",
                                      "dk_full"), got, want):
                diff = (g_ - w_).abs().double()
                share, top = float((diff > 0).double().mean()), \
                    float(diff.max())
                if share > DKV_MISMATCH or top > DKV_REL * float(
                        w_.abs().max()):
                    fail(f"flash_bwd_dkv {pname} at {geo} ({run}): {share} "
                         f"of elements differ, by up to {top}")
                shares.append(share)
            attn_rows.append({"geometry": geo, "o_err": err_o,
                              "lse_err": err_l, "dq_err": err_dq,
                              "dkv_mismatch_shares": shares})
        out[run] = {"psg_sites": len(matmuls), "geometries": geometries,
                    "tiles_per_site": 1, "sites_flagged": flagged,
                    "zero_pred_elements": zero_pred, "attention": attn_rows}
    return out


def paper_benches_check(torch, mods, dev="cuda", steps=None):
    """Phase 13: the paper's benchmarks through the driver's benches, in
    this process, in fast mode; ``steps`` ({bench: nominal steps}, e.g.
    :data:`PAPER_STEPS`) cuts a bench's steps (None: the reference's
    budget)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core.config import E2TrainConfig, PSGConfig
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch import (bench_common, bench_convergence,
                                    bench_e2train, bench_psg, bench_run,
                                    bench_slu, bench_smd)
    from repro_torch.tasks import get_task

    t_start = time.perf_counter()
    lm_check = bench_lm_kernels_check(torch, PM, FA, dev)
    print(json.dumps({"phase": "paper_benches_kernels", **lm_check}),
          flush=True)
    lm_kernels = list(PM.LAUNCHES) + list(FA.LAUNCHES)
    benches = {}
    with RunRecorder([bench_smd, bench_slu, bench_psg, bench_e2train,
                      bench_convergence]) as rec:
        for name, want in PAPER_ROWS.items():
            reset_all(mods)
            t0 = time.perf_counter()
            rows = bench_run.BENCHES[name](fast=True, device=dev,
                                           steps=(steps or {}).get(name))
            bench_common.sync(torch.device(dev))
            wall = time.perf_counter() - t0
            launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
            for row in rows:
                print(row, flush=True)
            print(json.dumps({"phase": f"paper_bench_{name}", "wall_s": wall,
                              "launches": launches}), flush=True)
            if [r.split(",", 1)[0] for r in rows] != want:
                fail(f"bench {name} rows {rows}, not the reference's {want}")
            for kernel, count in launches.items():
                if name in PSG_BENCHES and kernel in lm_kernels:
                    if dev == "cuda" and count <= 0:
                        fail(f"kernel {kernel} was not launched by {name}")
                elif count != 0:
                    fail(f"kernel {kernel} launched {count} times by {name}")
            benches[name] = {"rows": rows, "wall_s": wall,
                             "launches": launches,
                             "fields": [row_fields(r) for r in rows]}
    profiles = {}
    if dev == "cuda":     # the idle share of an executed step of each family
        for fam, e2, kw in (
                ("sgd32", E2TrainConfig(), {}),
                ("psg", E2TrainConfig(psg=PSGConfig(True)),
                 dict(lr=0.03, optimizer="psg"))):
            _, tr, _ = bench_common.run_lm(e2, 2, device=dev, **kw)
            profiles[fam] = profile_step(torch, tr)
            del tr
        print(json.dumps({"phase": "paper_benches_profile", **profiles}),
              flush=True)
    psg_fields = benches["psg"]["fields"][3]
    if not {"measured_fallback", "energy_saving_measured"} <= set(psg_fields):
        fail(f"tab2/psg: {benches['psg']['rows'][3]}")
    if benches["psg"]["fields"][1].get("energy_saving") != \
            round(bench_psg.FIXED8_SAVING, 3):
        fail(f"tab2/fixed8: {benches['psg']['rows'][1]}")
    if [r.rsplit("paper=", 1)[1] for r in benches["e2train"]["rows"]] != \
            TAB3_PAPER:
        fail(f"tab3 rows: {benches['e2train']['rows']}")

    with tempfile.TemporaryDirectory() as tmp:
        reset_all(mods)
        t0 = time.perf_counter()
        # the record's fast run (ResNet-14, 12 steps), for the script's
        # time
        if bench_run.main(["--json", f"{tmp}/energy.json",
                           "--device", dev]) != 0:
            fail("bench_run --json did not exit 0")
        energy_wall = time.perf_counter() - t0
        energy_launches = {n: c for mod in mods
                           for n, c in mod.LAUNCHES.items()}
        t0 = time.perf_counter()
        if bench_run.main(["--json-throughput", f"{tmp}/throughput.json",
                           "--device", dev]) != 0:
            fail("bench_run --json-throughput did not exit 0")
        throughput_wall = time.perf_counter() - t0
        energy = json.loads(Path(f"{tmp}/energy.json").read_text())
        throughput = json.loads(Path(f"{tmp}/throughput.json").read_text())
    for kernel in K.LAUNCHES:
        if dev == "cuda" and energy_launches[kernel] <= 0:
            fail(f"kernel {kernel} was not launched by the energy record")
    for i, (got, want) in enumerate(zip(energy["table3_config_derived"],
                                        table3_pinned())):
        same_record(got, want, TABLE3_REL, f"table3_config_derived[{i}]")
    measured = energy["measured_run"]
    if (measured["model"], measured["steps"], measured["batch"],
            measured["validated_against_hlo"]) != ("resnet14", 12, 8, None):
        fail(f"measured_run {measured}")
    for name, rec_t in throughput.items():
        if not all(rec_t[k] > 0 for k in ("per_step_steps_per_s",
                                          "chunked_steps_per_s")):
            fail(f"throughput record {name}: {rec_t}")
    print(json.dumps({"phase": "paper_benches_records",
                      "energy_wall_s": energy_wall,
                      "throughput_wall_s": throughput_wall,
                      "energy_launches": energy_launches,
                      "measured_run": measured, "throughput": throughput}),
          flush=True)

    # the CPU's counts: a CPU run_lm of every configuration that draws SMD
    # drops (with SMD off every step executes, with no draw), and the
    # energy record's measured run; tab2/sgd32's first steps here
    t0 = time.perf_counter()
    for run in rec.runs:
        if not run["e2"].smd.enabled and (run["executed"], run["dropped"]) \
                != (run["steps"], 0):
            fail(f"{run['bench']}: SMD off but {run['executed']} of "
                 f"{run['steps']} steps executed")
    # the SMD runs without PSG (a PSG run's drops are the same draws; its
    # CPU re-run, the longest, is left out)
    smd_runs = [r for r in rec.runs
                if r["e2"].smd.enabled and not r["e2"].psg.enabled]
    with ProcessPoolExecutor(
            CPU_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        energy_cpu = pool.submit(cpu_energy_record, True)
        jobs = [pool.submit(cpu_executed, r["e2"], r["steps"], r["kw"])
                for r in smd_runs]
        tab2 = [r for r in rec.runs if r["bench"] == "bench_psg"]
        sgd32 = tab2[0]
        exp = bench_common.lm_experiment(E2TrainConfig(), sgd32["steps"])
        cpu_hist, _, _ = bench_common.run_lm(
            E2TrainConfig(), SGD32_STEPS, total_steps=sgd32["steps"],
            device="cpu", init=get_task("lm").init(exp, 0, dev).cpu())
        counts = [job.result() for job in jobs]
        energy_cpu = energy_cpu.result()
    card_losses = sgd32["losses"][:SGD32_STEPS]
    cpu_losses = [h["loss"] for h in cpu_hist]
    sgd32_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                          cpu_losses))
    if len(card_losses) != SGD32_STEPS or sgd32_rel > SGD32_REL:
        fail(f"tab2/sgd32 card losses {card_losses} against the CPU's "
             f"{cpu_losses}: {sgd32_rel} relative > {SGD32_REL}")
    for run, (executed, dropped) in zip(smd_runs, counts):
        if (run["executed"], run["dropped"]) != (executed, dropped):
            fail(f"{run['bench']} {run['e2']} over {run['steps']} steps: "
                 f"{run['executed']} executed on the card, {executed} on "
                 "the CPU")
    smd_rows = zip(benches["smd"]["fields"][3:6],
                   [r for r in smd_runs if r["bench"] == "bench_smd"])
    base = (steps or {}).get("smd") or 100    # bench_smd's base budget
    for fields, run in smd_rows:
        if fields["energy_ratio"] != round(run["executed"] / base, 2):
            fail(f"SMD row energy_ratio {fields['energy_ratio']} != "
                 f"{run['executed']} / {base}")
    if energy_cpu["smd"] != measured["smd"]:
        fail(f"energy record SMD {measured['smd']} on the card, "
             f"{energy_cpu['smd']} on the CPU")
    cpu_s = time.perf_counter() - t0
    out = {"kernels_at_bench_shapes": lm_check, "profiles": profiles,
           "benches": {n: {k: v for k, v in b.items() if k != "fields"}
                       for n, b in benches.items()},
           "runs": [{k: (str(v) if k in ("e2", "kw") else v)
                     for k, v in r.items() if k != "losses"}
                    for r in rec.runs],
           "sgd32": {"card": card_losses, "cpu": cpu_losses,
                     "max_rel": sgd32_rel, "limit": SGD32_REL},
           "smd_runs_on_cpu": len(smd_runs), "cpu_check_s": cpu_s,
           "energy_wall_s": energy_wall, "throughput_wall_s": throughput_wall,
           "energy_launches": energy_launches, "measured_run": measured,
           "throughput": throughput,
           "seconds": time.perf_counter() - t_start}
    print(json.dumps({"phase": "paper_benches",
                      "wall_s": {n: b["wall_s"] for n, b in benches.items()},
                      "cpu_check_s": cpu_s, "sgd32_max_rel": sgd32_rel,
                      "seconds": out["seconds"]}), flush=True)
    return out


# phase 14: the dense decoder family at its published widths, DENSE_LAYERS deep
DENSE_LAYERS = 2     # of 32 / 40 / 24: cut from 4 for the script's time
DENSE_PATHS = {     # arch: (batch, seq) of one step, as its main path trains
    "llama3_8b": (2, 4096),         # train_4k's length, its batch cut
    "starcoder2_15b": (4, 4096),    # in its config's 4 microbatches
    "h2o_danube_3_4b": (1, 16384),  # above 8192 tokens: query-chunked
}
QCHUNK_REF_SEQ = 8192 + 300     # the reduced windowed model's chunked step


def dense_archs_check(torch, mods):
    """Phase 14: llama3-8b, starcoder2-15b and h2o-danube-3-4b at their
    published widths, :data:`DENSE_LAYERS` layers, ``--e2train full``,
    ``remat="block"``.  For each: kernels 5-6 at its weight-matmul
    geometries (tokens of one microbatch; bit for bit, timed, not counted
    in the ``kernels`` line) and, where it takes the flash path, kernels
    7-9 at its attention geometry (limits of :func:`check_flash_kernels`,
    kernel 9 also bit for bit on integer inputs); one reduced step on the
    card against the CPU (h2o-danube-3-4b: at 16 tokens over its reduced
    window of 8, materialized, and at :data:`QCHUNK_REF_SEQ` tokens, query
    chunked); then its main path (:data:`DENSE_PATHS`) through
    ``build_lm_trainer`` with its launches checked against its executed
    sub-blocks (kernels 7-9 absent from the windowed model), profiled.
    Last, the fault-injection record on the card
    (``launch/bench_ft.ft_json``) without its kill-and-restart (phase
    18's), which must recover every fault."""
    from repro_torch.configs import get_experiment
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch import bench_ft
    from repro_torch.launch.train import build_lm_trainer
    from repro_torch.models.layers import attention_path

    t_start = time.perf_counter()
    out = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    for arch, (batch, seq) in DENSE_PATHS.items():
        exp = get_experiment(arch)
        m, micro = exp.model, exp.train.microbatches
        path = attention_path(m, PSGConfig(enabled=True), seq)
        flash = path == "flash"
        sites = lm_matmul_sites(m.d_model, m.num_heads, m.num_kv_heads,
                                m.resolved_head_dim, m.d_ff,
                                DENSE_LAYERS * micro, glu=m.glu)
        ptot, prows, _ = check_psg_matmul_kernels(
            torch, PM, sites, None, batch // micro * seq, {}, path=arch,
            worst_cases=False)
        r = {"attention": path, "microbatches": micro,
             "psg_matmul_rows": prows, "totals": kernel_totals(ptot)}
        if flash:
            geo = attention_geometry(arch, m, batch // micro, seq,
                                     DENSE_LAYERS, micro)
            ftot, frows = check_flash_kernels(torch, FA, [geo],
                                              extra_checks=False)
            frows.append(dkv_integer_check(
                torch, FA, geo, torch.Generator(device="cuda").manual_seed(4)))
            r["flash_rows"] = frows
            r["totals"].update(kernel_totals(ftot))
        print(json.dumps({"phase": f"dense_{arch}_kernels", **r}),
              flush=True)
        refs = [lm_reference_check(torch, None, arch=arch)]
        if not flash:
            refs.append(lm_reference_check(torch, None, arch=arch, batch=1,
                                           seq=QCHUNK_REF_SEQ))
            if [(x["attention"], x["tokens"][1] > x["sliding_window"] > 0)
                    for x in refs] != [("materialized", True),
                                       ("query-chunked", True)]:
                fail(f"{arch} reference steps took {refs}")
        r["reference"] = refs
        print(json.dumps({"phase": f"dense_{arch}_reference",
                          "steps": refs}), flush=True)
        trainer, main, prof = run_path(
            torch, f"dense_{arch}_main_path",
            lambda steps: build_lm_trainer(arch, num_layers=DENSE_LAYERS,
                                           batch=batch, seq=seq, steps=steps,
                                           device="cuda"),
            mods, list(PM.LAUNCHES) + (list(FA.LAUNCHES) if flash else []),
            absent=[] if flash else list(FA.LAUNCHES))
        tc = trainer.exp.train
        if (tc.global_batch, tc.seq_len, tc.microbatches, tc.remat) != \
                (batch, seq, micro, "block") or attention_path(
                    trainer.exp.model, trainer.exp.e2.psg, seq) != path:
            fail(f"{arch} trained {tc} on another path than {path}")
        del trainer
        subs = sub_block_launches(main, micro, DENSE_LAYERS,
                                  3 if m.glu else 2, flash)
        print(json.dumps({"phase": f"dense_{arch}_launches", **subs}),
              flush=True)
        r.update(main_path=main, profile=prof, sub_block_launches=subs)
        out[arch] = r
    # the record's kill-and-restart is left to phase 18, whose launcher
    # run on the card is killed, restarted and checked bit for bit
    t0 = time.perf_counter()
    ft = bench_ft.ft_json(fast=True, device="cuda", kill_restart=False)
    ft["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "dense_ft", **ft}), flush=True)
    if not ft["all_recovered"]:
        fail(f"fault-injection record on the card: {ft}")
    out["ft"] = ft
    out["seconds"] = time.perf_counter() - t_start
    return out


ENCDEC_PATHS = {    # arch: (layers, batch, seq) of its main path (None: all)
    "whisper_small": (None, 8, 4096),
    "phi_3_vision_4_2b": (2, 2, 4096),     # cut from 4 for the script's time
    "deepseek_moe_16b": (2, 2, 4096),      # the same
    "grok_1_314b": (1, 8, 4096),
}
CARD_BYTES = 80e9


def reckoned_state_bytes(exp) -> dict:
    """The bytes a ``--e2train full`` trainer of ``exp`` holds on the card
    before any activation: the parameters and the ``psg`` optimizer's
    momentum in ``param_dtype``, the SWA average in fp32, the gradients
    in ``param_dtype`` and their majority-vote signs in fp32; plus the
    fp32 temporaries (two) of the optimizer's update of the largest leaf
    (an expert stack)."""
    m = exp.model
    n = m.param_count()
    pb = 2 if m.param_dtype == "bfloat16" else 4
    f = m.moe_d_ff or m.d_ff
    largest = max(m.num_experts * m.d_model * f, m.padded_vocab * m.d_model)
    state = n * (3 * pb + 4 + 4)
    return {"params": n, "param_bytes": pb, "state_bytes": state,
            "update_temporaries_bytes": 2 * 4 * largest,
            "fits": state + 2 * 4 * largest < CARD_BYTES}


def zero_expert_check(torch, PM, N, din, dout):
    """Kernels 5 and 6 on an expert that received no token: every row of
    its input and of its output gradient zero (scale ``1e-12 / lim``,
    codes 0); bit for bit against the plain versions."""
    from repro_torch.core.quant import codes

    x = torch.zeros(N, din, device="cuda")
    gy = torch.zeros(N, dout, device="cuda")
    xm, gm = codes(x, 4)[0], codes(gy, 10)[0]
    xq, gq = codes(x, 8)[0], codes(gy, 16)[0]
    pred = PM.predictor_matmul(xm, gm)
    tau = 0.05 * pred.float().abs().amax()
    sign, stats = PM.psg_grad_w(pred, xq, gq, tau)
    psign, pstats = PM.psg_grad_w_plain(pred, xq, gq, tau)
    if not (torch.equal(pred, PM.predictor_matmul_plain(xm, gm))
            and torch.equal(sign, psign) and torch.equal(stats, pstats)):
        fail(f"kernels 5-6 on an expert with no token ({N}, {din}, {dout}): "
             "not identical")
    return {"geometry": [N, din, dout], "expert": "no token",
            "identical": True, "fallback_flags": float(stats.float().mean()),
            "nonzero_signs": int((sign != 0).sum())}


CHUNK_ARCHS = ("deepseek_moe_16b", "whisper_small")


def encdec_chunked_check(torch, arch, steps=16):
    """The reduced ``arch`` (3 layers, the middle one gated) through the
    per-step loop and the chunked loop (K = 4: one captured CUDA graph,
    every unforced gated sub-block an IF node) from the same init on the
    card: losses, the MoE aux loss, SLU flags and parameters bit for bit
    (:func:`same_runs`); for the MoE, some step skips the gated MoE
    sub-block, so its IF node leaves the aux at 0 there."""
    from repro_torch.launch.train import build_lm_trainer

    a, b = (build_lm_trainer(arch, num_layers=3, smoke=True, steps=steps,
                             device="cuda", chunk_steps=k) for k in (1, 4))
    a.run(steps)
    b.run(steps)
    out = same_runs(torch, a, b, f"{arch} chunked")
    aux = [[h["aux_loss"] for h in t.history] for t in (a, b)]
    if aux[0] != aux[1]:
        fail(f"{arch} chunked: aux_loss {aux[1]} against per-step {aux[0]}")
    skipped = sum(f[3] == 0.0 for f in (h["slu_executed"]
                                        for h in a.history))
    if b._chunk_fn.cond.nodes <= 0 or (
            a.exp.model.num_experts and not skipped):
        fail(f"{arch} chunked: {b._chunk_fn.cond.nodes} IF nodes, "
             f"{skipped} steps skipping layer 1's ffn")
    out.update(if_nodes=b._chunk_fn.cond.nodes, aux_loss=aux[0],
               steps_skipping_layer1_ffn=skipped)
    return out


def encdec_vlm_moe_check(torch, mods):
    """Phase 15: whisper-small (encoder-decoder), phi-3-vision-4.2b (VLM)
    and the MoE family (deepseek-moe-16b, grok-1-314b) at their published
    widths, ``--e2train full``, ``remat="block"``.  Kernels 5-6 at each MoE
    model's expert geometries (``G * C`` rows an expert, one launch per
    expert; bit for bit, timed, not counted in the ``kernels`` line) and on
    an expert with no token; kernels 7-9 at phi-3-vision's attention (hd
    96, 4096 text + 576 patch tokens) and whisper-small's decoder (hd 64,
    g = 1) with phase 4's limits, kernel 9 also bit for bit on integer
    inputs at hd 96; one reduced step of each arch on the card against the
    CPU; then the main paths of :data:`ENCDEC_PATHS` whose reckoned state
    (:func:`reckoned_state_bytes`) fits the card, each with its launches
    checked against its executed sub-blocks, profiled.  A path whose state
    does not fit is not trained: its reckoning is recorded.  Last, the
    reduced deepseek-moe-16b and whisper-small through the chunked loop
    against the per-step loop (:func:`encdec_chunked_check`)."""
    from repro_torch.configs import get_experiment
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch.train import build_lm_trainer, lm_experiment
    from repro_torch.models.layers import attention_path

    t_start = time.perf_counter()
    out = {}
    for arch, (layers, batch, seq) in ENCDEC_PATHS.items():
        exp = lm_experiment(arch, num_layers=layers, batch=batch, seq=seq)
        m, micro = exp.model, exp.train.microbatches
        layers = m.num_layers
        vlm = bool(m.frontend) and not m.encoder_layers
        tokens = seq + (m.frontend_tokens if vlm else 0)
        r = {"layers": layers, "microbatches": micro,
             "tokens_per_sequence": tokens,
             "attention": attention_path(m, exp.e2.psg, tokens),
             "reckoned": reckoned_state_bytes(exp)}
        if m.num_experts:
            n_g = min(1024, batch // micro * seq)
            rows = batch // micro * seq // n_g * max(
                int(m.capacity_factor * m.top_k * n_g / m.num_experts), 1)
            f, d, E = m.moe_d_ff, m.d_model, m.num_experts
            sites = {(d, f): 2 * E * layers * micro,
                     (f, d): E * layers * micro}
            ptot, prows, _ = check_psg_matmul_kernels(
                torch, PM, sites, None, rows, {}, path=f"{arch}_expert",
                worst_cases=False)
            prows += [zero_expert_check(torch, PM, rows, d, f),
                      zero_expert_check(torch, PM, rows, f, d)]
            r.update(expert_rows=rows, expert_kernel_rows=prows,
                     expert_totals=kernel_totals(ptot))
        if arch in ("whisper_small", "phi_3_vision_4_2b"):
            geo = attention_geometry(arch, m, batch // micro, tokens, layers,
                                     micro)
            ftot, frows = check_flash_kernels(torch, FA, [geo],
                                              extra_checks=False)
            if m.resolved_head_dim == 96:
                frows.append(dkv_integer_check(
                    torch, FA, geo,
                    torch.Generator(device="cuda").manual_seed(5)))
            r.update(flash_rows=frows, flash_totals=kernel_totals(ftot))
        print(json.dumps({"phase": f"encdec_{arch}_kernels", **r}),
              flush=True)
        r["reference"] = lm_reference_check(torch, None, arch=arch)
        print(json.dumps({"phase": f"encdec_{arch}_reference",
                          **r["reference"]}), flush=True)
        if not r["reckoned"]["fits"]:
            print(json.dumps({"phase": f"encdec_{arch}_not_trained",
                              **r["reckoned"]}), flush=True)
            out[arch] = r
            continue
        trainer, main, prof = run_path(
            torch, f"encdec_{arch}_main_path",
            lambda steps: build_lm_trainer(arch, num_layers=layers,
                                           batch=batch, seq=seq, steps=steps,
                                           device="cuda"),
            mods, list(PM.LAUNCHES) + list(FA.LAUNCHES), execute=3)
        tc = trainer.exp.train
        if (tc.global_batch, tc.seq_len, tc.microbatches, tc.remat) != \
                (batch, seq, micro, "block"):
            fail(f"{arch} trained {tc}")
        del trainer
        mlp_sites = 3 * (m.num_experts + m.num_shared_experts) \
            if m.num_experts else (3 if m.glu else 2)
        subs = sub_block_launches(main, micro, layers, mlp_sites, True,
                                  fixed=6 * m.encoder_layers)
        print(json.dumps({"phase": f"encdec_{arch}_launches", **subs}),
              flush=True)
        r.update(main_path=main, profile=prof, sub_block_launches=subs)
        out[arch] = r
    out["chunked"] = {arch: encdec_chunked_check(torch, arch)
                      for arch in CHUNK_ARCHS}
    print(json.dumps({"phase": "encdec_chunked", **out["chunked"]}),
          flush=True)
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 16: the SSM family (xlstm-350m, zamba2-1.2b)
# ---------------------------------------------------------------------------

SSM_PATHS = {       # arch: (layers, batch, seq) of its main path (None: all)
    "zamba2_1_2b": (19, 4, 2048),       # one unit of its 2, 4 microbatches
    "xlstm_350m": (4, 4, 1024),         # one unit of its 24 layers
}
SSM_REF_SEQ = 512       # the reduced steps: two 256-token chunks carry state
MIXER_SEQ = 4096
# the mixers at full width, card against CPU, fp32 with TF32 off: the same
# fp32 operations in other orders (the CPU tests hold the port to the JAX
# package at 1e-5 of max|ref|, Mamba2's per-head vectors' gradients at 1e-4);
# over 4096 tokens the log-decay cumulative sums (to -11,000 in Mamba2's
# fastest head) round apart, so the limit is 1e-4 of max|ref|
MIXER_REL = 1e-4
# sLSTM at xlstm-350m's widths is chaotic: its recurrent weights (the
# reference's fan-in law over nh = 4 rows, std 0.5 into 256-wide sums) double
# a rounding difference every ~2 tokens (the CPU against the JAX package:
# 6e-7 at token 0, 3.7e-6 at 4, 2.6e-5 at 8, O(1) by 40), and its input
# gradient grows by 20 orders of magnitude and more over 256 tokens, to inf
# in some sequences, in both packages; so the card is held to the CPU over
# its first SLSTM_SEQ tokens, and the 4096-token call is timed with its
# forward checked finite (the share of non-finite input gradient elements
# recorded)
SLSTM_SEQ = 4


def ssm_mixer_check(torch) -> dict:
    """Phase 16: each mixer at full width, 1 x 4096 tokens, fp32 (Mamba2 at
    zamba2-1.2b's widths, mLSTM and sLSTM at xlstm-350m's): forward and
    input gradient on the card against the CPU (the sLSTM over
    :data:`SLSTM_SEQ` tokens), the card's forward and backward timed."""
    import dataclasses

    from repro_torch.configs import get_experiment
    from repro_torch.models import ssm as S

    out = {}
    for kind, arch in (("mamba", "zamba2_1_2b"), ("mlstm", "xlstm_350m"),
                       ("slstm", "xlstm_350m")):
        cfg = dataclasses.replace(get_experiment(arch).model,
                                  dtype="float32")
        cpu = S.MIXERS[kind][0](cfg, torch.Generator().manual_seed(0))
        card = S.MIXERS[kind][0](cfg, torch.Generator().manual_seed(0)) \
            .to("cuda")
        fwd = S.MIXERS[kind][1]
        g = torch.Generator().manual_seed(1)
        u = torch.randn(1, MIXER_SEQ, cfg.d_model, generator=g)
        gy = torch.randn(1, MIXER_SEQ, cfg.d_model, generator=g)
        n = SLSTM_SEQ if kind == "slstm" else MIXER_SEQ
        res = {}
        for mod, dev in ((cpu, "cpu"), (card, "cuda")):
            x = u[:, :n].to(dev).requires_grad_()
            y = fwd(mod, x, cfg)
            y.backward(gy[:, :n].to(dev))
            res[dev] = (y.detach().cpu(), x.grad.cpu())
        errs = [rel_err(a, b) for a, b in zip(res["cuda"], res["cpu"])]
        if not max(errs) <= MIXER_REL:
            fail(f"{kind} at full width, card against CPU: relative errors "
                 f"{errs} (y, dx) above {MIXER_REL}")
        # timed once: the compared call above ran the same kernels
        x, gyc = u.to("cuda").requires_grad_(), gy.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fwd(card, x, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y.backward(gyc)
        torch.cuda.synchronize()
        times = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
        if not bool(torch.isfinite(y).all()):
            fail(f"{kind} at full width: a non-finite output")
        heads = S._mamba_dims(cfg)[1] if kind == "mamba" else cfg.num_heads
        r = {"widths": {"d_model": cfg.d_model, "ssm_state": cfg.ssm_state,
                        "heads": heads}, "compared_tokens": n,
             "y_rel_err": errs[0], "dx_rel_err": errs[1], "limit": MIXER_REL,
             "tokens": MIXER_SEQ, "fwd_ms": times[0], "bwd_ms": times[1],
             "dx_nonfinite_share": float((~torch.isfinite(x.grad)).float()
                                         .mean())}
        out[kind] = r
        del cpu, card, x, y
    return out


def ssm_chunked_check(torch, arch, steps=8) -> dict:
    """The reduced ``arch`` (xlstm-350m's unit of 3 mLSTM and 1 sLSTM,
    zamba2-1.2b's of 18 Mamba2 and the shared attention) through the
    per-step loop and the chunked loop (K = 4) from the same init on the
    card, bit for bit (:func:`same_runs`), with one IF node in the forward
    and one in the backward of each unforced gated sub-block (the Mamba2
    and LSTM ones) and none for the shared attention."""
    from repro_torch.core.config import BLOCK_SHARED_ATTN
    from repro_torch.launch.train import build_lm_trainer

    a, b = (build_lm_trainer(arch, smoke=True, steps=steps, device="cuda",
                             chunk_steps=k) for k in (1, 4))
    a.run(steps)
    b.run(steps)
    out = same_runs(torch, a, b, f"{arch} chunked")
    blocks = a.exp.model.blocks
    gated = sum(kind != BLOCK_SHARED_ATTN
                for kind in blocks[1:-1])       # first and last forced
    nodes = b._chunk_fn.cond.nodes
    if nodes != 2 * gated:
        fail(f"{arch} chunked: {nodes} IF nodes for {gated} unforced gated "
             "sub-blocks (one node in the forward, one in the backward)")
    skipped = sum(0.0 in h["slu_executed"] for h in a.history)
    out.update(if_nodes=nodes, gated_sub_blocks=gated,
               steps_skipping_a_sub_block=skipped)
    return out


def ssm_check(torch, mods):
    """Phase 16: the SSM family at the published widths, ``--e2train
    full``, ``remat="block"``, bf16 activations.  The mixers at full width
    card against CPU (:func:`ssm_mixer_check`); kernels 5-6 at zamba2's
    shared-attention projections and 7-9 at its attention geometry (hd 64,
    32 heads, g = 1) with phase 4's limits, timed, not counted; a reduced
    step of each arch at :data:`SSM_REF_SEQ` tokens on the card against the
    CPU; then the main paths of :data:`SSM_PATHS`, each with its reckoned
    state: zamba2-1.2b's launches of kernels 5-9 equal its shared
    attention's (two calls a microbatch, never gated: four PSG matmuls and
    kernel 7 twice, 8 and 9 once, a call), xlstm-350m launching none of the
    ten; each profiled (device events only: its steps launch several
    hundred thousand kernels).  Last, the reduced archs through the chunked
    loop (:func:`ssm_chunked_check`)."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch.train import build_lm_trainer, lm_experiment
    from repro_torch.models.layers import attention_path

    t_start = time.perf_counter()
    out = {"mixers": ssm_mixer_check(torch)}
    print(json.dumps({"phase": "ssm_mixers", **out["mixers"]}), flush=True)
    for arch, (layers, batch, seq) in SSM_PATHS.items():
        exp = lm_experiment(arch, num_layers=layers, batch=batch, seq=seq)
        m, micro = exp.model, exp.train.microbatches
        calls = m.blocks.count("shared_attn")
        r = {"layers": m.num_layers, "microbatches": micro,
             "unit": list(m.block_unit),
             "attention": attention_path(m, exp.e2.psg, seq) if calls
             else None, "reckoned": reckoned_state_bytes(exp)}
        if calls:
            d = m.d_model
            sites = {(d, m.num_heads * m.resolved_head_dim):
                     4 * calls * micro}
            ptot, prows, _ = check_psg_matmul_kernels(
                torch, PM, sites, None, batch // micro * seq, {},
                path=f"{arch}_shared_attention", worst_cases=False)
            geo = attention_geometry(arch, m, batch // micro, seq, calls,
                                     micro)
            ftot, frows = check_flash_kernels(torch, FA, [geo],
                                              extra_checks=False)
            r.update(psg_matmul_rows=prows, flash_rows=frows,
                     totals={**kernel_totals(ptot), **kernel_totals(ftot)})
        print(json.dumps({"phase": f"ssm_{arch}_kernels", **r}), flush=True)
        r["reference"] = lm_reference_check(torch, None, arch=arch,
                                            seq=SSM_REF_SEQ)
        print(json.dumps({"phase": f"ssm_{arch}_reference",
                          **r["reference"]}), flush=True)
        if not r["reckoned"]["fits"]:
            fail(f"{arch}: reckoned state {r['reckoned']} does not fit")
        kernels = list(PM.LAUNCHES) + list(FA.LAUNCHES)
        trainer, main, prof = run_path(
            torch, f"ssm_{arch}_main_path",
            lambda steps: build_lm_trainer(arch, num_layers=layers,
                                           batch=batch, seq=seq, steps=steps,
                                           device="cuda"),
            mods, kernels if calls else [],
            absent=[] if calls else [n for mod in mods
                                     for n in mod.LAUNCHES],
            execute=2, cpu_ops=False)
        tc = trainer.exp.train
        if (tc.global_batch, tc.seq_len, tc.microbatches, tc.remat,
                trainer.exp.model.dtype) != \
                (batch, seq, micro, "block", "bfloat16"):
            fail(f"{arch} trained {tc}")
        del trainer
        per_call = {"predictor_matmul": 4, "psg_grad_w": 4, "flash_fwd": 2,
                    "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        passes = main["executed"] * micro
        want = {k: v * calls * passes for k, v in per_call.items()}
        got = {k: main["launches"][k] for k in want}
        if got != want:
            fail(f"{arch}: launches {got}, {calls} shared-attention calls "
                 f"in each of {passes} passes want {want}")
        r.update(main_path=main, profile=prof,
                 shared_attention_launches={"calls_per_pass": calls,
                                            "passes": passes, **got})
        out[arch] = r
    out["chunked"] = {arch: ssm_chunked_check(torch, arch)
                      for arch in SSM_PATHS}
    print(json.dumps({"phase": "ssm_chunked", **out["chunked"]}), flush=True)
    out["seconds"] = time.perf_counter() - t_start
    return out


# phase 17: serving, bf16 greedy at full width and full depth; prompt
# lengths hold the reference's rules (Mamba2 above 256 tokens a multiple of
# 256), prompts drawn from SERVE_SEED
SERVE_SEED = 0
SERVE_32K = 32768       # prefill_32k's length, its batch cut from 32 to 1
SERVE_ZAMBA_HANDOFF = 255   # the Mamba2 handoff: S and S + 1 both allowed
# the handoff at full width, of max|logit| of the real vocabulary, the
# limits of tests/test_torch_serve_engine.py: bf16, BF16_REL (two bf16
# roundings of activations summed in other orders: 9.2e-3 at most on the
# CPU against the JAX package); zamba2-1.2b in fp32 activations,
# ZAMBA_FP32_REL (its bf16 handoff, chunked SSD against the recurrent step,
# differs by 4-19% in the port and 4.5-58% in the JAX package on the
# reduced model: no check; fp32 3e-4 at most).  The greedy tokens agree
# wherever the top-2 margin exceeds the limit
SERVE_BF16_REL = 2e-2
SERVE_ZAMBA_FP32_REL = 1e-3
# the reduced archs, fp32, card against CPU: with fp32 probabilities the
# same fp32 operations in other orders, at the limits the CPU tests hold
# the port to the JAX package (SERVE_REL; zamba2's real 19-block unit
# 1e-4, test_torch_ssm.py); as served, the bf16 rounding of the
# probabilities may flip on one side (LM_EVAL_REL)
SERVE_REL = {"zamba2_1_2b": 1e-4}
SERVE_REL_DEFAULT = 1e-5
SERVE_REF_STEPS = 4


def serve_paths():
    """The four serving paths of phase 17: name -> (arch, slots, requests
    as (prompt length, max_new), max_len)."""
    import numpy as np

    rng = np.random.RandomState(SERVE_SEED)
    qwen = [(int(rng.randint(1024, 2049)), 32 if i % 2 == 0 else 16)
            for i in range(8)]
    return {
        "qwen2_5_3b_engine": ("qwen2_5_3b", 4, qwen, 2088),
        "qwen2_5_3b_prefill_32k": ("qwen2_5_3b", 1, [(SERVE_32K, 16)],
                                   SERVE_32K + 16 + 8),
        "zamba2_1_2b_engine": ("zamba2_1_2b", 4, [(1024, 32)] * 4,
                               1024 + 32 + 8),
        "h2o_danube_3_4b_engine": ("h2o_danube_3_4b", 1, [(6144, 16)],
                                   6144 + 16 + 8),
    }


def reckoned_decode_state_bytes(m, batch: int, max_len: int,
                                cache_bytes: int = 2) -> int:
    """Bytes of a decode state from the config alone: per ``attn``, ``moe``
    or ``shared_attn`` layer two caches of ``min(max_len, window)`` slots
    (``cache_bytes`` an element), per Mamba2 layer its fp32 H (nh, state,
    hd) and conv buffer (W - 1, di), per mLSTM its fp32 C, n and m, per
    sLSTM its four fp32 (d,) vectors."""
    from repro_torch.models import ssm as S

    slots = min(max_len, m.sliding_window) if m.sliding_window else max_len
    total = 0
    for kind in m.blocks:
        if kind == "mamba":
            di, nh, hd = S._mamba_dims(m)
            total += 4 * batch * (nh * m.ssm_state * hd
                                  + (m.ssm_conv_width - 1) * di)
        elif kind == "mlstm":
            _, nh, hd = S._mlstm_dims(m)
            total += 4 * batch * nh * (hd * hd + hd + 1)
        elif kind == "slstm":
            total += 4 * 4 * batch * m.d_model
        else:
            total += 2 * batch * slots * m.num_kv_heads \
                * m.resolved_head_dim * cache_bytes
    return total


def state_bytes(state) -> int:
    """Bytes of a decode state's per-layer tensors (``pos`` apart)."""
    from repro_torch.convert import leaves
    return sum(t.numel() * t.element_size()
               for _, t in leaves(state["layers"]))


def _served(torch, model, toks, fe, feed=None):
    """``prefill_to_state`` of ``toks`` (and the frontend ``fe``: the
    encoder's input or the prepended patches) then
    :data:`SERVE_REF_STEPS` decode steps on ``model``'s device, fp32
    caches, fed ``feed``'s tokens or, without, the greedy ones: (logits of
    each call, the tokens fed)."""
    from repro_torch.models import transformer as T

    dev = model.embed.device
    f = None if fe is None else fe.to(dev)
    mem = None
    if model.cfg.encoder_layers:
        with torch.no_grad():
            mem, f = model.encode(f), None
    lg, st = T.prefill_to_state(model, toks.to(dev), 32, memory=mem,
                                frontend=f, cache_dtype=torch.float32)
    seq, fed = [lg], []
    for i in range(SERVE_REF_STEPS):
        nxt = feed[i] if feed else lg[:, 0].argmax(-1)[:, None].int().cpu()
        lg, st = T.decode_step(model, nxt.to(dev), st, mem)
        seq.append(lg)
        fed.append(nxt)
    return seq, fed


def serve_reduced_check(torch) -> dict:
    """Phase 17: every arch of ``ARCH_IDS`` reduced, fp32: prefill (16
    tokens, the frontends of whisper and phi-3-vision) and
    :data:`SERVE_REF_STEPS` greedy decode steps (the CPU's tokens fed to
    both) on the card against the CPU, from the same parameters: the
    logits within :data:`SERVE_REL` (default :data:`SERVE_REL_DEFAULT`)
    with the probabilities in fp32 on both sides, within ``LM_EVAL_REL``
    as served."""
    import copy

    from repro_torch.configs import ARCH_IDS, get_experiment, \
        reduce_experiment
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    fp32_softmax = type("Softmax", (), {
        "apply": staticmethod(lambda s: torch.softmax(s, dim=-1))})
    out = {}
    for arch in ARCH_IDS:
        m = reduce_experiment(get_experiment(arch)).model
        cpu = T.TransformerLM(m, seed=0)
        card = copy.deepcopy(cpu).to("cuda")
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, m.vocab_size, (2, 16), generator=g,
                             dtype=torch.int32)
        fe = torch.randn(2, m.frontend_tokens, m.d_model, generator=g) \
            if m.frontend else None
        errs = {}
        for served in (False, True):
            saved = L.SoftmaxLowp
            if not served:
                L.SoftmaxLowp = fp32_softmax
            try:
                want, fed = _served(torch, cpu, toks, fe)
                got, _ = _served(torch, card, toks, fe, fed)
            finally:
                L.SoftmaxLowp = saved
            errs["served" if served else "fp32_probabilities"] = max(
                rel_err(a, b) for a, b in zip(got, want))
        limit = SERVE_REL.get(arch, SERVE_REL_DEFAULT)
        if not errs["fp32_probabilities"] <= limit or \
                not errs["served"] <= LM_EVAL_REL:
            fail(f"serving {arch} reduced, card against CPU: logits "
                 f"{errs} of max|logit| (limits {limit}, {LM_EVAL_REL})")
        out[arch] = errs
    return out


def handoff_check(torch, model, toks, max_len, dtype="bfloat16",
                  limit=SERVE_BF16_REL) -> dict:
    """``decode_step`` on token S + 1 (the greedy one) after
    ``prefill_to_state(S)`` against ``prefill_to_state(S + 1)``'s logits,
    activations and caches in ``dtype`` (the parameters as they are),
    within ``limit`` of max|logit| over the real vocabulary; the greedy
    tokens agree wherever the reference's top-2 margin exceeds that."""
    import dataclasses

    from repro_torch.models import transformer as T

    cfg = model.cfg
    n, cdt = cfg.vocab_size, getattr(torch, dtype)
    model.cfg = dataclasses.replace(cfg, dtype=dtype)
    try:
        lg, st = T.prefill_to_state(model, toks, max_len, cache_dtype=cdt)
        nxt = lg[:, 0].argmax(-1)[:, None].int()
        lg_dec = T.decode_step(model, nxt, st)[0][:, 0, :n]
        del st
        lg_ref = T.prefill_to_state(model, torch.cat([toks, nxt], 1),
                                    max_len, cache_dtype=cdt)[0][:, 0, :n]
    finally:
        model.cfg = cfg
    err = rel_err(lg_dec, lg_ref)
    top2 = lg_ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > limit * lg_ref.abs().max()
    agree = lg_dec.argmax(-1) == lg_ref.argmax(-1)
    if not err <= limit or not bool(agree[sure].all()):
        fail(f"serving {cfg.name}: the {dtype} handoff at S = "
             f"{toks.shape[1]} differs by {err:.3g} of max|logit| (limit "
             f"{limit}) or its tokens differ ({agree.tolist()}) where the "
             "margin exceeds it")
    return {"tokens": list(toks.shape), "dtype": dtype, "rel_err": err,
            "limit": limit, "rows_beyond_margin": int(sure.sum()),
            "tokens_agree": agree.tolist()}


class _Timed:
    """``fn`` with CUDA events recorded around each call on the current
    stream (no synchronization: read after the run) and the host's time
    to return from it; keeps the last call's arguments."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.events, self.host_s, self.args = [], [], None

    def __call__(self, *args):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.host_s.append(time.perf_counter() - t0)
        ev[1].record()
        self.events.append(ev)
        self.args = args
        return out

    def device_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def serve_path(torch, mods, name, model, exp, slots, reqs, max_len) -> dict:
    """One serving main path: ``ServeEngine`` over ``reqs`` (prompt
    length, max_new) from ``SERVE_SEED``, every launch counter zeroed just
    before and read just after (serving reaches no kernel: each must stay
    0); each request gets exactly its ``max_new`` tokens, the clones are
    dropped.  Recorded: prefill ms a wave and decode ms a step (CUDA events
    around each call, the device's interval), the host's ms to enqueue a
    decode step, output tokens/s, peak memory, the decode state's bytes
    allocated against reckoned; then one more decode step under
    ``set_sync_debug_mode("error")`` and one profiled."""
    import gc

    import numpy as np

    from repro_torch.serving import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(exp, model, batch_slots=slots, max_len=max_len,
                         device="cuda")
    engine.prefill = prefill = _Timed(torch, engine.prefill)
    engine.decode = decode = _Timed(torch, engine.decode)
    rng = np.random.RandomState(SERVE_SEED + 1)
    m = exp.model
    for i, (plen, max_new) in enumerate(reqs):
        engine.submit(Request(rid=i, prompt=rng.randint(0, m.vocab_size,
                                                        size=plen),
                              max_new=max_new))
    reset_all(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    if any(launches.values()):
        fail(f"serving {name} launched kernels {launches}")
    if sorted(r.rid for r in done) != list(range(len(reqs))) or any(
            len(r.out) != mx for r, (_, mx) in zip(
                sorted(done, key=lambda r: r.rid), reqs)):
        fail(f"serving {name}: requests {[(r.rid, len(r.out)) for r in done]}"
             f" against {reqs}")
    tokens = sum(len(r.out) for r in done)
    waves = -(-len(reqs) // slots)
    per_wave = [max(mx for _, mx in reqs[w * slots:(w + 1) * slots]) - 1
                for w in range(waves)]
    dec_ms = decode.device_ms()
    later = [t for w in range(waves) for t in
             dec_ms[sum(per_wave[:w]) + 1:sum(per_wave[:w + 1])]]
    token, state = decode.args[1], decode.args[2]
    out = {"arch": exp.model.name, "layers": m.num_layers, "slots": slots,
           "requests": len(reqs), "prompt_lengths": [p for p, _ in reqs],
           "max_new": [x for _, x in reqs], "max_len": max_len,
           "waves": waves, "run_s": wall, "output_tokens": tokens,
           "output_tokens_per_s": tokens / wall,
           "prefill_ms_per_wave": prefill.device_ms(),
           "decode_steps": len(dec_ms),
           "decode_ms_per_step": sum(later) / len(later),
           "decode_ms_first": [dec_ms[sum(per_wave[:w])]
                               for w in range(waves)],
           "host_ms_per_decode_step":
               1e3 * sum(decode.host_s) / len(decode.host_s),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "state_gb_allocated": state_bytes(state) / 1e9,
           "state_gb_reckoned": reckoned_decode_state_bytes(
               m, slots, max_len) / 1e9,
           "launches": launches}
    if state_bytes(state) != reckoned_decode_state_bytes(m, slots, max_len):
        fail(f"serving {name}: decode state {out['state_gb_allocated']} GB"
             f" allocated, {out['state_gb_reckoned']} GB reckoned")
    wave_tokens = prefill.args[1]
    prefill.args = engine = None
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        lg, _ = decode.fn(model, token, state)
        host = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(lg[..., :m.vocab_size]).all()):
        fail(f"serving {name}: non-finite logits in the sync-checked step")
    out["sync_free_step"] = {"sync_debug_mode": "error",
                             "host_ms_from_idle": 1e3 * host,
                             "ms": 1e3 * (time.perf_counter() - t0)}
    out["profile"] = profile_fn(torch, lambda: decode.fn(model, token, state))
    if any(mod.LAUNCHES[n] for mod in mods for n in mod.LAUNCHES):
        fail(f"serving {name}: a kernel was launched in the profiled step")
    decode.args = None
    return out, wave_tokens


def serving_check(torch, mods):
    """Phase 17: serving (``serving/engine.py``) in bf16, greedy, at full
    width and full depth: the reduced archs card against CPU
    (:func:`serve_reduced_check`), then the paths of :func:`serve_paths`
    through :func:`serve_path`, and the handoff at full width
    (:func:`handoff_check`) on each engine path's last wave: qwen2.5-3b's
    4 left-padded slots, zamba2-1.2b's 4 slots cut to their first
    :data:`SERVE_ZAMBA_HANDOFF` tokens (in fp32 activations), and
    h2o-danube-3-4b's 6,144-token request, whose 4,096-slot ring has
    wrapped."""
    import gc

    from repro_torch.configs import get_experiment
    from repro_torch.models.transformer import TransformerLM

    t_start = time.perf_counter()
    out = {"card": card_line(), "reduced": serve_reduced_check(torch)}
    print(json.dumps({"phase": "serving_reduced", **out["reduced"]}),
          flush=True)
    q = get_experiment("qwen2_5_3b").model
    out["decode_32k_reckoned"] = {
        "batch": 128, "kv_len": SERVE_32K, "gb": reckoned_decode_state_bytes(
            q, 128, SERVE_32K) / 1e9, "card_gb": CARD_BYTES / 1e9}
    built = None
    for name, (arch, slots, reqs, max_len) in serve_paths().items():
        exp = get_experiment(arch)
        if built is None or built[0] != arch:
            built = model = None
            gc.collect()
            torch.cuda.empty_cache()
            built = (arch, TransformerLM(exp.model, exp.e2, seed=0,
                                         device="cuda"))
        model = built[1]
        r, toks = serve_path(torch, mods, name, model, exp, slots, reqs,
                             max_len)
        if arch == "zamba2_1_2b":
            r["handoff"] = handoff_check(
                torch, model, toks[:, :SERVE_ZAMBA_HANDOFF], max_len,
                "float32", SERVE_ZAMBA_FP32_REL)
        elif name.endswith("_engine"):
            r["handoff"] = handoff_check(torch, model, toks, max_len)
        r["card"] = out["card"]
        print(json.dumps({"phase": f"serving_{name}", **r}), flush=True)
        out[name] = r
    built = model = None
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 18: distribution
# ---------------------------------------------------------------------------

DIST_EXECUTED = 4       # executed steps of each run
DIST_LOSS_REL = 1e-4    # two ranks against one, PSG on: losses, relative
DIST_SGDM_REL = 2e-3    # the same, PSG off under sgdm (tests/test_loop.py)
DIST_RANK_FLAG = "--distributed-rank"
DIST_TIMEOUT_S = 120    # seconds a collective may wait
DIST_KILL_STEPS, DIST_KILL_AT = 12, 10
DIST_KILL_DEPTH = 20    # the launcher's ResNet of the kill and restart
COLLECTIVE_MARKS = ("gloo", "nccl", "all_reduce", "allreduce", "all_gather",
                    "allgather")
# the two-rank LM on sharded parameters: qwen2.5-3b at full width, its
# depth cut for the script's time, one row of 4096 tokens a rank
DIST_LM_LAYERS, DIST_LM_EXECUTED = 2, 3
# the caching allocator rounds a block up to 512 bytes, and leaves a block
# of the large pool (above 1 MiB) unsplit where less than 1 MiB would
# remain: a rank's bytes between steps may exceed the reckoning by that
# much a state tensor
ALLOC_ROUND, ALLOC_LARGE = 512, 1 << 20
LM_KERNELS = ("predictor_matmul", "psg_grad_w", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv")


def reduce_path_check(torch) -> dict:
    """Kernels 3-6 as a mesh runs them: each wrapper on one rank's half of
    the rows, with ``reduce`` adding the other half's exact int64 sums (what
    the all-reduce of two ranks gives), against the plain version on all
    the rows, bit for bit (pass 1's fp32 product, the signs and the flags),
    at every ResNet-74 batch-128 conv geometry and at qwen2.5-3b
    weight-matmul geometries at 8192 tokens, random codes at their
    widths."""
    from repro_torch.configs.paper_cnns import resnet_conv_shapes
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import psg_matmul as PM
    gen = torch.Generator(device="cuda").manual_seed(18)

    def codes(shape, lim, dtype):
        return torch.randint(-lim, lim + 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32).to(dtype)

    def adding(other):
        return lambda t: t.add_(other)

    def same(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                fail(f"{what}: the reduced path differs from the plain "
                     f"version on all the rows")

    n_conv = 0
    for c in resnet_conv_shapes(DEPTH, WIDTH, BATCH):
        k, st, hw = c.k, c.stride, c.hw
        if k < st:                      # the subsampled 1x1 shortcut
            hw, st = -(-hw // st), 1
        hp = hw + 2 * (k // 2)
        ho = (hp - k) // st + 1
        h = c.batch // 2
        xm = codes((c.batch, hp, hp, c.cin), 7, torch.int8)
        gm = codes((c.batch, ho, ho, c.cout), 511, torch.int16)
        xq = codes((c.batch, hp, hp, c.cin), 127, torch.int8)
        gq = codes((c.batch, ho, ho, c.cout), 32767, torch.int16)
        rest = lambda x, g: K._code_product(x[h:], g[h:], k, st).to(
            torch.int64)
        pred = K.conv_grad_w_predictor(xm[:h], gm[:h], k, st,
                                       adding(rest(xm, gm)))
        want = K.conv_grad_w_predictor_plain(xm, gm, k, st)
        same([pred], [want], f"kernel 3 at {c}")
        tau = 0.05 * want.abs().amax()
        got = K.conv_grad_w(pred, xq[:h], gq[:h], tau, k, st,
                            adding(rest(xq, gq)))
        same(got, K.conv_grad_w_plain(want, xq, gq, tau, k, st),
             f"kernel 4 at {c}")
        n_conv += 1
    from repro_torch.configs import get_experiment
    m = get_experiment(LM_ARCH).model
    sites = sorted(lm_matmul_sites(m.d_model, m.num_heads, m.num_kv_heads,
                                   m.resolved_head_dim, m.d_ff, 1))
    N = LM_BATCH * LM_SEQ
    for din, dout in sites:
        h = N // 2
        xm, gm = codes((N, din), 7, torch.int8), codes((N, dout), 511,
                                                       torch.int16)
        xq, gq = codes((N, din), 127, torch.int8), codes((N, dout), 32767,
                                                         torch.int16)
        rest = lambda x, g: PM._code_product(x[h:], g[h:]).to(torch.int64)
        pred = PM.predictor_matmul(xm[:h], gm[:h], adding(rest(xm, gm)))
        want = PM.predictor_matmul_plain(xm, gm)
        same([pred], [want], f"kernel 5 at {(din, dout)}")
        tau = 0.05 * want.abs().amax()
        got = PM.psg_grad_w(pred, xq[:h], gq[:h], tau, adding(rest(xq, gq)))
        same(got, PM.psg_grad_w_plain(want, xq, gq, tau),
             f"kernel 6 at {(din, dout)}")
    torch.cuda.synchronize()
    return {"conv_geometries": n_conv, "matmul_geometries": sites,
            "tokens": N, "bitwise_equal": True}


def _launch_counts(mods) -> dict:
    return {n: c for mod in mods for n, c in mod.LAUNCHES.items()}


def mesh_pair(torch, build, mods, kernels, executed, what, mesh, smd=True,
              profile=True):
    """The same nominal steps on the one-rank mesh and without a mesh, both
    through the chunked loop (``CHUNK_K``), compared bit for bit, with
    every launch counter zeroed before each run and equal after; each
    run's graph is released before the next (two captured steps of the LM
    do not fit beside the earlier phases' memory), and with ``profile`` one
    more executed step of the mesh run, captured anew, is profiled for
    collectives."""
    import gc
    steps = nominal_steps(executed, smd)
    runs, launches = [], []
    for m in (mesh, None):
        gc.collect()
        torch.cuda.empty_cache()
        tr = build(steps, m)
        reset_all(mods)
        tr.run(steps)
        torch.cuda.synchronize()
        launches.append(_launch_counts(mods))
        release(tr)
        runs.append(tr)
    for name in kernels:
        if launches[0][name] <= 0:
            fail(f"{what}: kernel {name} was not launched on the mesh")
    if launches[0] != launches[1]:
        fail(f"{what}: launches differ on the one-rank mesh: {launches[0]} "
             f"against {launches[1]}")
    out = same_runs(torch, runs[1], runs[0], what)
    ms = [1e3 * sum(h["wall_s"] for h in t.history[CHUNK_K:])
          / max(len(t.history) - CHUNK_K, 1) for t in runs]
    out.update({"nominal_steps": steps, "launches": launches[0],
                "ms_per_executed_step": ms[1],
                "mesh_ms_per_executed_step": ms[0],
                "losses": [h["loss"] for h in runs[0].history]})
    if profile:
        del runs[1]
        gc.collect()
        torch.cuda.empty_cache()
        out["mesh_profiled_step"] = _collective_share(
            torch, lambda: runs[0].run(_to_next_kept(runs[0])))
        if out["mesh_profiled_step"]["collective_calls"]:
            fail(f"{what}: collectives on a one-rank mesh: "
                 f"{out['mesh_profiled_step']}")
        release(runs[0])
    return out


def _to_next_kept(trainer) -> int:
    """Nominal steps from the trainer's step to its next executed one."""
    steps = 1
    while not trainer.keeps(trainer.state.step + steps - 1):
        steps += 1
    return steps


def _wgrad_recorder(ops, K):
    """Wrap the PSG conv weight-gradient op (``kernels/ops.conv_grad_w``)
    and kernel 4's wrapper so that, while ``rec["on"]``, each op call keeps
    its inputs (this rank's rows of x and gy), its sign and its kernel-4
    flags, on the host; the wrappers still count their launches."""
    rec = {"on": False, "calls": []}
    op, k4 = ops.conv_grad_w, K.conv_grad_w

    def flags(*a, **kw):
        sign, stats = k4(*a, **kw)
        rec["flags"] = stats
        return sign, stats

    def recorded(xp, gy, cfg, k, stride, plain=False):
        sign, fb = op(xp, gy, cfg, k, stride, plain)
        if rec["on"]:
            keep = {"x": xp.cpu(), "g": gy.cpu()} if rec["inputs"] else {}
            rec["calls"].append({**keep, "k": k, "stride": stride,
                                 "sign": sign.cpu(),
                                 "flags": rec["flags"].cpu()})
        return sign, fb

    ops.conv_grad_w, K.conv_grad_w = recorded, flags
    return rec


def _collective_share(torch, fn) -> dict:
    """``fn()`` under torch.profiler: the host intervals of the collective
    calls (their union), their count and their share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ev = sorted((e for e in prof.events()
                 if any(k in e.name.lower() for k in COLLECTIVE_MARKS)),
                key=lambda e: e.time_range.start)
    busy, end, top = 0.0, float("-inf"), 0
    for e in ev:
        a, b = e.time_range.start, e.time_range.end
        if a >= end:
            top += 1
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"wall_ms": wall_ms, "collective_intervals": top,
            "collective_calls": sum(1 for e in ev if e.name.startswith(
                ("gloo:", "nccl:"))),
            "collective_ms": busy / 1e3,
            "collective_share": busy / 1e3 / wall_ms,
            "names": sorted({e.name for e in ev})[:8]}


ROW_ORDERS = {      # the global batch's rows in another order (one rank)
    "halves_swapped": lambda B: list(range(B // 2, B)) + list(range(B // 2)),
    "reversed": lambda B: list(range(B - 1, -1, -1)),
}
# the reordered runs are samples of a chaotic spread: a step's distance of
# the two-rank run, one more such sample, may reach twice their largest
DIST_SPREAD_FACTOR = 2.0


def _resnet_runs(torch, mods, mesh, rec, order=None) -> dict:
    """ResNet-74 (batch 128) with ``--e2train`` ``full`` and ``off``, each
    for the nominal steps that execute ``DIST_EXECUTED``, on ``mesh`` (or
    without); the first executed step's PSG conv calls recorded (``rec``,
    their inputs too unless ``order``); ``order`` (of ``ROW_ORDERS``, one
    rank) feeds each batch's rows in that order: the same global step,
    every sum over the batch in another order."""
    from repro_torch.launch.train import E2TRAIN, build_trainer
    out = {}
    rec["inputs"] = order is None
    for name in ("full", "off"):
        e2 = E2TRAIN[name]
        steps = nominal_steps(DIST_EXECUTED, e2.smd.enabled)
        tr = build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda", e2=e2,
                           mesh=mesh)
        if order is not None:
            rows = torch.tensor(ROW_ORDERS[order](BATCH), device="cuda")
            draw = tr.make_batch
            tr.make_batch = lambda step, shard: {
                k: v.index_select(0, rows) for k, v in
                draw(step, shard).items()}
        reset_all(mods)
        rec["on"], rec["calls"] = name == "full", []
        for _ in range(DIST_EXECUTED):
            tr.run(_to_next_kept(tr))
            rec["on"] = False
        if tr.state.step != steps:
            fail(f"ResNet-74 ({name}) ran {tr.state.step} nominal steps, "
                 f"not {steps}")
        torch.cuda.synchronize()
        hist = tr.history
        out[name] = {
            "loss": [h["loss"] for h in hist],
            "total_loss": [h["total_loss"] for h in hist],
            "slu_executed": [h["slu_executed"] for h in hist],
            "executed": tr.executed_steps, "dropped": tr.dropped_steps,
            "launches": _launch_counts(mods),
            "ms_per_executed_step": 1e3 * sum(h["wall_s"] for h in hist[1:])
            / max(len(hist) - 1, 1),
            "wgrad": list(rec["calls"])}
        if name == "full" and mesh is not None:
            out["profiled"] = _collective_share(
                torch, lambda: tr.run(_to_next_kept(tr)))
        del tr
    return out


def lm_dist_experiment():
    """qwen2.5-3b at full width, ``DIST_LM_LAYERS`` deep, flash,
    ``--e2train full`` with ``int8_gather``, ``remat="block"`` (the
    experiment's), a global batch of 2 x 4096."""
    import dataclasses

    from repro_torch.launch.train import E2TRAIN, lm_experiment
    e2 = E2TRAIN["full"]
    e2 = dataclasses.replace(e2, psg=dataclasses.replace(e2.psg,
                                                         int8_gather=True))
    exp = lm_experiment(LM_ARCH, num_layers=DIST_LM_LAYERS, batch=LM_BATCH,
                        seq=LM_SEQ, steps=nominal_steps(DIST_LM_EXECUTED),
                        fused_attention=True, e2=e2)
    if exp.train.remat != "block":
        fail(f"the LM trains with remat {exp.train.remat!r}, not 'block'")
    return exp


def lm_state_reckoning(exp, world: int) -> dict:
    """The bytes of one rank's state between steps, from the config alone
    (a model on the ``meta`` device): its shards of the FSDP leaves and
    its replicated leaves, of the parameters, moments and SWA average
    (``sharded``); the old placement, every parameter whole and the rest
    sharded (``whole_copy``); and the state's tensor count."""
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.training.train_step import train_state_for
    model = TransformerLM(exp.model, exp.e2, device="meta")
    st = train_state_for(exp, model)
    named = dict(model.named_parameters())
    mesh = sharding.AbstractMesh((world, 1), ("data", "model"))
    dims = {k: sharding.shard_dim(sp) for k, sp in sharding.param_specs(
        named, mesh, True, model.unit).items()}
    size = lambda t: t.numel() * t.element_size()
    part = lambda k, t: size(t) // (1 if dims[k] is None else world)
    rest = [(n, t) for d in (st.opt, st.swa or {}) for v in d.values()
            if isinstance(v, dict) for n, t in v.items()]
    rest_b = sum(part(n, t) for n, t in rest)
    parts = [part(k, t) for k, t in list(named.items()) + rest]
    return {"sharded": sum(part(k, p) for k, p in named.items()) + rest_b,
            "whole_copy": sum(size(p) for p in named.values()) + rest_b,
            "tensors": len(parts),
            "slack": sum(ALLOC_LARGE if b > ALLOC_LARGE else ALLOC_ROUND
                         for b in parts),
            "sharded_leaves": sum(d is not None for d in dims.values())}


def allocated(torch) -> int:
    """``memory_allocated()`` with cuBLAS's workspaces (which the caching
    allocator holds from a stream's first matmul on, 64 MiB on the card)
    given back first."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def lm_dist_run(torch, mods, mesh, fsdp=True) -> dict:
    """The two-rank LM (:func:`lm_dist_experiment`) on ``mesh``, or the
    same without one; with ``fsdp`` off, every parameter replicated (the
    reference's ``fsdp=False``: nothing gathered, every gradient summed
    after the backward): ``DIST_LM_EXECUTED`` executed steps, one at a
    time; the bytes allocated between steps (above those before the
    trainer was built, :func:`allocated`), each step's peak, the losses,
    the launches of kernels 5-9 over the steps, and the gathers' record
    (``distributed/fsdp.STATS``)."""
    import gc

    from repro_torch.distributed.fsdp import STATS, DataParallel
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.launch.train import build_lm_trainer
    exp = lm_dist_experiment()
    gc.collect()
    torch.cuda.empty_cache()
    base = allocated(torch)
    t0 = time.perf_counter()
    tr = build_lm_trainer(LM_ARCH, num_layers=DIST_LM_LAYERS,
                          batch=LM_BATCH, seq=LM_SEQ,
                          steps=exp.train.total_steps, device="cuda",
                          fused_attention=True, e2=exp.e2,
                          mesh=mesh if fsdp else None)
    if tr.exp != exp:
        fail("the two-rank LM's trainer runs another experiment")
    if mesh is not None and not fsdp:       # Trainer(mesh=)'s placement
        tr.mesh = mesh
        tr.state = reshard_state(tr.state, mesh, fsdp=False)
        tr.dp = DataParallel(mesh, tr.state.model, fsdp=False)
        tr.rank, tr.world = tr.dp.rank, tr.dp.world
    between = [allocated(torch) - base]
    peaks = []
    reset_all(mods)
    STATS.reset()
    for _ in range(DIST_LM_EXECUTED):
        torch.cuda.reset_peak_memory_stats()
        tr.run(_to_next_kept(tr))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        between.append(allocated(torch) - base)
    launches = {k: v for k, v in _launch_counts(mods).items()
                if k in LM_KERNELS}
    out = {"loss": [h["loss"] for h in tr.history],
           "slu_executed": [h["slu_executed"] for h in tr.history],
           "between_steps_bytes": between, "step_peak_bytes": peaks,
           "launches": launches,
           "gathers": STATS.gathers,
           "whole_peak_bytes": STATS.peak,
           "wire_bytes_received": dict(STATS.wire),
           "wire_bytes_per_gather": {
               k: v / max(STATS.gathers, 1) for k, v in STATS.wire.items()},
           "reduced_fp32_bytes": STATS.reduced,
           "ms_per_executed_step": 1e3 * sum(
               h["wall_s"] for h in tr.history[1:])
           / max(len(tr.history) - 1, 1),
           "seconds": time.perf_counter() - t0}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_rank_main(argv) -> None:
    """One rank of the phase's two-rank world (this script run with
    ``DIST_RANK_FLAG RANK WORLD PORT OUT``): gloo on CUDA tensors on the
    one card; saves what :func:`_resnet_runs` gives to OUT."""
    import datetime

    import torch
    import torch.distributed as dist
    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.kernels import quant as Q
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world, 1), ("data", "model"))
    from repro_torch.kernels import ops
    res = _resnet_runs(torch, (K, PM, FA, Q), mesh, _wgrad_recorder(ops, K))
    res["lm"] = lm_dist_run(torch, (K, PM, FA, Q), mesh)
    res["lm_replicated"] = lm_dist_run(torch, (K, PM, FA, Q), mesh,
                                       fsdp=False)
    res["backend"] = dist.get_backend()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _two_rank_world(torch, d) -> list:
    """This script's two ranks on the card; their saved results."""
    from repro_torch.ft.supervisor import free_tcp_port
    port = free_tcp_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [os.path.join(d, f"rank{r}.log") for r in range(2)]
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), DIST_RANK_FLAG, str(r),
         "2", str(port), d], env=env, stdout=f, stderr=subprocess.STDOUT)
        for r, f in enumerate(files)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"rank {r} of the two-rank world exited {p.returncode}: "
                 + Path(logs[r]).read_text()[-3000:])
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _replay_ops(torch, ranks, rec) -> dict:
    """Each conv of the two ranks' first step once more on one rank, on
    the two ranks' rows of x and gy together: its signs and flags must be
    the ranks' bit for bit (the global computation of the same rows)."""
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels import ops
    cfg = PSGConfig(enabled=True)
    a, b = ranks
    if len(a) != len(b) or not a:
        fail(f"the ranks recorded {len(a)} and {len(b)} convs")
    for i, (ca, cb) in enumerate(zip(a, b)):
        if not (torch.equal(ca["sign"], cb["sign"])
                and torch.equal(ca["flags"], cb["flags"])):
            fail(f"conv {i}: the two ranks' signs or flags differ")
        x = torch.cat([ca["x"], cb["x"]]).cuda()
        g = torch.cat([ca["g"], cb["g"]]).cuda()
        sign, _ = ops.conv_grad_w(x, g, cfg, ca["k"], ca["stride"])
        sign, flags = sign.cpu(), rec["flags"].cpu()    # the recorder's
        if not (torch.equal(sign, ca["sign"])
                and torch.equal(flags, ca["flags"])):
            fail(f"conv {i}: the ranks' first-step signs or flags differ "
                 f"from one rank's on their rows: "
                 f"{int((sign != ca['sign']).sum())} signs, "
                 f"{int((flags != ca['flags']).sum())} flags")
    return {"convs": len(a), "bitwise_equal": True}


def _rels(a, b) -> list:
    """Step by step, the relative difference of two loss curves."""
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _signs_differing(wa, wb) -> int:
    return sum(int((ca["sign"] != cb["sign"]).sum()) for ca, cb in zip(wa, wb))


def _compare_worlds(torch, one, two, replay, reordered) -> dict:
    """Compare the two-rank results with the one-rank ones.  Fail unless
    the SMD counts and the first executed step's SLU decisions are equal
    (the parameters are equal up to it) and, step by step, the losses
    within ``DIST_LOSS_REL`` (PSG on) or ``DIST_SGDM_REL`` (off) plus the
    one-rank run's own spread: ``DIST_SPREAD_FACTOR`` times the largest
    distance of its curve from its curves on the same batches with the rows
    in another order (``reordered``, :data:`ROW_ORDERS`), the same global
    steps summed in another order, which is all that two ranks change.
    PSG rounds every activation to 8 bits and signSGD moves every weight by
    the learning rate, so a BatchNorm sum rounded otherwise moves codes and
    then signs; ResNet-74's PSG-off losses diverge at lr 0.1.  Every conv's first-step
    signs and flags on the ranks' rows are checked bit for bit in
    ``replay``; the model-level first-step signs that differ from the
    one-rank run's, beside those of the reordered runs, and the later
    steps' SLU decisions are recorded."""
    out = {"first_step_ops_replayed": replay}
    limits = {"full": DIST_LOSS_REL, "off": DIST_SGDM_REL}
    for name, rel in limits.items():
        a, b = one[name], two[name]
        spread = [max(v) for v in zip(*(_rels(n[name]["loss"], a["loss"])
                                        for n in reordered))]
        out[name] = {"loss_rel": _rels(b["loss"], a["loss"]),
                     "spread": spread,
                     "limit": [rel + DIST_SPREAD_FACTOR * x for x in spread],
                     "losses": b["loss"], "one_rank_losses": a["loss"],
                     "slu_decisions_differing_by_step": [
                         sum(x != y for x, y in zip(fa, fb)) for fa, fb in
                         zip(a["slu_executed"], b["slu_executed"])],
                     "ms_per_executed_step": b["ms_per_executed_step"],
                     "one_rank_ms_per_executed_step":
                         a["ms_per_executed_step"],
                     "launches": b["launches"]}
    wa, wb = one["full"]["wgrad"], two["full"]["wgrad"]
    out["model_first_step"] = {
        "convs": len(wb), "one_rank_convs": len(wa),
        "signs": sum(c["sign"].numel() for c in wb),
        "signs_differing": _signs_differing(wa, wb),
        "reordered_signs_differing": [
            _signs_differing(wa, n["full"]["wgrad"]) for n in reordered],
        "flags_differing": sum(int((ca["flags"] != cb["flags"]).sum())
                               for ca, cb in zip(wa, wb))}
    print(json.dumps({"phase": "distributed_world2_comparison", **out}),
          flush=True)
    for name in limits:
        a, b = one[name], two[name]
        for key in ("executed", "dropped"):
            if a[key] != b[key]:
                fail(f"two ranks ({name}): {key} {b[key]} against one "
                     f"rank's {a[key]}")
        if a["slu_executed"][:1] != b["slu_executed"][:1]:
            fail(f"two ranks ({name}): first-step SLU decisions "
                 f"{b['slu_executed'][0]} against {a['slu_executed'][0]}")
        got, lim = out[name]["loss_rel"], out[name]["limit"]
        if not all(g <= x for g, x in zip(got, lim)):
            fail(f"two ranks ({name}): losses {b['loss']} against "
                 f"{a['loss']}: relative {got} above {lim}")
    if len(wa) != len(wb):
        fail(f"two ranks: {len(wb)} convs in the first step, one rank "
             f"{len(wa)}")
    return out


def compare_lm_worlds(torch, one, two, replicated) -> dict:
    """The two-rank LM on sharded parameters against the same steps on
    one rank, and on two ranks with every parameter replicated.  Fail
    unless the ranks' losses are equal, each rank's bytes between steps
    are within the allocator's rounding of the shard reckoning
    (``ALLOC_ROUND`` or ``ALLOC_LARGE`` a state tensor), each rank's
    launches of kernels 5-9 are the one-rank run's (two layers, every
    sub-block forced to run: the same units), the losses within
    ``DIST_LOSS_REL`` of the replicated run's (sharding changes where the
    weights live, not what is computed), and, step by step, within
    ``DIST_LOSS_REL`` plus ``DIST_SPREAD_FACTOR`` times the spread of two
    ranks from one, the replicated run's distance from the one-rank run's,
    as phase 18's ResNet is held.  Two ranks round each rank's share of a
    weight gradient that is not PSG's (the tied head's ``x^T g``, the
    norms') to bf16 before the sum, where one rank rounds the whole sum
    once; under ``psg`` at lr 0.03 a sign flipped by that moves a weight
    by 0.06, and the LM's loss rises."""
    exp = lm_dist_experiment()
    rk = lm_state_reckoning(exp, 2)
    slack = rk["slack"]
    spread = _rels(replicated[0]["loss"], one["loss"])
    out = {"reckoned_bytes": rk, "slack_bytes": slack,
           "one_rank": {k: one[k] for k in (
               "loss", "launches", "between_steps_bytes", "step_peak_bytes",
               "ms_per_executed_step", "seconds")},
           "replicated": {k: replicated[0][k] for k in (
               "loss", "between_steps_bytes", "step_peak_bytes",
               "reduced_fp32_bytes", "ms_per_executed_step", "seconds")},
           "spread": spread,
           "limit": [DIST_LOSS_REL + DIST_SPREAD_FACTOR * x for x in spread],
           "loss_rel": _rels(two[0]["loss"], one["loss"]),
           "loss_rel_replicated": _rels(two[0]["loss"],
                                        replicated[0]["loss"])}
    for r, res in enumerate(two):
        out[f"rank{r}"] = {k: v for k, v in res.items()
                           if k != "slu_executed"}
    for runs, what in ((two, "sharded"), (replicated, "replicated")):
        if runs[0]["loss"] != runs[1]["loss"]:
            fail(f"two-rank LM ({what}): the ranks' losses differ: "
                 f"{runs[0]['loss']} against {runs[1]['loss']}")
    if max(out["loss_rel_replicated"]) > DIST_LOSS_REL:
        fail(f"two-rank LM: sharded losses {two[0]['loss']} against the "
             f"replicated run's {replicated[0]['loss']}")
    for r, res in enumerate(two):
        over = [b - rk["sharded"] for b in res["between_steps_bytes"]]
        if max(over) > slack:
            fail(f"two-rank LM, rank {r}: {res['between_steps_bytes']} "
                 f"bytes between steps against {rk['sharded']} reckoned "
                 f"(slack {slack})")
        if res["launches"] != one["launches"]:
            fail(f"two-rank LM, rank {r}: launches {res['launches']} "
                 f"against one rank's {one['launches']}")
        if not all(res["launches"][k] > 0 for k in LM_KERNELS):
            fail(f"two-rank LM, rank {r}: a kernel of 5-9 was not "
                 f"launched: {res['launches']}")
    if len(two[0]["loss"]) != len(one["loss"]) or not all(
            g <= x for g, x in zip(out["loss_rel"], out["limit"])):
        fail(f"two-rank LM: losses {two[0]['loss']} against one rank's "
             f"{one['loss']}: relative {out['loss_rel']} above "
             f"{out['limit']}")
    return out


def kill_restart_check(torch) -> dict:
    """The launcher on the card: ``--devices 2 --mesh-data 2`` killed at
    ``DIST_KILL_AT`` beside an uninterrupted two-rank run; the killed run's
    checkpoints resumed on one rank (``--mesh-data 1``) to its last step,
    and on two ranks to the uninterrupted run's last checkpoint, bit for
    bit."""
    import shlex
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.ft import faults
    from repro_torch.ft.checkpoint import latest_intact_step

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def launcher(log, *args):
        argv = [sys.executable, "-m", "repro_torch.launch.train",
                "--depth", str(DIST_KILL_DEPTH), "--width", str(WIDTH),
                "--batch", str(BATCH), "--steps", str(DIST_KILL_STEPS),
                "--ckpt-every", "1", *args]
        return subprocess.Popen(
            ["sh", "-c", f'exec "$@" > {shlex.quote(log)} 2>&1', "sh",
             *argv], env=env)

    def reap(procs):
        try:
            for p in procs.values():
                p.wait(timeout=600)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return {n: p.returncode for n, p in procs.items()}

    with tempfile.TemporaryDirectory() as d:
        dirs = {n: os.path.join(d, n) for n in ("killed", "ref", "to1",
                                                 "to2")}
        logs = {n: os.path.join(d, f"{n}.log") for n in
                ("killed", "ref", "to1", "to2")}
        two = ("--devices", "2", "--mesh-data", "2")
        t0 = time.perf_counter()
        codes = reap({
            "killed": launcher(logs["killed"], "--ckpt", dirs["killed"],
                               *two, "--ft-kill-at-step", str(DIST_KILL_AT)),
            "ref": launcher(logs["ref"], "--ckpt", dirs["ref"], *two)})
        first_s = time.perf_counter() - t0
        if codes != {"killed": faults.KILL_EXIT_CODE, "ref": 0}:
            fail(f"kill round exited {codes}: "
                 + Path(logs["killed"]).read_text()[-2000:]
                 + Path(logs["ref"]).read_text()[-2000:])
        survivor = latest_intact_step(dirs["killed"])
        if survivor is None:
            fail("the killed two-rank run left no intact checkpoint")
        for n in ("to1", "to2"):
            shutil.copytree(dirs["killed"], dirs[n])
        t0 = time.perf_counter()
        codes = reap({
            "to1": launcher(logs["to1"], "--ckpt", dirs["to1"],
                            "--mesh-data", "1", "--resume"),
            "to2": launcher(logs["to2"], "--ckpt", dirs["to2"], *two,
                            "--resume")})
        second_s = time.perf_counter() - t0
        if codes != {"to1": 0, "to2": 0}:
            fail(f"resume round exited {codes}: "
                 + Path(logs["to1"]).read_text()[-2000:]
                 + Path(logs["to2"]).read_text()[-2000:])
        last = DIST_KILL_STEPS - 1
        for n, shape in (("to1", "{'data': 1, 'model': 1}"),
                         ("to2", "{'data': 2, 'model': 1}")):
            text = Path(logs[n]).read_text()
            if f"resumed from intact step {survivor}" not in text or \
                    f"on mesh {shape}" not in text:
                fail(f"{n} did not resume from step {survivor} on mesh "
                     f"{shape}: {text[-2000:]}")
            if latest_intact_step(dirs[n]) != last:
                fail(f"{n}'s last intact step is "
                     f"{latest_intact_step(dirs[n])}, not {last}")
        a, b = (dict(np.load(os.path.join(dirs[n], f"step_{last:08d}.npz")))
                for n in ("to2", "ref"))
        bad = [k for k in b if k not in a or not np.array_equal(a[k], b[k])]
        if bad or set(a) != set(b):
            fail(f"the 2 -> 2 resumed run differs from the uninterrupted one "
                 f"in {len(bad)} keys, e.g. {bad[:5]}")
        return {"resumed_from": survivor, "keys": len(b),
                "two_to_two_bitwise_equal": True, "kill_round_s": first_s,
                "resume_round_s": second_s,
                "ref_wall_s": _log_value(logs["ref"], "wall"),
                "to1_wall_s": _log_value(logs["to1"], "wall"),
                "to2_wall_s": _log_value(logs["to2"], "wall")}


def distributed_check(torch, mods) -> dict:
    """Phase 18 (module doc)."""
    import datetime
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.ft.supervisor import free_tcp_port
    from repro_torch.kernels import conv as K
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_lm_trainer, build_trainer
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"reduce_path": reduce_path_check(torch)}
    out["reduce_path"]["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "distributed_reduce_path",
                      **out["reduce_path"]}), flush=True)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_tcp_port()}",
        world_size=1, rank=0, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out["backend"] = dist.get_backend()
        out["resnet74_world1"] = mesh_pair(
            torch, lambda steps, m: build_trainer(
                DEPTH, WIDTH, BATCH, steps, device="cuda",
                chunk_steps=CHUNK_K, mesh=m),
            mods, list(K.LAUNCHES), CHUNK_K + 2, "ResNet-74 world 1", mesh)
        print(json.dumps({"phase": "distributed_resnet74_world1",
                          **out["resnet74_world1"]}), flush=True)
        out["lm_world1"] = mesh_pair(
            torch, lambda steps, m: build_lm_trainer(
                LM_ARCH, num_layers=LM_LAYERS, batch=LM_BATCH, seq=LM_SEQ,
                steps=steps, device="cuda", fused_attention=True,
                chunk_steps=CHUNK_K, mesh=m),
            mods, list(PM.LAUNCHES) + list(FA.LAUNCHES), CHUNK_K + 2,
            "qwen2.5-3b world 1", mesh, profile=False)
        print(json.dumps({"phase": "distributed_lm_world1",
                          **out["lm_world1"]}), flush=True)
    finally:
        dist.destroy_process_group()
    out["world1_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from repro_torch.kernels import ops
    rec = _wgrad_recorder(ops, K)
    one = _resnet_runs(torch, mods, None, rec)
    reordered = [_resnet_runs(torch, mods, None, rec, o) for o in ROW_ORDERS]
    gc.collect()
    torch.cuda.empty_cache()
    t_two = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        two = _two_rank_world(torch, d)
    for name in ("full", "off"):
        if two[0][name]["loss"] != two[1][name]["loss"]:
            fail(f"the two ranks' losses differ ({name})")
    prof = {"backend": two[0]["backend"],
            "profiled_step_rank0": two[0]["profiled"],
            "profiled_step_rank1": two[1]["profiled"],
            "one_rank_runs_s": t_two - t0,
            "two_rank_world_s": time.perf_counter() - t_two}
    print(json.dumps({"phase": "distributed_world2", **prof}), flush=True)
    replay = _replay_ops(torch, [t["full"]["wgrad"] for t in two], rec)
    out["world2"] = {**_compare_worlds(torch, one, two[0], replay,
                                       reordered), **prof}
    t0 = time.perf_counter()
    out["lm_world2"] = compare_lm_worlds(
        torch, lm_dist_run(torch, mods, None), [t["lm"] for t in two],
        [t["lm_replicated"] for t in two])
    out["lm_world2"]["one_rank_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "distributed_lm_world2",
                      **out["lm_world2"]}), flush=True)
    t0 = time.perf_counter()
    out["kill_restart"] = kill_restart_check(torch)
    out["kill_restart"]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase": "distributed_kill_restart",
                      **out["kill_restart"]}), flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    print(json.dumps({"phase": "distributed", "seconds": out["seconds"],
                      "card": out["card"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the static cost audit and the linters
# ---------------------------------------------------------------------------

KERNEL_LINT_TABLE = "kernel_lint_h100.json"     # under chiprun_out/


def audit_check(torch, mods) -> dict:
    """Phase 19a: the four audits of the ``audit`` bench record on the
    card (the lowered program's column for ``EXPORT_WITNESS`` only), each
    passing, each group's MACs equal to the CPU's audit bit for bit, and
    no kernel launched (the predict programs run outside PSG)."""
    from repro_torch.analysis.audit import audit_experiment
    from repro_torch.launch.bench_audit import (AUDIT_BATCH, EXPORT_WITNESS,
                                                _experiments)
    out = {}
    reset_all(mods)
    for exp in _experiments():
        t0 = time.perf_counter()
        card = audit_experiment(exp, batch=AUDIT_BATCH, device="cuda",
                                with_hlo=exp.model.name in EXPORT_WITNESS)
        card_s = time.perf_counter() - t0
        cpu = audit_experiment(exp, batch=AUDIT_BATCH, device="cpu",
                               with_hlo=False)
        if not card.passed:
            fail(f"the cost audit of {exp.model.name} failed on the card:\n"
                 + card.summary())
        groups = {r.group: r.jaxpr_macs for r in card.rows}
        if groups != {r.group: r.jaxpr_macs for r in cpu.rows}:
            fail(f"{exp.model.name}: the card's group MACs differ from the "
                 "CPU's")
        out[exp.model.name] = {
            "passed": card.passed, "groups": len(groups),
            "cost_total_macs": card.cost_total_macs,
            "ops_total_macs": card.jaxpr_total_macs,
            "ops_total_flops": card.jaxpr_total_flops,
            "lowered_total_flops": card.hlo_total_flops,
            "lowered_rel_diff": card.hlo_rel_diff, "card_s": card_s}
    launched = {n: c for mod in mods for n, c in mod.LAUNCHES.items() if c}
    if launched:
        fail(f"the audited predict programs launched kernels {launched}")
    return out


def kernel_lint_check(torch, card: str) -> dict:
    """Phase 19c: every shipped kernel at its lint geometries, no finding;
    one line a kernel with its resource figures; the launch table (the
    CPU tests' fixture) into chiprun_out/."""
    from repro_torch.analysis.kernel_lint import lint_shipped, resources
    findings, table = lint_shipped("cuda")
    res = resources(table["rows"])
    for name, r in res.items():
        print(json.dumps({"phase": "kernel_lint", "kernel": name, **r}),
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / KERNEL_LINT_TABLE).write_text(json.dumps(
        {"card": card, "rows": table["rows"],
         "coverage": table["coverage"]}, indent=1))
    if findings:
        fail("kernel lint findings:\n" + "\n".join(str(f) for f in findings))
    missing = [n for n in list(REPLACES) + ["slu_decide"] if n not in res]
    if missing:
        fail(f"the kernel lint did not launch {missing}")
    return {"launches": len(table["rows"]),
            "globals": sorted({r["global"] for r in table["rows"]}),
            "resources": res, "coverage": table["coverage"]}


def analysis_check(torch, mods, main_ledger, main_steps: int) -> dict:
    """Phase 19 (module doc)."""
    from repro_torch.analysis.hotloop_lint import default_experiments, \
        lint_chunk
    from repro_torch.analysis.repo_lint import lint_repo
    t_phase = time.perf_counter()
    card = card_line()
    out = {"audits": audit_check(torch, mods)}
    print(json.dumps({"phase": "analysis_audits", **out["audits"]}),
          flush=True)
    t0 = time.perf_counter()
    rep = main_ledger.report(steps=main_steps, validate_against_hlo=True,
                             device="cuda")
    if rep.validated_against_hlo is not True:
        fail("the ResNet-74 main path's energy report is not validated: "
             f"{rep.validated_against_hlo}")
    out["energy_report"] = {"validated_against_hlo": True,
                            "seconds": time.perf_counter() - t0}
    print(rep.summary(), flush=True)
    t0 = time.perf_counter()
    out["kernel_lint"] = kernel_lint_check(torch, card)
    out["kernel_lint"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["hotloop"] = {}
    for exp in default_experiments():
        findings, rules = lint_chunk(exp, device="cuda")
        if findings or not all(v is True for v in rules.values()):
            fail(f"hot-loop lint of {exp.model.name}: {rules}\n"
                 + "\n".join(str(f) for f in findings))
        out["hotloop"][exp.model.name] = rules
    out["hotloop_s"] = time.perf_counter() - t0
    findings = lint_repo()
    if findings:
        fail("repo lint findings:\n" + "\n".join(str(f) for f in findings))
    out["repo_lint"] = {"findings": 0}
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card
    print(json.dumps({"phase": "analysis", "seconds": out["seconds"],
                      "energy_report_s": out["energy_report"]["seconds"],
                      "kernel_lint_s": out["kernel_lint"]["seconds"],
                      "hotloop_s": out["hotloop_s"], "card": card}),
          flush=True)
    return out


def measure_cells_main(argv) -> None:
    """Phase 20b's child (``MEASURE_FLAG OUT``): each of ``DRYRUN_SHAPES``
    of ``DRYRUN_ARCH`` run for real on the card, the results to ``OUT``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import dryrun
    out = {}
    for shape in DRYRUN_SHAPES:
        with dryrun.card_program(DRYRUN_ARCH, shape) as fn:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = profile_fn(torch, fn, cpu_ops=False)
        out[shape] = {"arch": DRYRUN_ARCH, "shape": shape,
                      "peak_bytes": peak,
                      "span_s": start.elapsed_time(end) / 1e3,
                      "busy_s": prof["device_busy_ms"] / 1e3,
                      "device_events": prof["device_events"],
                      "top": prof["top"][:5], "wall_s": wall_s,
                      "warmup_s": warm_s}
        Path(argv[0]).write_text(json.dumps(out))
        print(json.dumps({"phase": "dryrun_measured", **out[shape]}),
              flush=True)


def dryrun_start() -> tuple:
    """Phase 20a's dry-run CLI, one subprocess a cell, on the host:
    ``(procs, logs, started)``, waited for by :func:`dryrun_check`."""
    import atexit
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs, procs = {}, {}
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    for shape in DRYRUN_SHAPES:
        logs[shape] = out_dir / f"dryrun_{shape}.log"
        procs[shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", shape, "--out",
             str(out_dir / f"dryrun_{shape}.json")], env=env,
            stdout=open(logs[shape], "w"), stderr=subprocess.STDOUT)
    return procs, logs, time.perf_counter()


def dryrun_check(torch, chunked, started) -> dict:
    """Phase 20 (module doc): rank 0's local program of each dry-run cell
    on the card, the dry runs :func:`dryrun_start` started, then the
    checks."""
    import gc
    from repro_torch.launch import bench_roofline

    procs, logs, t_dry = started
    gc.collect()
    torch.cuda.empty_cache()        # the child's program needs the card
    held = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    print(json.dumps({"phase": "dryrun_parent_held", **held}), flush=True)
    t_start = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    # the measured program's peak can come within a few GiB of the card's
    # memory: its free memory must not sit split across cached segments
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    measured = out_dir / "dryrun_measured.json"
    logs["measured"] = out_dir / "dryrun_measured.log"
    procs["measured"] = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), MEASURE_FLAG,
         str(measured)], env=env, stdout=open(logs["measured"], "w"),
        stderr=subprocess.STDOUT)
    try:
        codes = {n: p.wait(timeout=600) for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t_start
    dry_s = time.perf_counter() - t_dry
    for n, code in codes.items():
        if code != 0:
            fail(f"phase 20 {n} exited {code}: "
                 + logs[n].read_text()[-3000:])
    got = json.loads(measured.read_text())
    card = card_line()
    cells = {}
    for shape in DRYRUN_SHAPES:
        lines = logs[shape].read_text().splitlines()
        rec = json.loads((out_dir / f"dryrun_{shape}.json").read_text())[0]
        if rec["status"] != "ok" or not lines[-1].startswith("done: 1 "
                                                             "cells, 0 "):
            fail(f"dry run {DRYRUN_ARCH} {shape}: {lines[-3:]}")
        m, r = got[shape], rec["roofline"]
        peak = rec["bytes_per_device"]["peak"]
        bound_s = max(r["compute_s"], r["memory_s"])
        cell = {"status": rec["status"], "dryrun_s": rec["compile_s"],
                "peak_gib": peak / 2**30, "bottleneck": r["bottleneck"],
                "measured_peak_gib": m["peak_bytes"] / 2**30,
                "peak_ratio": m["peak_bytes"] / peak,
                "busy_s": m["busy_s"], "span_s": m["span_s"],
                "bound_s": bound_s, "time_ratio": m["busy_s"] / bound_s,
                "span_ratio": m["span_s"] / bound_s,
                "device_events": m["device_events"], "top": m["top"],
                "measured_wall_s": m["wall_s"], "warmup_s": m["warmup_s"],
                "roofline": r, "card": card}
        print(json.dumps({"phase": f"dryrun_{shape}", **cell}), flush=True)
        if abs(cell["peak_ratio"] - 1) > DRYRUN_PEAK_REL:
            fail(f"{shape}: {m['peak_bytes']} bytes at peak on the card, "
                 f"the dry run reckoned {peak}")
        # the device's busy time (its kernels, from the profile), not the
        # span between two events, which holds the host's gaps too
        if m["busy_s"] < bound_s:
            fail(f"{shape}: the card busy {m['busy_s']} s, under the "
                 f"roofline's {bound_s} s: a count is too large")
        cells[shape] = cell
    row = bench_roofline.render_cnn_analytic()[0]
    if not row.startswith("roofline/resnet74/"):
        fail(f"the roofline bench's first CNN row is {row}")
    row_s = float(row.split(",")[1]) / 1e6
    replay_s = chunked["fused"]["chunked_device_ms_per_replayed_step"] / 1e3
    resnet = {"row": row, "row_s": row_s, "replay_s": replay_s,
              "ratio": row_s / replay_s}
    print(json.dumps({"phase": "dryrun_resnet74_roofline", **resnet}),
          flush=True)
    if row_s >= replay_s:
        fail(f"the ResNet-74 roofline row's {row_s} s is not under the "
             f"measured replay's {replay_s} s")
    return {"cells": cells, "resnet74": resnet, "card": card,
            "seconds": time.perf_counter() - t_start,
            "subprocess_s": seconds, "dry_runs_since_start_s": dry_s,
            "parent_held": held}


# phase 21: the conv and attention benches, and the examples
EXAMPLE_STEPS = 8    # finetune_split's first pre-training steps, card and CPU
EXAMPLE_REL = 1e-4
BENCH_TIMEOUT_S = 300   # bench_run --json-conv --json-attn, in its process
HELD_CONV = ("conv_fwd_mma_kernel", "conv_dx_mma_kernel",
             "conv_pred_mma_kernel", "conv_sign_mma_kernel",
             "pred_mma_kernel", "sign_mma_kernel")
HELD_FLASH = ("flash_bwd_dkv_mma_kernel", "flash_bwd_dq_mma_kernel",
              "flash_fwd_mma_kernel")
BENCH_ROWS = ["conv/paper_resnet74_batch128", "conv/body/2x32x3-16k3s1",
              "conv/strided/2x32x16-32k3s2", "conv/down/2x32x16-32k1s2",
              "attn/paper_lm_s4096", "attn/gqa_small/1x128x4-2h32"]


def bench_conv_attn_examples_check(torch, mods):
    """Phase 21: ``bench_conv`` and ``bench_attn`` through ``bench_run``, then
    ``finetune_split`` and ``quickstart`` on the card."""
    import contextlib
    import io
    import tempfile

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import psg_matmul as PM
    from repro_torch.launch import (bench_attn, bench_conv, finetune_split,
                                    quickstart)
    from repro_torch.tasks import get_task

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    # the records by the CLI in a process of their own: this one's long
    # profiles would cost its later profiles device records
    # (bench_common.device_profile), which the records' busy times need;
    # a process whose profiler lost records in every session it took is
    # run once more
    with tempfile.TemporaryDirectory() as d:
        paths = (os.path.join(d, "conv.json"), os.path.join(d, "attn.json"))
        t0 = time.perf_counter()
        for attempt in range(2):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.bench_run",
                 "--json-conv", paths[0], "--json-attn", paths[1]],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
            if "no whole profile" not in proc.stderr:
                break
            print(f"bench_run --json-conv --json-attn: attempt {attempt} "
                  f"found no whole profile", flush=True)
        records_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"bench_run --json-conv --json-attn exited "
                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        conv, attn = (json.loads(Path(p).read_text()) for p in paths)
    totals = conv["paper_resnet74_batch128"]
    for path in ("im2col", "fused"):
        bench_conv.assert_complete(totals[f"{path}_bytes_per_step"], path)
        for row in conv["shapes"]:
            bench_conv.assert_complete(row[f"{path}_bytes"], row["kind"])
    lm = attn["paper_lm_s4096"]
    for path in ("materialized", "flash"):
        bench_attn.assert_complete(lm[f"{path}_bytes_per_step"], path)
        for row in attn["shapes"]:
            bench_attn.assert_complete(row[f"{path}_bytes"], row["kind"])
    for what, ms in (("conv", totals["device_ms_per_step"]),
                     ("attn", lm["device_ms"])):
        if not all(v is not None and v > 0 for v in ms.values()):
            fail(f"{what} paper totals device ms {ms}")
    # the profiler's busy time, from profiles that lost no launch
    for what, ms in (("conv", totals["device_busy_ms_per_step"]),
                     ("attn", lm["device_busy_ms"])):
        if not all(v is not None and v > 0 for v in ms.values()):
            fail(f"{what} paper totals device-busy ms {ms}")
    # the byte models' launches held against the card's at every geometry
    geometries = totals["unique_geometries"]
    for what, held, want in (
            ("conv", totals["launches_held"],
             {n: geometries for n in HELD_CONV}),
            ("attn", lm["launches_held"], {n: 1 for n in HELD_FLASH})):
        if held != want:
            fail(f"{what} launches held against the card's {held}, "
                 f"expected {want}")
    if lm["bytes_ratio"] < 3:
        fail(f"paper_lm_s4096 bytes_ratio {lm['bytes_ratio']} < 3")
    papers = {
        "conv": {k: totals[k] for k in (
            "bytes_ratio", "backward_bytes_ratio", "dx_bytes_ratio",
            "device_ms_per_step", "time_ratio", "device_busy_ms_per_step",
            "busy_ratio", "implied_tb_s", "implied_tb_s_busy",
            "launches_held", "profiles_discarded")},
        "attn": {k: lm[k] for k in (
            "bytes_ratio", "fwd_bytes_ratio", "bwd_bytes_ratio",
            "device_ms_batch", "device_ms", "time_ratio", "device_busy_ms",
            "busy_ratio", "implied_tb_s", "implied_tb_s_busy",
            "launches_held", "profiles_discarded")},
        "device": conv["device"], "records_s": records_s}
    print(json.dumps({"phase": "bench_conv_attn_records", **papers}),
          flush=True)

    # bench_run --only conv,attn's rows, from the records just made
    rows = [*bench_conv.rows(totals, conv["shapes"]),
            *bench_attn.rows(lm, attn["shapes"])]
    for row in rows:
        print(row, flush=True)
    if [r.split(",", 1)[0] for r in rows] != BENCH_ROWS:
        fail(f"the records' rows {rows}")

    examples = {}
    for name, mod in (("finetune_split", finetune_split),
                      ("quickstart", quickstart)):
        reset_all(mods)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf := io.StringIO()):
            rec = mod.run("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            print(line, flush=True)
        used = {n: c for m in mods for n, c in m.LAUNCHES.items() if c}
        for kernel in list(PM.LAUNCHES) + list(FA.LAUNCHES):
            if used.get(kernel, 0) <= 0:
                fail(f"{name}'s PSG run launched no {kernel}")
        examples[name] = {**rec, "wall_s": wall, "launches": used}
    if not lines[-1].startswith("  SLU skip 60%: computational savings"):
        fail(f"quickstart's last line {lines[-1]!r}")
    ft = examples["finetune_split"]
    exp = finetune_split.pretrain_experiment()
    cpu_init = get_task("lm").init(exp, 0, "cuda").cpu()
    _, cpu_hist = finetune_split.pretrain(EXAMPLE_STEPS, "cpu", cpu_init)
    card = ft["pretrain_losses"][:EXAMPLE_STEPS]
    cpu = [h["loss"] for h in cpu_hist]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if len(card) != EXAMPLE_STEPS or rel > EXAMPLE_REL:
        fail(f"finetune_split pre-training losses {card} on the card "
             f"against the CPU's {cpu}: {rel} relative > {EXAMPLE_REL}")
    out = {"records": papers, "rows": rows,
           "examples": examples,
           "pretrain_card_vs_cpu": {"card": card, "cpu": cpu,
                                    "max_rel": rel, "limit": EXAMPLE_REL},
           "seconds": time.perf_counter() - t_start}
    print(json.dumps({"phase": "bench_conv_attn_examples",
                      "verdict": {k: ft[k] for k in (
                          "option1_loss", "option2_loss",
                          "option1_energy_units", "option2_energy_units",
                          "reproduced")},
                      "pretrain_max_rel": rel,
                      "wall_s": {"records": records_s,
                                 **{n: e["wall_s"]
                                    for n, e in examples.items()}},
                      "seconds": out["seconds"]}), flush=True)
    return out


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
    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:    # the script's seconds by phase group
        marks.append((name, time.perf_counter()))
    from repro_torch.configs import get_experiment
    from repro_torch.configs.paper_cnns import resnet_conv_shapes
    from repro_torch.core.ledger import EnergyLedger
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
    mark("kernels")
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

    mark("dispatch_cli_references")
    trainer, main, prof = run_path(
        torch, "main_path",
        lambda steps: build_trainer(DEPTH, WIDTH, BATCH, steps, device="cuda"),
        mods, list(K.LAUNCHES))
    main_ledger = EnergyLedger.from_trainer(trainer)    # phase 19's report
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
    mark("main_paths")
    resume = resume_check(torch)
    print(json.dumps({"phase": "resume", **resume}), flush=True)
    mark("resume")
    chunked = chunked_check(torch, mods + (GC,), GC)
    print(json.dumps({"phase": "chunked", **{k: v for k, v in chunked.items()
                                             if k != "slu_decide"}}),
          flush=True)
    mark("chunked")
    mbv2_geometries, mbv2 = mobilenet_check(torch, mods + (GC,))
    mark("mobilenetv2")
    paper = paper_benches_check(torch, mods + (GC,), steps=PAPER_STEPS)
    mark("paper_benches")
    dense = dense_archs_check(torch, mods + (GC,))
    mark("dense_archs")
    encdec = encdec_vlm_moe_check(torch, mods + (GC,))
    mark("encdec_vlm_moe")
    ssm = ssm_check(torch, mods + (GC,))
    mark("ssm")
    serving = serving_check(torch, mods + (GC,))
    mark("serving")
    distributed = distributed_check(torch, mods)
    mark("distributed")
    started = dryrun_start()        # phase 20a, on the host, beside 19
    analysis = analysis_check(torch, mods + (GC,), main_ledger,
                              main["nominal_steps"])
    mark("analysis")
    dry = dryrun_check(torch, chunked, started)
    mark("dryrun")
    benches = bench_conv_attn_examples_check(torch, mods + (GC,))
    mark("bench_conv_attn_examples")
    phase_s = {n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])}
    print(json.dumps({"phase": "timing", "seconds": phase_s}), flush=True)

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
         "mobilenetv2": mbv2, "paper_benches": paper,
         "dense_archs": dense, "encdec_vlm_moe": encdec, "ssm": ssm,
         "serving": serving, "distributed": distributed,
         "analysis": analysis, "dryrun": dry,
         "bench_conv_attn_examples": benches,
         "phase_seconds": phase_s,
         "kernels": kernels,
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
    if sys.argv[1:2] == [DIST_RANK_FLAG]:
        dist_rank_main(sys.argv[2:])
    elif sys.argv[1:2] == [MEASURE_FLAG]:
        measure_cells_main(sys.argv[2:])
    else:
        main()
