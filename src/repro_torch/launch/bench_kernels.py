"""Kernel microbenchmark: the dispatched PSG, quantize and flash-attention
ops against their element-level oracles.

    python -m repro_torch.launch.bench_kernels [--fast] [--device cpu]

The counterpart of the JAX package's ``benchmarks/bench_kernels.py``
(``run(fast)``), with its row names, sizes and derived fields.  Each row is
``name,us_per_call,derived`` CSV:

* ``kernel/psg_pallas``: ``dispatch.psg_grad_w`` (kernels 5-6) against
  ``ref.psg_grad_w_ref``, and the predictor's MAC energy against fp32;
* ``kernel/quantize``: ``dispatch.quantize`` at 8 bits (kernel 10);
* ``kernel/psg_resnet74_im2col/<kind>/<N>x<din>x<dout>``: the PSG weight
  gradient at the im2col matmul of each ResNet-74 conv (one per kind with
  ``--fast``), with its fallback-tile ratio;
* ``kernel/flash_attn``: the flash forward (kernel 7) against the
  materialized oracle, the PSG flash backward (kernels 8-9), and the
  two-direction HBM byte model of both paths.  The byte model is the JAX
  package's, of its TPU kernels (128 x 128 tiles, four per-query-head fp32
  products in the dk/dv pass), and the row says so (``byte_model=``): the
  port's kernels tile by 64 and emit group-summed integer products.

Ops run through ``kernels/dispatch.py``, so the backend is the tensors'
device unless ``REPRO_TORCH_KERNEL_BACKEND`` pins another.  On the card a
time is the mean of three calls after a warm-up, by CUDA events; on the CPU
by the host clock, and then it is a time of the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.paper_cnns import resnet_conv_shapes
from repro_torch.core.config import PSGConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.energy import FP32_MAC_PJ, mac_energy_pj
from repro_torch.kernels import dispatch, ref
from repro_torch.launch.bench_common import csv_row, one_per_kind, time_us

FP32, BF16 = 4, 2
BQ = BK = 128          # the TPU flash kernels' tiles (the JAX package's model)


# ---------------------------------------------------------------------------
# the attention byte model (a copy of benchmarks/bench_attn.py's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnShape:
    """One self-attention site: GQA geometry and operand width."""
    batch: int
    seq: int
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    op_bytes: int = BF16
    kind: str = "lm"

    @property
    def q_elems(self) -> int:
        return self.batch * self.seq * self.heads * self.head_dim

    @property
    def kv_elems(self) -> int:
        return self.batch * self.seq * self.kv_heads * self.head_dim

    @property
    def st_elems(self) -> int:
        """``(B, nh, S, T)`` score-tensor elements (T = S)."""
        return self.batch * self.heads * self.seq * self.seq

    @property
    def rows_elems(self) -> int:
        """One ``(B, nh, S)`` fp32 row statistic (lse or delta)."""
        return self.batch * self.heads * self.seq


def _run_tiles(s: AttnShape, bq: int = BQ, bk: int = BK) -> int:
    """(query tile, kv tile) pairs the causal block skip runs, times B*nh."""
    n_q, n_kv = -(-s.seq // bq), -(-s.seq // bk)
    if s.causal:
        pairs = sum(1 for iq in range(n_q) for ik in range(n_kv)
                    if ik * bk <= iq * bq + bq - 1)
    else:
        pairs = n_q * n_kv
    return s.batch * s.heads * pairs


def materialized_bytes(s: AttnShape) -> Dict[str, int]:
    """Whole-step HBM bytes of the materialized ``(S, T)`` path: fp32
    scores, dP and dS, bf16 probabilities saved for the backward."""
    op = s.op_bytes
    fwd = ((s.q_elems + 2 * s.kv_elems) * op
           + 2 * s.st_elems * FP32
           + 2 * s.st_elems * BF16
           + s.q_elems * op)
    bwd = (s.st_elems * BF16
           + 2 * s.st_elems * FP32
           + 2 * s.st_elems * FP32
           + (2 * s.q_elems + 2 * s.kv_elems) * op
           + (s.q_elems + 2 * s.kv_elems) * FP32)
    return {"fwd": fwd, "bwd": bwd, "total": fwd + bwd}


def flash_bytes(s: AttnShape, bq: int = BQ, bk: int = BK) -> Dict[str, int]:
    """Whole-step HBM bytes of the flash path with the PSG backward: no
    ``(S, T)`` tensor; operand tiles re-read per causal tile pair, and the
    four per-query-head fp32 code products of the dk/dv pass."""
    op = s.op_bytes
    tiles = _run_tiles(s, bq, bk)
    tile_kv = tiles * bk * s.head_dim
    tile_q = tiles * bq * s.head_dim
    prods = s.batch * s.seq * s.heads * s.head_dim
    group = s.batch * s.seq * s.kv_heads * s.head_dim
    fwd = (s.q_elems * op + 2 * tile_kv * op + s.q_elems * op
           + s.rows_elems * FP32)
    bwd = (2 * s.q_elems * op + s.rows_elems * FP32
           + 2 * s.q_elems * op + 2 * tile_kv * op
           + 2 * s.rows_elems * FP32 + s.q_elems * FP32
           + (s.q_elems * 2 + s.kv_elems) * op
           + 2 * s.kv_elems * op + 2 * tile_q * op + 2 * s.rows_elems * FP32
           + 4 * prods * FP32 + 4 * prods * FP32
           + 4 * group * FP32 + 4 * group * FP32 + 2 * s.kv_elems * FP32)
    return {"fwd": fwd, "bwd": bwd, "total": fwd + bwd}


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------


def psg_operands(fast: bool, device, seed: int = 0):
    """The ``(x (N, din), gy (N, dout))`` of the ``kernel/psg_pallas`` and
    ``kernel/quantize`` rows (``x`` is what kernel 10 quantizes)."""
    N, din, dout = (512, 256, 256) if fast else (2048, 1024, 1024)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(N, din, device=device, generator=gen)
    return x, torch.randn(N, dout, device=device, generator=gen) * 0.01


def run(fast: bool = True, device=None, seed: int = 0) -> List[str]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    cfg = PSGConfig(enabled=True)
    x, gy = psg_operands(fast, dev, seed)
    rows = []
    us_k, _ = time_us(lambda a, b: dispatch.psg_grad_w(a, b, cfg), x, gy)
    us_r, _ = time_us(lambda a, b: ref.psg_grad_w_ref(a, b, cfg), x, gy)
    pred_mac = mac_energy_pj(cfg.bits_x_msb, cfg.bits_g_msb) / FP32_MAC_PJ
    rows.append(csv_row("kernel/psg_pallas", us_k,
                        f"ref_us={us_r:.1f};pred_mac_vs_fp32={pred_mac:.4f}"))
    us_q, _ = time_us(lambda a: dispatch.quantize(a, 8), x)
    rows.append(csv_row("kernel/quantize", us_q, "bits=8"))

    # the PSG weight gradient at ResNet-74's im2col geometries (batch cut
    # to 2 or 16; din, dout, k and stride are the paper's)
    convs = resnet_conv_shapes(depth=74, width=16, batch=2 if fast else 16)
    if fast:
        convs = one_per_kind(convs)
    seen = set()
    for c in convs:
        Ns, dins, douts = c.im2col
        if c.im2col in seen:
            continue
        seen.add(c.im2col)
        xs, gs = normal(Ns, dins), normal(Ns, douts, scale=0.01)
        us_tile, (_, fb) = time_us(
            lambda a, b: dispatch.psg_grad_w(a, b, cfg), xs, gs)
        us_ref, _ = time_us(lambda a, b: ref.psg_grad_w_ref(a, b, cfg),
                            xs, gs)
        rows.append(csv_row(
            f"kernel/psg_resnet74_im2col/{c.kind}/{Ns}x{dins}x{douts}",
            us_tile, f"ref_us={us_ref:.1f};k={c.k};stride={c.stride};"
            f"fallback_tile_ratio={float(fb):.3f}"))

    # flash attention against the materialized oracle, both directions
    B, S, nh, hd = (1, 256, 4, 64) if fast else (2, 1024, 8, 128)
    q, k, v = (normal(B, S, nh, hd) for _ in range(3))
    do = normal(B, S, nh, hd, scale=0.01)
    us_f, (o, lse) = time_us(
        lambda a, b, c: dispatch.attention_fwd(a, b, c, cfg), q, k, v)
    us_o, _ = time_us(ref.flash_attention_oracle, q, k, v)
    us_b, _ = time_us(
        lambda a, b, c, d: dispatch.attention_bwd(a, b, c, o, lse, d, cfg),
        q, k, v, do)
    shape = AttnShape(B, S, nh, nh, hd, op_bytes=FP32, kind="bench")
    b_mat, b_flash = materialized_bytes(shape), flash_bytes(shape)
    rows.append(csv_row(
        "kernel/flash_attn", us_f,
        f"oracle_us={us_o:.1f};bwd_us={us_b:.1f};"
        f"flash_MB_fwd_bwd={b_flash['total'] / 1e6:.1f};"
        f"hbm_bytes_ratio={b_mat['total'] / b_flash['total']:.2f};"
        f"byte_model=tpu_kernels_{BQ}x{BK}"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="the small sizes (one ResNet conv per kind)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# kernel microbenchmark on {where}, backend "
          f"{dispatch.resolve_backend()}; name,us_per_call,derived",
          flush=True)
    rows = run(fast=args.fast, device=dev)
    for row in rows:
        print(row, flush=True)
    return rows


if __name__ == "__main__":
    main()
