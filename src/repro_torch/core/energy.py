"""Energy primitives of the paper's accounting: per-op energies of a 45nm
process (Horowitz, ISSCC'14, the paper's ref [59]), the composition law of
Tables 3/4, and the analytic forward FLOPs of a transformer block.  A copy
of the parts of the JAX package's ``core/energy.py`` that the ledger and
the LM cost table use; the numbers are the paper's model, not measurements
of any device.
"""
from __future__ import annotations

from typing import Mapping, Tuple

from repro_torch.core.config import BLOCK_ATTN, E2TrainConfig, ModelConfig

# Horowitz ISSCC'14 45nm, picojoules.
ENERGY_45NM: Mapping[str, float] = {
    # multiplies
    "mul_fp32": 3.7, "mul_fp16": 1.1, "mul_int32": 3.1, "mul_int8": 0.2,
    # adds
    "add_fp32": 0.9, "add_fp16": 0.4, "add_int32": 0.1, "add_int8": 0.03,
    # memory access per 32-bit word
    "sram_8kb": 10.0, "sram_32kb": 20.0, "sram_1mb": 100.0, "dram": 1300.0,
}


def mult_energy_pj(bits_a: int, bits_b: int) -> float:
    """Fixed-point multiplier energy ~ bits_a * bits_b (array multiplier),
    anchored at int8 (0.2 pJ for 8x8)."""
    return ENERGY_45NM["mul_int8"] * (bits_a * bits_b) / 64.0


def add_energy_pj(bits: int) -> float:
    return ENERGY_45NM["add_int8"] * bits / 8.0


def move_energy_pj(bits: int, level: str = "sram_32kb") -> float:
    return ENERGY_45NM[level] * bits / 32.0


def mac_energy_pj(bits_a: int, bits_b: int, acc_bits: int = 32) -> float:
    return mult_energy_pj(bits_a, bits_b) + add_energy_pj(acc_bits)


FP32_MAC_PJ = ENERGY_45NM["mul_fp32"] + ENERGY_45NM["add_fp32"]

# PSG mixed-precision compute factor implied by the paper's own table rows
# (1 - 0.67*(1-s)*r matches 80.27/85.20/90.13% at s=0.2/0.4/0.6 for r=0.368).
PSG_FACTOR_PAPER = 0.368

# Design-point fallback rate assumed when no measurement is available; the
# training path measures the real rate per step (``psg_fallback_ratio``).
PSG_FALLBACK_ASSUMED = 0.4


def psg_factor_from_energy_model(cfg_bits=(8, 16, 4, 10),
                                 fallback_rate=0.4) -> float:
    """First-principles PSG compute-energy factor vs fp32 training.

    Training = fwd (x*w) + bwd-x (g*w) + bwd-w (x*g), each ~1/3 of MACs.
    """
    bx, bg, bxm, bgm = cfg_bits
    fwd = mac_energy_pj(bx, bx) / FP32_MAC_PJ
    bwd_x = mac_energy_pj(bg, bx) / FP32_MAC_PJ
    pred = mac_energy_pj(bxm, bgm) / FP32_MAC_PJ
    full = mac_energy_pj(bx, bg) / FP32_MAC_PJ
    bwd_w = pred + fallback_rate * full   # predictor always; fallback on a share
    return (fwd + bwd_x + bwd_w) / 3.0


def computational_savings(smd_ratio: float, slu_skip: float,
                          psg_factor: float = PSG_FACTOR_PAPER) -> float:
    """Paper's composition law: fraction of baseline compute *saved*."""
    return 1.0 - smd_ratio * (1.0 - slu_skip) * psg_factor


def measured_psg_factor(e2: E2TrainConfig, fallback_ratio: float) -> float:
    """PSG compute-energy factor from a *measured* fallback-tile ratio."""
    p = e2.psg
    return psg_factor_from_energy_model(
        (p.bits_x, p.bits_g, p.bits_x_msb, p.bits_g_msb), fallback_ratio)


def psg_mac_pj(psg, fallback_rate: float) -> float:
    """Per-MAC energy (pJ) of PSG training averaged over the three passes."""
    fwd = mac_energy_pj(psg.bits_x, psg.bits_x)
    bwd_x = mac_energy_pj(psg.bits_g, psg.bits_x)
    bwd_w = mac_energy_pj(psg.bits_x_msb, psg.bits_g_msb) \
        + fallback_rate * mac_energy_pj(psg.bits_x, psg.bits_g)
    return (fwd + bwd_x + bwd_w) / 3.0


# ---------------------------------------------------------------------------
# analytic FLOPs of a transformer block
# ---------------------------------------------------------------------------


def _attn_flops(cfg: ModelConfig, S: int, kv_len: int) -> Tuple[float, float]:
    """(projection flops, score/value flops) for S queries."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * S * d * (nh * hd + 2 * nkv * hd) + 2 * S * nh * hd * d
    eff_kv = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    qk = 2 * S * eff_kv * nh * hd * 2            # scores + weighted values
    return float(proj), float(qk)


def _mlp_flops(cfg: ModelConfig, S: int, d_ff: int) -> float:
    return float(2 * S * cfg.d_model * d_ff * (3 if cfg.glu else 2))


def block_fwd_flops(cfg: ModelConfig, kind: str, S: int,
                    kv_len: int = 0) -> float:
    """Forward FLOPs of one block for S tokens (per batch element)."""
    if cfg.family == "cnn":
        raise ValueError(f"{cfg.name!r} is a CNN config: it has no "
                         "transformer blocks (use core/cost.cnn_cost)")
    if kind != BLOCK_ATTN:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    p, a = _attn_flops(cfg, S, kv_len or S)
    return p + a + _mlp_flops(cfg, S, cfg.d_ff)
