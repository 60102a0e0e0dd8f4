"""Energy primitives of the paper's accounting: per-op energies of a 45nm
process (Horowitz, ISSCC'14, the paper's ref [59]), the composition law of
Tables 3/4, the analytic FLOPs of the models (a transformer's blocks, the
CNNs' per-layer tables), the 45nm training-energy primitive, and the
roofline terms of a step priced for a device.  A copy of the JAX package's
``core/energy.py``; the per-op energies are the paper's model, not
measurements of any device.

:class:`HW` holds a device's peak rates; :data:`H100_SXM` is the card the
port runs on (dense bf16 tensor-core FLOP/s, HBM3 bytes/s, one direction
of NVLink 4), the default of :func:`roofline_terms`.  The port carries no
TPU constant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

from repro_torch.core.config import (BLOCK_ATTN, BLOCK_MAMBA, BLOCK_MLSTM,
                                     BLOCK_MOE, BLOCK_SHARED_ATTN,
                                     BLOCK_SLSTM, E2TrainConfig, ModelConfig)

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

@dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per chip, /s
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s/link
    int8_speedup: float = 2.0  # int8 vs bf16 tensor-core throughput ratio


# the H100 SXM's datasheet rates: 989 TFLOP/s dense bf16 (1,979 TOP/s int8),
# 3.35 TB/s of HBM3, 450 GB/s one direction of NVLink 4
H100_SXM = HW(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
              ici_bw=450e9, int8_speedup=2.0)


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
    """Forward FLOPs of one block for S tokens (per batch element).  The
    JAX package's count, kept as it is because SLU's cost term reads it:
    ``shared_attn`` is priced as an ``attn`` block, MLP included, although
    that block has no MLP."""
    if cfg.family == "cnn":
        raise ValueError(f"{cfg.name!r} is a CNN config: it has no "
                         "transformer blocks (use core/cost.cnn_cost)")
    d = cfg.d_model
    if kind in (BLOCK_ATTN, BLOCK_MOE, BLOCK_SHARED_ATTN):
        p, a = _attn_flops(cfg, S, kv_len or S)
        if kind != BLOCK_MOE:
            return p + a + _mlp_flops(cfg, S, cfg.d_ff)
        dff = cfg.moe_d_ff or cfg.d_ff    # top_k routed and every shared
        experts = (cfg.top_k + cfg.num_shared_experts) * \
            _mlp_flops(cfg, S, dff)
        return p + a + experts + 2 * S * d * cfg.num_experts
    if kind == BLOCK_MAMBA:
        di, st = cfg.ssm_expand * d, cfg.ssm_state
        proj = 2 * S * d * (2 * di + 2 * st) + 2 * S * di * d
        scan = 2 * S * di * st * 2               # state update + readout
        return float(proj + scan + S * di * cfg.ssm_conv_width * 2)
    if kind == BLOCK_MLSTM:
        di = cfg.ssm_expand * d
        hd = di // cfg.num_heads
        proj = 2 * S * d * 2 * di + 2 * S * di * 3 * di + 2 * S * di * d
        return float(proj + 2 * S * cfg.num_heads * hd * hd * 2)
    if kind == BLOCK_SLSTM:
        proj = 2 * S * d * 4 * d + 2 * S * d * d
        rec = 2 * S * cfg.num_heads * (d // cfg.num_heads) ** 2 * 4
        return float(proj + rec)
    raise ValueError(f"unknown block kind {kind!r}")


def model_fwd_flops(cfg: ModelConfig, batch: int, S: int,
                    kv_len: int = 0) -> float:
    """Forward FLOPs of the whole LM for ``batch`` sequences of ``S``
    tokens: the blocks, ``shared_attn_every``'s attention calls, the
    encoder over ``frontend_tokens`` frames and every decoder layer's
    cross-attention (enc-dec), and the head.  A CNN config asks its
    per-layer table (``core/cost.cnn_cost``; ``S`` has no CNN meaning, the
    images are CIFAR's 32 x 32)."""
    if cfg.family == "cnn":
        from repro_torch.core.cost import cnn_cost
        return float(batch) * 2.0 * cnn_cost(cfg).fwd_macs()
    per = sum(block_fwd_flops(cfg, k, S, kv_len) for k in cfg.blocks)
    if cfg.shared_attn_every:
        p, a = _attn_flops(cfg, S, kv_len or S)
        per += cfg.num_layers // cfg.shared_attn_every * (p + a)
    if cfg.encoder_layers:
        enc_S = cfg.frontend_tokens or S
        per += cfg.encoder_layers * block_fwd_flops(cfg, BLOCK_ATTN, enc_S)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        per += cfg.num_layers * (2 * S * d * cfg.num_heads * hd * 2
                                 + 2 * S * enc_S * cfg.num_heads * hd * 2)
    head = 2 * S * cfg.d_model * cfg.vocab_size
    return float(batch) * (per + head)


def train_step_flops(cfg: ModelConfig, batch: int, S: int) -> float:
    """fwd + bwd ~ 3x fwd (dL/dx + dL/dw each ~ fwd)."""
    return 3.0 * model_fwd_flops(cfg, batch, S)


def model_flops_6nd(cfg: ModelConfig, batch: int, S: int) -> float:
    """MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE)."""
    return 6.0 * cfg.active_param_count() * batch * S


# ---------------------------------------------------------------------------
# training energy under the 45nm model
# ---------------------------------------------------------------------------


def training_energy_pj(cfg: ModelConfig, batch: int, S: int,
                       e2: E2TrainConfig, steps: int,
                       bits_default: int = 32,
                       psg_fallback_rate: float = PSG_FALLBACK_ASSUMED
                       ) -> float:
    """End-to-end training energy under the 45nm model (compute +
    movement) at the config's declared operating point (``smd``'s
    ``epochs_multiplier x (1 - drop_prob)``, ``slu.target_skip``); for the
    accounting of what executed use ``Trainer.energy_report()``
    (``core/ledger.py``).  ``psg_fallback_rate``: the share of the
    weight-gradient compute that ran the full-precision product."""
    macs = train_step_flops(cfg, batch, S) / 2.0
    if e2.psg.enabled:
        mac_pj = psg_mac_pj(e2.psg, psg_fallback_rate)
        move_bits = e2.psg.bits_x
    else:
        mac_pj = FP32_MAC_PJ if bits_default == 32 else mac_energy_pj(
            bits_default, bits_default)
        move_bits = bits_default
    compute = macs * mac_pj
    # data movement: every MAC's operands stream through SRAM once per tile
    if cfg.family == "cnn":
        from repro_torch.core.cost import cnn_cost
        moved_words = cnn_cost(cfg).moved_words(batch)
    else:
        moved_words = 3.0 * (cfg.param_count()
                             + batch * S * cfg.d_model * cfg.num_layers)
    movement = moved_words * move_energy_pj(move_bits)
    per_step = compute + movement
    eff_steps = steps
    if e2.smd.enabled:
        eff_steps = steps * (1 - e2.smd.drop_prob) * e2.smd.epochs_multiplier
    slu_keep = 1.0
    if e2.slu.enabled and e2.slu.target_skip:
        slu_keep = 1.0 - e2.slu.target_skip
    return per_step * eff_steps * slu_keep


# ---------------------------------------------------------------------------
# roofline terms (launch/bench_roofline.py, launch/dryrun.py)
# ---------------------------------------------------------------------------


def roofline_terms(hlo_flops: float, hlo_bytes: float, coll_bytes: float,
                   chips: int, hw: HW = H100_SXM) -> Dict[str, float]:
    """Seconds of a step's compute, memory and collective terms on
    ``chips`` devices of ``hw``, its bottleneck and its bound (the
    largest term)."""
    ct = hlo_flops / (chips * hw.peak_flops)
    mt = hlo_bytes / (chips * hw.hbm_bw)
    kt = coll_bytes / (chips * hw.ici_bw)
    dom = max((ct, "compute"), (mt, "memory"), (kt, "collective"))
    return {"compute_s": ct, "memory_s": mt, "collective_s": kt,
            "bottleneck": dom[1], "step_s": max(ct, mt, kt)}
