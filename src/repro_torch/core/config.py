"""Configuration of the CIFAR CNN training path, as frozen dataclasses.

The field names and defaults are those of the JAX package's
``repro.core.config`` so that one experiment reads the same in both
packages.  Only the CNN fields of :class:`ModelConfig` are kept, and only
the options this package implements: ``PSGConfig.fused_conv`` may be
``None`` (auto) or ``True``; ``False`` selects the materialized
im2col + PSG-matmul path, which this package does not have.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """``family="cnn"`` encoding (``configs/paper_cnns.cnn_model``):
    ``num_layers`` is the CIFAR ResNet depth (6n+2), ``d_model`` the
    stage-0 width and ``vocab_size`` the class count.  CNNs train in
    fp32."""

    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int


@dataclass(frozen=True)
class SMDConfig:
    enabled: bool = False
    drop_prob: float = 0.5            # paper default
    # executed compute relative to the baseline budget is
    # ``epochs_multiplier * (1 - drop_prob)``; the paper's Fig. 3a point is
    # p=0.5, m=4/3 -> energy ratio 0.67 (core/ledger.py).
    epochs_multiplier: float = 4.0 / 3.0


@dataclass(frozen=True)
class SLUConfig:
    enabled: bool = False
    alpha: float = 1e-3               # FLOPs-regularizer weight (Eq. 1)
    gate_hidden: int = 10             # LSTM hidden dim (paper: 10)
    gate_proj: int = 10               # pooled-feature projection dim (paper: 10)
    min_keep_prob: float = 0.05       # numerical floor on gate output
    target_skip: float = 0.0          # optional target ratio for reg normalization
    never_skip_first_last: bool = True


@dataclass(frozen=True)
class PSGConfig:
    enabled: bool = False
    bits_x: int = 8                   # activation precision (paper: 8)
    bits_g: int = 16                  # output-grad precision (paper: 16)
    bits_x_msb: int = 4               # predictor activation MSBs (paper: 4)
    bits_g_msb: int = 10              # predictor grad MSBs (paper: 10)
    beta: float = 0.05                # adaptive threshold ratio (paper: 0.05)
    swa: bool = True                  # stochastic weight averaging (paper uses SWA)
    swa_start_frac: float = 0.5
    # convs run through the implicit-GEMM kernels (kernels/conv.py) in
    # every direction.  None = auto = on; False (materialized im2col) is
    # not implemented in this package.
    fused_conv: Optional[bool] = None

    def __post_init__(self):
        if self.fused_conv is False:
            raise NotImplementedError(
                "fused_conv=False selects the materialized im2col + "
                "psg_matmul path, which repro_torch does not implement")


@dataclass(frozen=True)
class E2TrainConfig:
    smd: SMDConfig = field(default_factory=SMDConfig)
    slu: SLUConfig = field(default_factory=SLUConfig)
    psg: PSGConfig = field(default_factory=PSGConfig)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    microbatches: int = 1             # only 1 is implemented
    lr: float = 0.1
    schedule: str = "step"            # step | cosine | constant
    warmup_steps: int = 0
    total_steps: int = 64_000         # paper: 64k iterations
    decay_points: Tuple[float, ...] = (0.5, 0.75)   # paper: 32k, 48k
    decay_factor: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    optimizer: str = "sgdm"           # sgdm | signsgd | psg
    grad_clip: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class Experiment:
    model: ModelConfig
    e2: E2TrainConfig = field(default_factory=E2TrainConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    task: str = "cifar_cnn"
