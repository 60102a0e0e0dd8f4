"""Configuration of the port's training paths, as frozen dataclasses.

The field names and defaults are those of the JAX package's
``repro.core.config`` so that one experiment reads the same in both
packages.  :class:`ModelConfig` keeps the CNN encoding (``family="cnn"``)
and the dense-transformer fields; the MoE and SSM fields are not ported.
Options this package does not implement raise ``NotImplementedError`` where
they are set, never a quiet substitute:

* ``TrainConfig.remat="full"``;
* block kinds other than ``"attn"``, sliding-window attention and the
  encoder/cross-attention/frontend fields (raised by
  ``models/transformer.py`` when such a model is built).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

BLOCK_ATTN = "attn"              # self-attention + dense MLP

# kernel backends of ``PSGConfig.backend`` (``kernels/dispatch.py``)
KERNEL_BACKENDS = ("auto", "reference", "plain", "cuda")
# the JAX package's names, refused with their counterparts named
JAX_BACKEND_NAMES = {"interpret": "plain", "mosaic": "cuda"}


def validate_backend(name: str) -> str:
    """``name`` if it is one of :data:`KERNEL_BACKENDS`; else a
    ``ValueError`` naming the valid backends (and, for a JAX package name,
    its counterpart here)."""
    if name in KERNEL_BACKENDS:
        return name
    hint = f"; the JAX package's {name!r} is {JAX_BACKEND_NAMES[name]!r} " \
        "here" if name in JAX_BACKEND_NAMES else ""
    raise ValueError(f"unknown kernel backend {name!r}; expected one of "
                     f"{KERNEL_BACKENDS}{hint}")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition.

    ``family="cnn"`` (``configs/paper_cnns.cnn_model``): ``num_layers`` is
    the CIFAR ResNet depth (6n+2), ``d_model`` the stage-0 width and
    ``vocab_size`` the class count; CNNs train in fp32.  Otherwise a
    transformer LM of ``num_layers`` blocks (``models/transformer.py``).
    """

    name: str
    family: str                      # dense | cnn (moe/ssm/hybrid not ported)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 -> full (causal) attention
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | relu
    glu: bool = True                 # gated MLP (SwiGLU-style) if True
    tie_embeddings: bool = False
    router_aux_coef: float = 0.01    # MoE load-balance weight (no MoE here)

    # repeating unit of block kinds, tiled to num_layers; empty -> "attn"
    # for the dense family
    block_unit: Tuple[str, ...] = ()

    # encoder/decoder and multimodal frontends: not ported (must stay off)
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: str = ""
    frontend_tokens: int = 0

    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Full per-layer block-kind tuple of length num_layers."""
        unit = self.block_unit
        if not unit:
            unit = {"moe": ("moe",), "ssm": ("mlstm",)}.get(self.family,
                                                           (BLOCK_ATTN,))
        reps = -(-self.num_layers // len(unit))
        return (unit * reps)[: self.num_layers]

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows: the vocab rounded up to a multiple of 128
        (vocabs under 1024 stay unpadded); the pad ids' logits are masked."""
        if self.vocab_size < 1024:
            return self.vocab_size
        return -(-self.vocab_size // 128) * 128

    def param_count(self) -> int:
        """Analytic parameter count (``attn`` blocks; a CNN config asks its
        per-layer cost table)."""
        if self.family == "cnn":
            from repro_torch.core.cost import cnn_cost
            return cnn_cost(self).param_count()
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += sum(self._block_params(kind, d, hd) for kind in self.blocks)
        return n + d                                  # final norm

    def _attn_params(self, d: int, hd: int) -> int:
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads * hd + 2 * self.num_kv_heads * hd) \
            if self.qkv_bias else 0
        return q + kv + o + b + 2 * d   # + norms

    def _mlp_params(self, d: int, dff: int) -> int:
        return (3 if self.glu else 2) * d * dff

    def _block_params(self, kind: str, d: int, hd: int) -> int:
        if kind == BLOCK_ATTN:
            return self._attn_params(d, hd) + self._mlp_params(d, self.d_ff)
        raise NotImplementedError(f"block kind {kind!r} is not ported "
                                  "(only dense 'attn' blocks)")


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
    # kernel backend of the PSG ops (kernels/dispatch.py): "auto" defers to
    # the dispatch layer (an override, the REPRO_TORCH_KERNEL_BACKEND pin,
    # else the tensors' device); "reference" | "plain" | "cuda" pin it.
    backend: str = "auto"
    # CNN convs (resolved by core/psg.fused_conv_active): True runs the
    # implicit-GEMM kernels (kernels/conv.py) in every direction, False the
    # materialized im2col + PSG matmul (models/resnet.py).  None = auto =
    # fused.
    fused_conv: Optional[bool] = None
    # transformer self-attention (resolved by fused_attention_active):
    # True runs the flash kernels with the PSG dk/dv backward
    # (kernels/flash_attn.py), False the materialized softmax
    # (models/layers.py).  None = auto = the flash kernels, as the JAX
    # package resolves it on every backend but Mosaic (which the port does
    # not have).
    fused_attention: Optional[bool] = None

    def __post_init__(self):
        validate_backend(self.backend)


def fused_attention_active(cfg: Optional[PSGConfig]) -> bool:
    """Resolve a config's ``fused_attention`` as the JAX package's
    ``core/psg.fused_attention_active`` does: no config (PSG off) is
    inactive, an explicit ``True``/``False`` wins, and ``None`` (auto)
    means the flash kernels (the JAX package's auto on every backend but
    Mosaic, which the port has no counterpart of)."""
    if cfg is None:
        return False
    return True if cfg.fused_attention is None else cfg.fused_attention


@dataclass(frozen=True)
class E2TrainConfig:
    smd: SMDConfig = field(default_factory=SMDConfig)
    slu: SLUConfig = field(default_factory=SLUConfig)
    psg: PSGConfig = field(default_factory=PSGConfig)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatches: int = 1             # gradient accumulation (train_step)
    lr: float = 0.1
    schedule: str = "step"            # step | cosine | constant
    warmup_steps: int = 0
    total_steps: int = 64_000         # paper: 64k iterations
    decay_points: Tuple[float, ...] = (0.5, 0.75)   # paper: 32k, 48k
    decay_factor: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    optimizer: str = "sgdm"           # sgdm | signsgd | psg | adamw
    grad_clip: float = 0.0
    remat: str = "block"              # none | block (full is not ported)
    seed: int = 0

    def __post_init__(self):
        if self.remat == "full":
            raise NotImplementedError("remat='full' is not ported; use "
                                      "'block' or 'none'")
        if self.remat not in ("none", "block"):
            raise ValueError(f"unknown remat {self.remat!r}")


@dataclass(frozen=True)
class Experiment:
    model: ModelConfig
    e2: E2TrainConfig = field(default_factory=E2TrainConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    # the ``repro_torch.tasks`` entry that builds and trains the model:
    # "lm" (models/transformer.py) or "cifar_cnn" (models/resnet.py)
    task: str = "lm"

    def replace(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)
