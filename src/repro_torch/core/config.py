"""Configuration of the port's training and serving paths, as frozen
dataclasses.

The field names and defaults are those of the JAX package's
``repro.core.config`` so that one experiment reads the same in both
packages.  :class:`ModelConfig` keeps the CNN encoding (``family="cnn"``),
the transformer fields (dense, MoE, Mamba2, mLSTM, sLSTM and weight-shared
attention blocks, the encoder, cross-attention and frontends) and
``param_dtype``; :class:`ServeConfig` and :data:`SHAPES` the serving
shapes (``Experiment.with_shape``).  Options this package does not
implement raise ``NotImplementedError`` where they are set, never a quiet
substitute.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

BLOCK_ATTN = "attn"              # self-attention + dense MLP
BLOCK_MOE = "moe"                # self-attention + MoE FFN
BLOCK_MAMBA = "mamba"            # Mamba2 SSM mixer
BLOCK_MLSTM = "mlstm"            # xLSTM matrix-memory block
BLOCK_SLSTM = "slstm"            # xLSTM scalar-memory block
BLOCK_SHARED_ATTN = "shared_attn"  # zamba2-style weight-shared attention
BLOCK_KINDS = (BLOCK_ATTN, BLOCK_MOE, BLOCK_MAMBA, BLOCK_MLSTM, BLOCK_SLSTM,
               BLOCK_SHARED_ATTN)

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
    family: str                      # dense | moe | ssm | hybrid | audio
                                     # | vlm | cnn
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

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01    # load-balance loss weight

    # --- SSM / xLSTM ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    shared_attn_every: int = 0       # shared attn after every k blocks

    # repeating unit of block kinds, tiled to num_layers; empty -> "attn"
    # ("moe" for the moe family)
    block_unit: Tuple[str, ...] = ()

    # --- encoder/decoder and multimodal frontends ---
    encoder_layers: int = 0          # > 0: enc-dec (whisper)
    cross_attention: bool = False
    frontend: str = ""               # "" | "audio" | "vision"
    frontend_tokens: int = 0         # frontend embedding positions

    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"     # parameters (and their updates)

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
            unit = {"moe": (BLOCK_MOE,), "ssm": (BLOCK_MLSTM,)}.get(
                self.family, (BLOCK_ATTN,))
        reps = -(-self.num_layers // len(unit))
        return (unit * reps)[: self.num_layers]

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows: the vocab rounded up to a multiple of 128
        (vocabs under 1024 stay unpadded); the pad ids' logits are masked."""
        if self.vocab_size < 1024:
            return self.vocab_size
        return -(-self.vocab_size // 128) * 128

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch defines a sub-quadratic long-context path."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (the blocks, the encoder and
        cross-attention; a CNN config asks its per-layer cost table).  The
        JAX package's count, kept as it is: zamba2's shared attention is
        counted only under ``shared_attn_every``, which its config does not
        set, and the SSM kinds' terms are its estimates."""
        if self.family == "cnn":
            from repro_torch.core.cost import cnn_cost
            return cnn_cost(self).param_count()
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += sum(self._block_params(kind, d, hd) for kind in self.blocks)
        if self.shared_attn_every:
            n += self._attn_params(d, hd)
        n += d                                        # final norm
        if self.encoder_layers:
            n += self.encoder_layers * self._block_params(BLOCK_ATTN, d, hd)
            n += self.num_layers * self._attn_params(d, hd)   # cross
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token: an MoE model counts its ``top_k``
        routed experts (and its shared ones) of each MoE block, every other
        model all of its parameters (the JAX package's count)."""
        if self.family != "moe":
            return self.param_count()
        dff = self.moe_d_ff or self.d_ff
        inactive = (self.num_experts - self.top_k) * \
            self._mlp_params(self.d_model, dff)
        return self.param_count() - inactive * self.blocks.count(BLOCK_MOE)

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
        if kind == BLOCK_MOE:
            dff = self.moe_d_ff or self.d_ff
            experts = (self.num_experts + self.num_shared_experts) * \
                self._mlp_params(d, dff)
            return self._attn_params(d, hd) + experts + d * self.num_experts
        if kind == BLOCK_MAMBA:
            di = self.ssm_expand * d
            # in_proj (x,z), conv, ssm params (A,dt,B,C heads), out_proj, norm
            return 2 * d * di + self.ssm_conv_width * di \
                + 2 * di * self.ssm_state + 2 * di + di * d + 2 * d
        if kind in (BLOCK_MLSTM, BLOCK_SLSTM):
            di = self.ssm_expand * d
            # qkv + gates + out_proj (+ up/down ffn-ish projections)
            return 2 * d * di + 3 * di * hd_or(di) + di * d + 2 * d
        if kind == BLOCK_SHARED_ATTN:
            return 0         # its parameters are the model's ``shared``
        raise ValueError(f"unknown block kind {kind!r}")


def hd_or(x: int) -> int:   # the JAX package's helper of the mLSTM estimate
    return max(x // 8, 1)


def unit_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The repeating unit of block kinds that tiles ``cfg.blocks`` (one
    block when the config names no unit)."""
    return cfg.block_unit or (cfg.blocks[0],)


def sub_blocks(kind: str) -> Tuple[str, ...]:
    """A block kind's residual sub-blocks, SLU's gating granularity:
    ``attn`` and ``moe`` a mixer and an ffn, the others one mixer."""
    return ("mixer", "ffn") if kind in (BLOCK_ATTN, BLOCK_MOE) \
        else ("mixer",)


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
    majority_vote: bool = False       # beyond-paper: 1-bit sign all-reduce
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
    # under a mesh, the forward gathers a PSG weight as int8 codes of its
    # FSDP shards on the global grid instead of gathering the weight
    # (distributed/fsdp.int8_gather)
    int8_gather: bool = False

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

    @classmethod
    def full(cls) -> "E2TrainConfig":
        return cls(
            smd=SMDConfig(enabled=True),
            slu=SLUConfig(enabled=True),
            psg=PSGConfig(enabled=True),
        )

    @classmethod
    def off(cls) -> "E2TrainConfig":
        return cls()


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
    # none | block | full.  "full" is the JAX package's value, whose
    # lm_fwd checkpoints only under "block": it computes what "none" does,
    # and so does the port (models/transformer.py)
    remat: str = "block"
    seed: int = 0

    def __post_init__(self):
        if self.remat not in ("none", "block", "full"):
            raise ValueError(f"unknown remat {self.remat!r}")


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 32
    prefill_len: int = 32768
    max_kv_len: int = 32768
    decode_steps: int = 1


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")
    # logical->physical rules, e.g. fsdp shards params over "data"
    fsdp: bool = True
    seq_shard: bool = False           # SP: shard sequence over model axis


# The four shape cells of the JAX package (LM shapes are seq_len x
# global_batch): one training shape, three serving shapes.
SHAPES: Mapping[str, Mapping[str, Any]] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


@dataclass(frozen=True)
class Experiment:
    model: ModelConfig
    e2: E2TrainConfig = field(default_factory=E2TrainConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # the ``repro_torch.tasks`` entry that builds and trains the model:
    # "lm" (models/transformer.py) or "cifar_cnn" (models/resnet.py)
    task: str = "lm"

    def with_shape(self, shape: str) -> "Experiment":
        """The experiment at a :data:`SHAPES` cell: a training cell sets
        ``train``'s sequence and batch, a serving cell ``serve``'s batch,
        prefill length and KV length."""
        s = SHAPES[shape]
        if s["kind"] == "train":
            return dataclasses.replace(self, train=dataclasses.replace(
                self.train, seq_len=s["seq_len"],
                global_batch=s["global_batch"]))
        return dataclasses.replace(self, serve=dataclasses.replace(
            self.serve, batch=s["global_batch"], prefill_len=s["seq_len"],
            max_kv_len=s["seq_len"]))

    def replace(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)


def shape_applicable(model: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether a shape cell applies to an arch, and why not: ``long_500k``
    needs a sub-quadratic path (an SSM, a hybrid or a sliding window)."""
    if shape == "long_500k" and not model.is_subquadratic:
        return False, ("pure full-attention arch: no sub-quadratic 500k "
                       "path (DESIGN.md §5)")
    return True, ""
