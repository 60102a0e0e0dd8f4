"""Transformer LM with SLU-gated sub-blocks and PSG matmuls: dense and MoE
decoders, the xLSTM and Mamba2 stacks (xlstm-350m, zamba2's hybrid with its
weight-shared attention), the encoder-decoder (whisper) and the VLM
(phi-3-vision).

The counterpart of the JAX package's ``models/transformer.py``: ``attn``
blocks (self-attention + dense MLP), ``moe`` blocks (self-attention + the
MoE FFN of ``models/moe.py``), ``mamba``, ``mlstm`` and ``slstm`` blocks
(``ln1`` and the mixer of ``models/ssm.py``) and ``shared_attn`` blocks
(zamba2: one top-level ``shared = {ln, attn}`` module, the same at every
call, so its gradient sums over the calls).  The JAX scan over stacked
units of ``cfg.block_unit`` becomes a Python loop over per-layer modules
(``layers.<j>``, a ``shared_attn`` layer an empty one, and ``encoder.<i>``
and ``cross.<i>`` for the enc-dec), so a JAX tree loads through
``repro_torch.convert.lm_state_dict_from_jax``.

SLU gates each residual sub-block (an ``attn`` or ``moe`` block's mixer,
then its ffn; an SSM block's mixer) with the weight-shared gate, whose LSTM
state runs through the gated sub-blocks in order; ``shared_attn`` is never
gated.  The keys are the JAX package's (``core/slu.lm_uniforms``): block
``i`` of unit ``u`` folds ``u`` and then ``i`` into the step key and splits
the result into the mixer's and the ffn's key; the first and last block
(global index ``u * len(unit) + i``) always run.  So, from the same
parameters and step key, the decisions are the JAX package's.
A gated MoE ffn draws the same keep as a dense one and carries its
load-balance loss out of the gate: unscaled where it runs, 0 where it is
skipped (the reference's ``lax.cond`` pair; ``core/slu.gated_residual``'s
``has_aux``).

``remat="block"`` checkpoints each executed sub-block's branch, and each
decoder layer's cross-attention, (``torch.utils.checkpoint``,
non-reentrant) after its SLU decision has been taken, so the recompute is
deterministic and the gradients equal those of ``remat="none"``.  The JAX
package checkpoints whole units; here the ffn's decision depends on the
mixer's output, so the checkpoint is per sub-block.  ``remat="full"``
checkpoints nothing, as in the JAX package's ``lm_fwd``.

On a data-parallel mesh whose placement shards parameters
(``distributed/fsdp.py``), each sub-block (and each encoder layer and
cross-attention) makes its weights whole when it starts and drops them when
it ends (``fsdp.gathered``), and the tied embedding and head are gathered
at each use (``fsdp.whole``).  The gather sits inside the checkpointed
region, and every gathering region is checkpointed whatever ``remat`` says
(while grad is on), so no whole weight waits in autograd's saved tensors
for the backward: the recompute gathers again.  A skipped sub-block
gathers nothing, on every rank alike.

Attention takes the JAX package's paths (``layers.attention_fwd``), with
sliding-window masks; it prefers the query-chunked softmax from 1024
tokens unless the model trains with every block ``attn`` or ``moe``, as
the JAX package's ``lm_fwd`` does (``prefer_chunked = not sp``: its
sequence parallelism, which keeps training off that path, holds only for
such units).

Frontends (stubs in both packages) come in as embeddings ``(B, F, d)``:

* the enc-dec (``encoder_layers > 0``) runs them through a bidirectional
  encoder of ``attn`` blocks (unmasked materialized softmax, RoPE, every
  layer checkpointed whatever ``remat`` says, never SLU-gated) and
  ``enc_norm``; every decoder layer then adds cross-attention over that
  memory after its whole block, as the reference's ``lm_fwd`` does (its
  ``prefill_to_state``/``decode_step`` add it between attention and MLP);
* the VLM prepends them to the token embeddings: positions, SLU's FLOPs
  and the logits run over ``F + S``, and ``lm_loss`` keeps the text tail.

Serving (the JAX package's decode functions): :func:`prefill_to_state` runs
a prompt through every layer once and hands over the decode state (KV
caches, SSM states, positions), :func:`decode_step` runs one token against
it, updating it in place, and :func:`init_decode_state` makes an empty one.
The state is one entry a layer (``layers.<j>``), where the JAX package
stacks it per unit (``convert.decode_state_tree`` maps the two).  Both run
under ``torch.no_grad()``, outside any PSG context and with no SLU gate,
as the reference serves; only the last position's logits are made.
"""
from __future__ import annotations

from itertools import groupby
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import psg, rng
from repro_torch.core.config import (BLOCK_ATTN, BLOCK_KINDS, BLOCK_MOE,
                                     BLOCK_SHARED_ATTN, E2TrainConfig,
                                     ModelConfig, sub_blocks, unit_kinds)
from repro_torch.core.cost import cost_scope
from repro_torch.core.energy import block_fwd_flops
from repro_torch.core.slu import Gate, flops_regularizer, gated_residual, \
    lm_uniforms
from repro_torch.distributed import fsdp, sharding
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm


def check_supported(cfg: ModelConfig) -> None:
    """Refuse an unknown block kind, or a depth the unit does not tile (the
    JAX package's ``init_lm`` asserts it)."""
    unknown = set(cfg.blocks) - set(BLOCK_KINDS)
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds "
                         f"{sorted(unknown)}; known: {BLOCK_KINDS}")
    unit = unit_kinds(cfg)
    if cfg.num_layers % len(unit):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} not "
                         f"divisible by unit {unit}")


class Block(nn.Module):
    """One block: ``attn`` (pre-norm attention, then pre-norm MLP), ``moe``
    (the MLP an MoE FFN), ``mamba``/``mlstm``/``slstm`` (pre-norm mixer,
    held under the kind's name) or ``shared_attn`` (no parameters: they
    are the model's ``shared``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 kind: str = BLOCK_ATTN):
        super().__init__()
        dev = generator.device
        self.kind = kind
        if kind == BLOCK_SHARED_ATTN:
            return
        self.ln1 = L.Norm(cfg, dev)
        if kind in ssm.MIXERS:
            setattr(self, kind, ssm.MIXERS[kind][0](cfg, generator))
            return
        self.attn = L.Attention(cfg, generator)
        self.ln2 = L.Norm(cfg, dev)
        if kind == BLOCK_MOE:
            self.moe = M.MoE(cfg, generator)
        else:
            self.mlp = L.MLP(cfg, generator)


class NormAttention(nn.Module):
    """``ln`` then ``attn``: a decoder layer's cross-attention, or zamba2's
    weight-shared attention."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.ln = L.Norm(cfg, generator.device)
        self.attn = L.Attention(cfg, generator)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, e2: Optional[E2TrainConfig] = None,
                 seed: int = 0, device=None):
        """Parameters from ``seed`` (``torch.Generator`` draws, not the JAX
        init's), made on ``device`` (default: the CPU; on ``meta`` nothing
        is drawn or allocated)."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.unit = unit_kinds(cfg)
        self.e2 = e2 or E2TrainConfig()
        g = L.init_generator(seed, device)
        pd = L.param_dtype(cfg)
        self.embed = nn.Parameter(L.embed_init((cfg.padded_vocab, cfg.d_model),
                                               g, dtype=pd))
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            L.dense_init((cfg.d_model, cfg.padded_vocab), g, dtype=pd))
        self.final_norm = L.Norm(cfg, g.device)
        self.layers = nn.ModuleList(Block(cfg, g, kind)
                                    for kind in cfg.blocks)
        if BLOCK_SHARED_ATTN in self.unit or cfg.shared_attn_every:
            self.shared = NormAttention(cfg, g)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(Block(cfg, g)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = L.Norm(cfg, g.device)
            self.cross = nn.ModuleList(NormAttention(cfg, g)
                                       for _ in range(cfg.num_layers))
        self.slu_gate = Gate(cfg.d_model, self.e2.slu, g) \
            if self.e2.slu.enabled else None

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over frontend embeddings (activation dtype): every
        layer checkpointed (the JAX package's ``jax.checkpoint``, which
        keeps its O(F^2) scores out of the saved residuals), then
        ``enc_norm``."""
        x = embeds
        for blk in self.encoder:
            fn = _in_context(_gathered(
                lambda h, blk=blk: _encoder_layer(blk, h, self.cfg), (blk,)))
            x = _checkpointed(fn)(x) if torch.is_grad_enabled() else fn(x)
        return self.enc_norm(x)

    def forward(self, tokens: torch.Tensor, key: Optional[rng.Key] = None,
                remat: str = "block", slu_u=None,
                frontend: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (fp32 logits (B, S', V), aux{aux_loss,
        slu_cost, slu_executed (units, sub-blocks a unit), slu_keep_probs
        (sub-blocks,)}); ``S' = F + S`` for the VLM, else S.  A unit's
        sub-blocks are its ``attn``/``moe`` blocks' two, its other blocks'
        one; ungated ones (``shared_attn``, every one in eval mode) count as
        kept with probability 1.  One-block ``attn``/``moe`` units give
        ``(L, 2)`` and ``(2 L,)``.

        ``frontend`` (B, F, d): the encoder's input (enc-dec) or the
        prepended patch embeddings (VLM); cast to the activation dtype.
        ``key`` is the step's threefry key (``fold_in(PRNGKey(seed),
        step)``, default ``PRNGKey(0)``); ``slu_u`` gives the uniforms of
        its SLU draws instead (``core/slu.lm_uniforms`` of that key; a CUDA
        tensor inside a captured step).  ``remat`` is ``"block"`` (each
        executed sub-block checkpointed) or ``"none"``/``"full"`` (nothing
        checkpointed).  In eval mode (``self.training`` false) every
        sub-block runs ungated, nothing is checkpointed and attention
        prefers the query-chunked path: the JAX package's
        ``lm_fwd(train=False, remat="none")``."""
        cfg, slu_cfg = self.cfg, self.e2.slu
        key = rng.PRNGKey(0) if key is None else key
        dt = getattr(torch, cfg.dtype)
        # the audit's groups (core/cost.cost_scope): embed, unit, head
        with cost_scope("embed"):
            x = sharding.embed(fsdp.whole(self, "embed"), tokens, dt)
        memory = None
        if cfg.encoder_layers:
            if frontend is None:
                raise ValueError(f"{cfg.name}: an enc-dec model needs its "
                                 "frontend embeddings")
            memory = self.encode(frontend.to(dt))
        elif frontend is not None:                   # VLM: prepend patches
            x = torch.cat([frontend.to(dt), x], dim=1)
        S = x.shape[1]
        n = cfg.num_layers
        gate = self.slu_gate if self.training else None
        remat = remat if self.training else "none"
        # a sharded model checkpoints every gathering region (module doc)
        ckpt = remat == "block" or (fsdp.is_sharded(self)
                                    and torch.is_grad_enabled())
        # the reference's sequence parallelism (sp) keeps training off the
        # query-chunked softmax, and holds only for attn/moe units.  On
        # DTensors the stream is pinned batch-sharded between units (its
        # sequence axis is not sharded: DTensor's placement of a flattened
        # (batch, seq) pair sharded on both is a strided shard, whose index
        # arithmetic costs seconds an op and which it views to wrong local
        # shapes)
        prefer_chunked = not (self.training and all(
            k in (BLOCK_ATTN, BLOCK_MOE) for k in self.unit))
        stream_axes = ("batch", None, None)
        x = sharding.hint(x, *stream_axes)
        gst = gate.init_state() if gate is not None else None
        if gate is not None and slu_u is None:
            slu_u = lm_uniforms(key, cfg)
        kps, exs = [], []
        drawn = 0                                  # uniforms used so far
        aux_loss = torch.zeros((), device=x.device)
        with cost_scope("unit"):
            for i, blk in enumerate(self.layers):
                if i % len(self.unit) == 0:      # re-pin at each unit
                    x = sharding.hint(x, *stream_axes)
                force = slu_cfg.never_skip_first_last and i in (0, n - 1)
                subs = _sub_block_fns(self, blk, prefer_chunked)
                for j, (fn, mods) in enumerate(subs):
                    has_aux = blk.kind == BLOCK_MOE and j == 1
                    if ckpt:
                        fn = _checkpointed(fn)
                    if gate is None or blk.kind == BLOCK_SHARED_ATTN:
                        y = fn(x)
                        if has_aux:
                            y, a = y
                            aux_loss = aux_loss + a
                        x = x + y
                        kps.append(torch.ones((), device=x.device))
                        exs.append(torch.ones((), device=x.device))
                        continue
                    p, gst = gate(x, gst)
                    out = gated_residual(fn, x, p, slu_u[drawn], force,
                                         modules=mods, has_aux=has_aux)
                    drawn += 1
                    x, ex = out[0], out[1]
                    if has_aux:
                        aux_loss = aux_loss + out[2]
                    kps.append(p)
                    exs.append(ex)
                if memory is not None and blk.kind == BLOCK_ATTN:
                    cross = _cross(self.cross[i], memory, cfg)
                    x = x + (_checkpointed(cross) if ckpt else cross)(x)
        with cost_scope("head"):
            logits = self.logits(x)
        kps_t = torch.stack(kps)
        n_units = n // len(self.unit)
        if gate is not None:
            flops = unit_flops(cfg, S, x.device).repeat(n_units)
            slu_cost = flops_regularizer(kps_t, flops)
        else:
            slu_cost = torch.ones((), device=x.device)
        aux = {"aux_loss": aux_loss, "slu_cost": slu_cost,
               "slu_keep_probs": kps_t,
               "slu_executed": torch.stack(exs).reshape(n_units, -1)}
        return logits, aux


    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``final_norm``, then the head (the tied embedding's transpose
        unless the model has its own): fp32 logits, the padded vocabulary's
        ids masked to -1e30 (never predicted)."""
        cfg = self.cfg
        # the stream batch-sharded and the logits vocab-sharded (on
        # DTensors): the head's gradient stays a (d, V / model) shard
        x = sharding.hint(self.final_norm(x), "batch", None, None)
        head = fsdp.whole(self, "embed").T if self.head is None \
            else fsdp.whole(self, "head")
        logits = sharding.hint((x @ head.to(x.dtype)).float(),
                               "batch", None, "vocab")
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=x.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits


def _in_context(body):
    """``body`` under the PSG context of its first call, also when a
    checkpoint recomputes it later, outside that context (the gated
    residual runs a sub-block under its own alias of the probe)."""
    ctx = []

    def fn(h):
        if not ctx:
            ctx.append(psg.snapshot())
        with psg.enable(*ctx[0]):
            return body(h)
    return fn


def _gathered(body, modules, psg_weights: bool = True):
    """``body`` with the sharded weights of ``modules`` whole
    (``distributed/fsdp.gathered``); with ``psg_weights`` (every sharded
    weight of the modules feeds a PSG matmul) and the active config's
    ``int8_gather``, they stay shards in the activation dtype, whose int8
    codes the PSG ops gather.  Wrap it in :func:`_in_context`, so that a
    recompute sees the config of the first call."""
    def fn(h):
        cfg = psg.active_config()
        int8 = psg_weights and cfg is not None and cfg.int8_gather
        with fsdp.gathered(modules, h.dtype if int8 else None):
            return body(h)
    return fn


def _encoder_layer(blk: Block, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    x = sharding.hint_batch(x)
    x = x + L.attention_fwd(blk.attn, blk.ln1(x), cfg, causal=False)
    return x + L.mlp_fwd(blk.mlp, blk.ln2(x), cfg)


def unit_flops(cfg: ModelConfig, S: int, device=None) -> torch.Tensor:
    """Analytic forward FLOPs of each sub-block of one unit, fp32 (the JAX
    package's ``unit_flops``: a block's FLOPs split evenly over its
    sub-blocks), one fill per run of equal values, so that a captured step
    copies nothing from the host."""
    vals = [block_fwd_flops(cfg, kind, S) / len(sub_blocks(kind))
            for kind in unit_kinds(cfg) for _ in sub_blocks(kind)]
    return torch.cat([torch.full((len(list(run)),), v, device=device)
                      for v, run in groupby(vals)])


def _sub_block_fns(model: TransformerLM, blk: Block, prefer_chunked: bool):
    """``(fn, modules)`` of each residual sub-block of ``blk`` in order:
    ``fn(h)`` the branch added to the stream (its weights gathered where
    they are sharded, under the PSG context of its first call), ``modules``
    the ones holding the parameters it reads."""
    cfg = model.cfg

    def sub(body, *mods, psg_weights=True):
        return _in_context(_gathered(body, mods, psg_weights)), mods

    if blk.kind == BLOCK_SHARED_ATTN:
        sh = model.shared
        return (sub(lambda h: L.attention_fwd(sh.attn, sh.ln(h), cfg,
                                              prefer_chunked),
                    sh.ln, sh.attn),)
    if blk.kind in ssm.MIXERS:                  # plain products: no PSG
        mixer = getattr(blk, blk.kind)
        return (sub(lambda h: ssm.mixer_fwd(blk.kind, mixer, blk.ln1(h),
                                            cfg),
                    blk.ln1, mixer, psg_weights=False),)
    mixer = sub(lambda h: L.attention_fwd(blk.attn, blk.ln1(h), cfg,
                                          prefer_chunked), blk.ln1, blk.attn)
    if blk.kind == BLOCK_MOE:
        return (mixer, sub(lambda h: M.moe_fwd(blk.moe, blk.ln2(h), cfg),
                           blk.ln2, blk.moe))
    return (mixer, sub(lambda h: L.mlp_fwd(blk.mlp, blk.ln2(h), cfg),
                       blk.ln2, blk.mlp))


def _cross(cb: NormAttention, memory: torch.Tensor, cfg: ModelConfig):
    # the cross-attention's products are plain, also under PSG
    return _gathered(lambda h: L.cross_attention_fwd(cb.attn, cb.ln(h),
                                                     memory, cfg), (cb,),
                     psg_weights=False)


def _checkpointed(fn):
    # the branch draws nothing from torch's generators: no RNG state to keep
    return lambda h: checkpoint(fn, h, use_reentrant=False,
                                preserve_rng_state=False)


def lm_loss(model: TransformerLM, batch: Dict[str, torch.Tensor],
            key: Optional[rng.Key] = None, remat: str = "block", slu_u=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross-entropy (``logsumexp - label logit`` over
    labels >= 0, on the text tail of a VLM's logits) plus
    ``router_aux_coef * aux_loss`` (the MoE blocks' load-balance loss) and
    ``alpha * slu_cost`` (Eq. 1); returns ``(total, metrics)``."""
    cfg, e2 = model.cfg, model.e2
    logits, aux = model(batch["tokens"], key=key, remat=remat, slu_u=slu_u,
                        frontend=batch.get("frontend"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:          # VLM prepended patches
        logits = logits[:, -labels.shape[1]:]
    mask = (labels >= 0).float()
    ll = sharding.take_last(logits, labels.clamp_min(0))
    nll = sharding.logsumexp(logits, dim=-1) - ll
    loss = sharding.global_sum(torch.sum(nll * mask)) / torch.clamp_min(
        sharding.global_sum(torch.sum(mask)), 1.0)
    total = loss + cfg.router_aux_coef * aux["aux_loss"]
    if e2.slu.enabled:
        total = total + e2.slu.alpha * aux["slu_cost"]
    metrics = {"loss": loss, "aux_loss": aux["aux_loss"],
               "slu_cost": aux["slu_cost"],
               "slu_exec_ratio": aux["slu_executed"].mean()}
    return total, metrics


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

# {"layers": one state a layer, "pos": (B,) int32 absolute positions}: an
# ``attn``/``moe``/``shared_attn`` layer holds ``{"kv": (k, v)}``, each
# zamba2 shared-attention call its own; an SSM layer its mixer's state
DecodeState = Dict[str, Any]


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16, device=None
                      ) -> DecodeState:
    """Zero decode state: KV caches of ``max_len`` slots (a ring of
    ``min(max_len, window)`` under a sliding window) in ``dtype``, the SSM
    states in fp32, positions 0."""
    layers: List[Dict[str, Any]] = []
    for kind in cfg.blocks:
        if kind in ssm.MIXERS:
            layers.append(getattr(ssm, f"init_{kind}_state")(
                cfg, batch, device=device))
        else:
            layers.append({"kv": L.init_kv_cache(cfg, batch, max_len, dtype,
                                                 device)})
    return {"layers": layers,
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def _self_attention(model: TransformerLM, blk: Block):
    """``(norm, attention)`` of an ``attn``/``moe`` block, or the shared
    ones of a ``shared_attn`` call."""
    if blk.kind == BLOCK_SHARED_ATTN:
        return model.shared.ln, model.shared.attn
    return blk.ln1, blk.attn


def _serve_ffn(model: TransformerLM, i: int, blk: Block, x: torch.Tensor,
               memory: Optional[torch.Tensor]) -> torch.Tensor:
    """The rest of an ``attn``/``moe`` block after its attention at serve:
    the enc-dec's cross-attention over ``memory`` (between attention and
    MLP, as the JAX package's ``prefill_to_state``/``decode_step`` put it),
    then the MLP or the MoE FFN."""
    cfg = model.cfg
    if memory is not None and blk.kind == BLOCK_ATTN:
        x = x + _cross(model.cross[i], memory, cfg)(x)
    h = blk.ln2(x)
    if blk.kind == BLOCK_ATTN:
        return x + L.mlp_fwd(blk.mlp, h, cfg)
    return x + M.moe_fwd(blk.moe, h, cfg)[0]


def _memory(model: TransformerLM, memory: Optional[torch.Tensor]):
    if model.cfg.encoder_layers and memory is None:
        raise ValueError(f"{model.cfg.name}: an enc-dec model needs its "
                         "encoder's memory (or, to prefill, the frontend "
                         "embeddings it encodes)")
    return memory


@torch.no_grad()
def prefill_to_state(model: TransformerLM, tokens: torch.Tensor,
                     max_kv_len: int, memory: Optional[torch.Tensor] = None,
                     frontend: Optional[torch.Tensor] = None,
                     cache_dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, DecodeState]:
    """Bulk prefill: tokens (B, S) through every layer in one forward
    that returns the decode state, the prefill-to-decode handoff (the JAX
    package's ``prefill_to_state``).  Returns the last position's fp32
    logits (B, 1, V) and the state at position ``S`` (``F + S`` for the
    VLM, whose ``frontend`` patches are prepended); the enc-dec takes its
    ``memory``, or runs its encoder over ``frontend``.  No SLU, no PSG,
    no autograd: every block runs, on plain products."""
    cfg = model.cfg
    dt = getattr(torch, cfg.dtype)
    x = model.embed[tokens].to(dt)
    if cfg.encoder_layers:
        if memory is None and frontend is not None:
            memory = model.encode(frontend.to(dt))
        memory = _memory(model, memory)
    elif frontend is not None:                       # VLM: prepend patches
        x = torch.cat([frontend.to(dt), x], dim=1)
    layers: List[Dict[str, Any]] = []
    for i, blk in enumerate(model.layers):
        if blk.kind in ssm.MIXERS:
            y, st = ssm.MIXERS[blk.kind][1](getattr(blk, blk.kind),
                                            blk.ln1(x), cfg,
                                            return_state=True)
            x = x + y
            layers.append(st)
            continue
        ln, attn = _self_attention(model, blk)
        y, (k, v) = L.attention_fwd(attn, ln(x), cfg, return_kv=True)
        x = x + y
        layers.append({"kv": L.fill_kv_cache(cfg, k, v, max_kv_len,
                                             cache_dtype)})
        if blk.kind != BLOCK_SHARED_ATTN:
            x = _serve_ffn(model, i, blk, x, memory)
    pos = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                     device=x.device)
    return model.logits(x[:, -1:]), {"layers": layers, "pos": pos}


@torch.no_grad()
def decode_step(model: TransformerLM, token: torch.Tensor,
                state: DecodeState, memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """token (B, 1) -> (fp32 logits (B, 1, V), ``state``) one position on
    (the JAX package's ``decode_step``; no SLU, no PSG).  ``state`` is
    updated in place: each cache gets the new key and value at its slot,
    each SSM state its step's values, and ``pos`` advances by 1, all on
    the device, with nothing read to the host."""
    cfg = model.cfg
    memory = _memory(model, memory)
    x = sharding.embed(model.embed, token, getattr(torch, cfg.dtype))
    pos = state["pos"]
    unit = len(model.unit)
    for i, (blk, st) in enumerate(zip(model.layers, state["layers"])):
        if i % unit == 0:
            x = sharding.hint_batch(x)
        if blk.kind in ssm.MIXERS:
            y, new = getattr(ssm, f"{blk.kind}_step")(
                getattr(blk, blk.kind), blk.ln1(x), st, cfg)
            for k, t in new.items():
                st[k].copy_(t)
            x = x + y
            continue
        ln, attn = _self_attention(model, blk)
        x = x + L.attention_decode(attn, ln(x), cfg, st["kv"], pos)[0]
        if blk.kind != BLOCK_SHARED_ATTN:
            x = _serve_ffn(model, i, blk, x, memory)
    pos.add_(1)
    return model.logits(x), state
