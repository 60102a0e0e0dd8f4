"""Dense transformer LM with SLU-gated sub-blocks and PSG matmuls.

The counterpart of the JAX package's ``models/transformer.py`` for
``attn`` blocks (self-attention + dense MLP).  The JAX scan over stacked
units becomes a Python loop over per-layer modules (``layers.<i>``), so a
JAX tree loads through ``repro_torch.convert.lm_state_dict_from_jax``.

SLU gates each residual sub-block (mixer, then ffn) with the weight-shared
gate, whose LSTM state runs through the sub-blocks in order.  The keys are
the JAX package's: layer ``i`` folds ``i`` (its unit index) and then 0 (its
place in the one-block unit) into the step key and splits the result into
the mixer's and the ffn's key; the first and last layer always run.  So,
from the same parameters and step key, the decisions are the JAX package's.

``remat="block"`` checkpoints each executed sub-block's branch
(``torch.utils.checkpoint``, non-reentrant) after its SLU decision has been
taken, so the recompute is deterministic and the gradients equal those of
``remat="none"``.  The JAX package checkpoints whole units; here the ffn's
decision depends on the mixer's output, so the checkpoint is per sub-block.

Not ported (raise when such a model is built): block kinds other than
``attn``, sliding-window attention, encoder/cross-attention and frontends.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import psg, rng
from repro_torch.core.config import BLOCK_ATTN, E2TrainConfig, ModelConfig
from repro_torch.core.energy import block_fwd_flops
from repro_torch.core.slu import Gate, flops_regularizer, gated_residual, \
    lm_uniforms
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.blocks)
    if kinds != {BLOCK_ATTN}:
        raise NotImplementedError(f"{cfg.name}: block kinds {sorted(kinds)} "
                                  "are not ported (only 'attn')")
    if cfg.sliding_window:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention "
                                  "needs a masked path that is not ported")
    if cfg.encoder_layers or cfg.cross_attention or cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: encoder, cross-attention "
                                  "and frontends are not ported")


class Block(nn.Module):
    """One ``attn`` block: pre-norm attention, then pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = L.Norm(cfg, dev)
        self.attn = L.Attention(cfg, generator)
        self.ln2 = L.Norm(cfg, dev)
        self.mlp = L.MLP(cfg, generator)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, e2: Optional[E2TrainConfig] = None,
                 seed: int = 0, device=None):
        """Parameters from ``seed`` (``torch.Generator`` draws, not the JAX
        init's), made on ``device`` (default: the CPU)."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.e2 = e2 or E2TrainConfig()
        g = torch.Generator(device=device or "cpu").manual_seed(seed)
        self.embed = nn.Parameter(L.embed_init((cfg.padded_vocab, cfg.d_model),
                                               g))
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            L.dense_init((cfg.d_model, cfg.padded_vocab), g))
        self.final_norm = L.Norm(cfg, g.device)
        self.layers = nn.ModuleList(Block(cfg, g)
                                    for _ in range(cfg.num_layers))
        self.slu_gate = Gate(cfg.d_model, self.e2.slu, g) \
            if self.e2.slu.enabled else None

    def forward(self, tokens: torch.Tensor, key: Optional[rng.Key] = None,
                remat: str = "block", slu_u=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (fp32 logits (B, S, V), aux{slu_cost,
        slu_executed (L, 2), slu_keep_probs (2L,)}).

        ``key`` is the step's threefry key (``fold_in(PRNGKey(seed),
        step)``, default ``PRNGKey(0)``); ``slu_u`` gives the uniforms of
        its SLU draws instead (``core/slu.lm_uniforms`` of that key; a CUDA
        tensor inside a captured step).  In eval mode (``self.training``
        false) every sub-block runs ungated and nothing is checkpointed:
        the JAX package's ``lm_fwd(train=False, remat="none")``."""
        cfg, slu_cfg = self.cfg, self.e2.slu
        key = rng.PRNGKey(0) if key is None else key
        dt = getattr(torch, cfg.dtype)
        x = self.embed[tokens].to(dt)
        S = x.shape[1]
        n = cfg.num_layers
        gate = self.slu_gate if self.training else None
        remat = remat if self.training else "none"
        gst = gate.init_state() if gate is not None else None
        if gate is not None and slu_u is None:
            slu_u = lm_uniforms(key, n)
        kps, exs = [], []
        for i, blk in enumerate(self.layers):
            force = slu_cfg.never_skip_first_last and i in (0, n - 1)
            subs = ((_mixer(blk, cfg), (blk.ln1, blk.attn)),
                    (_ffn(blk, cfg), (blk.ln2, blk.mlp)))
            for j, (fn, mods) in enumerate(subs):
                if remat == "block":
                    fn = _checkpointed(fn)
                if gate is None:
                    x = x + fn(x)
                    kps.append(torch.ones((), device=x.device))
                    exs.append(torch.ones((), device=x.device))
                    continue
                p, gst = gate(x, gst)
                x, ex = gated_residual(fn, x, p, slu_u[2 * i + j], force,
                                       modules=mods)
                kps.append(p)
                exs.append(ex)
        x = self.final_norm(x)
        head = self.embed.T if self.head is None else self.head
        logits = (x @ head.to(dt)).float()
        if cfg.padded_vocab != cfg.vocab_size:      # pad ids never predicted
            pad = torch.arange(cfg.padded_vocab, device=x.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        kps_t = torch.stack(kps)
        if gate is not None:
            flops = block_fwd_flops(cfg, BLOCK_ATTN, S) / 2.0
            slu_cost = flops_regularizer(kps_t, torch.full_like(kps_t, flops))
        else:
            slu_cost = torch.ones((), device=x.device)
        aux = {"slu_cost": slu_cost, "slu_keep_probs": kps_t,
               "slu_executed": torch.stack(exs).reshape(n, 2)}
        return logits, aux


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


def _mixer(blk: Block, cfg: ModelConfig):
    return _in_context(lambda h: L.attention_fwd(blk.attn, blk.ln1(h), cfg))


def _ffn(blk: Block, cfg: ModelConfig):
    return _in_context(lambda h: L.mlp_fwd(blk.mlp, blk.ln2(h), cfg))


def _checkpointed(fn):
    # the branch draws nothing from torch's generators: no RNG state to keep
    return lambda h: checkpoint(fn, h, use_reentrant=False,
                                preserve_rng_state=False)


def lm_loss(model: TransformerLM, batch: Dict[str, torch.Tensor],
            key: Optional[rng.Key] = None, remat: str = "block", slu_u=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross-entropy (``logsumexp - label logit`` over
    labels >= 0) plus ``alpha * slu_cost`` (Eq. 1); returns ``(total,
    metrics)``."""
    cfg, e2 = model.cfg, model.e2
    logits, aux = model(batch["tokens"], key=key, remat=remat, slu_u=slu_u)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ll = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - ll
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    aux_loss = torch.zeros((), device=logits.device)   # no MoE blocks
    total = loss + cfg.router_aux_coef * aux_loss
    if e2.slu.enabled:
        total = total + e2.slu.alpha * aux["slu_cost"]
    metrics = {"loss": loss, "aux_loss": aux_loss,
               "slu_cost": aux["slu_cost"],
               "slu_exec_ratio": aux["slu_executed"].mean()}
    return total, metrics
