"""Mixture-of-Experts FFN: grouped top-k routing with per-group capacity
(the JAX package's ``models/moe.py``).

Tokens are routed in groups of ``GROUP_SIZE``; each group gives every
expert ``C = max(int(capacity_factor * k * n_g / E), 1)`` slots.  The
router runs in fp32 and never through PSG; the experts' three matmuls go
through ``core/psg.einsum``'s grouped patterns, one PSG matmul per expert
(its own scales and fallback flags).  Shared experts (DeepSeekMoE) are
always-on MLPs of the expert width.

The routing follows the reference's order exactly:

* top-k of the softmax probabilities with ties to the lower expert index
  (``jax.lax.top_k``; ``torch.topk`` promises no order among ties, so a
  stable descending sort takes its place), the k weights renormalized;
* a token's slot in expert e is the count of earlier (token, rank) choices
  of e in the group, over the flattened ``(n, k)`` axis, token-major; a
  choice past the capacity is dropped (combine weight 0);
* the load-balance loss ``E * sum_e frac_tokens_e * frac_probs_e`` counts
  every token's first choice, dropped ones too.

The reference dispatches and combines with one-hot einsums over ``(G, n,
E, C)``.  Every dispatch weight is 0 or 1 and a slot holds at most one
token, so its expert inputs are the routed tokens themselves and each
token's output is the sum of its kept choices' weighted expert outputs:
here an indexed write into ``(E, G, C, d)`` (zeros in empty slots) and a
gather of each choice's output, which compute the same values without the
one-hot tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import psg
from repro_torch.core.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers as L

GROUP_SIZE = 1024


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``w_up``/``w_gate`` (E, d, f), ``w_down``
    (E, f, d) in ``param_dtype``; ``shared``: the shared experts' MLPs."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, E = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        pd = L.param_dtype(cfg)
        self.router = nn.Parameter(L.dense_init((d, E), generator))
        self.w_up = nn.Parameter(L.dense_init((E, d, f), generator, dtype=pd))
        self.w_gate = nn.Parameter(L.dense_init((E, d, f), generator,
                                                dtype=pd))
        self.w_down = nn.Parameter(L.dense_init((E, f, d), generator,
                                                dtype=pd))
        self.shared = nn.ModuleList(L.MLP(cfg, generator, d_ff=f)
                                    for _ in range(cfg.num_shared_experts))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties in
    ascending index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``probs`` (G, n, E) -> ``(weights, experts, slots, keep)``, each
    (G, n, k): the renormalized top-k weights, their experts, each
    choice's slot in its expert (the reference's cumsum over the flattened
    ``(n, k)`` axis) and whether the slot is below ``cap``."""
    G, n, E = probs.shape
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(topi, E)                            # (G, n, k, E)
    flat = onehot.reshape(G, n * k, E)
    pos = (flat.cumsum(dim=1) - flat).reshape(G, n, k, E)
    pos = (pos * onehot).sum(dim=-1)
    return topv, topi, pos, pos < cap


def _dispatch(xg: torch.Tensor, router: torch.Tensor, k: int, cap: int,
              E: int):
    """Routing and dispatch of ``G`` groups of tokens ``xg`` (G, n, d):
    ``(ex_in (G, E, C, d), probs, topv, topi, slot, keep)``.  Slot ``(e,
    g, c)`` holds its token, empty slots zero; dropped choices go to a
    spare slot ``C`` that is cut off (no mask, no host sync: the step can
    be captured in a CUDA graph)."""
    G, n_g, d = xg.shape
    dev = xg.device
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    topv, topi, pos, keep = route(probs, k, cap)
    gi = torch.arange(G, device=dev)[:, None, None].expand(G, n_g, k)
    slot = torch.where(keep, pos, torch.full((), cap, device=dev))
    ex_in = xg.new_zeros(E, G, cap + 1, d).index_put(
        (topi, gi, slot), xg[:, :, None, :].expand(G, n_g, k, d))
    ex_in = ex_in[:, :, :cap].contiguous().transpose(0, 1)   # (G, E, C, d)
    return ex_in, probs, topv, topi, slot, keep


def _experts(ex_in: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor,
             w_down: torch.Tensor, act) -> torch.Tensor:
    """The experts' gated MLPs over their slots: (G, E, C, d) -> (G, E,
    C, d)."""
    h = act(psg.einsum("gecd,edf->gecf", ex_in, w_up))
    h = h * psg.einsum("gecd,edf->gecf", ex_in, w_gate)
    return psg.einsum("gecf,efd->gecd", h, w_down)


def _combine(ex_out: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor, cap: int
             ) -> torch.Tensor:
    """Each token's kept choices, weighted by weights rounded to the
    activation dtype, summed over its k in fp32 and rounded once (the
    reference's one einsum of bf16 operands: their products are exact in
    its fp32 accumulator): (G, n, d)."""
    G, n_g, k = topi.shape
    dt, dev = ex_out.dtype, ex_out.device
    gi = torch.arange(G, device=dev)[:, None, None].expand(G, n_g, k)
    picked = ex_out[gi, topi, slot.clamp(max=cap - 1)]    # (G, n, k, d)
    w = torch.where(keep, topv, torch.zeros((), device=dev)).to(dt)
    return (picked.float() * w.float()[..., None]).sum(dim=2).to(dt)


def moe_fwd(m: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), fp32 load-balance loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    N = B * S
    W = sharding.data_world()
    n_g = min(GROUP_SIZE, N * W)     # the global batch's routing group
    G = N // n_g
    if G * n_g != N:
        if W > 1:
            raise ValueError(f"a rank's {N} tokens (global batch / {W} "
                             f"ranks x seq) are not whole routing groups of "
                             f"{n_g}")
        raise ValueError(f"tokens {N} not divisible by group {n_g}")
    cap = max(int(cfg.capacity_factor * k * n_g / E), 1)

    # groups over the batch axes; on DTensors the routing and the indexed
    # dispatch and combine run on each rank's groups (sharding.run_local),
    # the experts over the model axis (expert-parallel where the experts
    # divide it, else their d_ff tensor-parallel, as the JAX package)
    xg = sharding.hint(x.reshape(G, n_g, d), "batch", None, None)
    ep = E % max(sharding.ctx_mesh_axis_size("model"), 1) == 0
    e_ax = "mlp" if ep else None
    rows = ("batch", None, None)
    ex_in, probs, topv, topi, slot, keep = sharding.run_local(
        lambda xg, r: _dispatch(xg, r, k, cap, E), (xg, m.router),
        (rows, (None, None)), ("batch",), n_out=6)
    ex_in = sharding.hint(ex_in, "batch", e_ax, None, None)

    act = F.silu if cfg.act == "silu" else L._ACTS["gelu"]
    f_ax = None if ep else "mlp"
    ex_out = sharding.run_local(
        lambda e, u, g, w: _experts(e, u, g, w, act),
        (ex_in, m.w_up.to(dt), m.w_gate.to(dt), m.w_down.to(dt)),
        (("batch", e_ax, None, None), (e_ax, None, f_ax),
         (e_ax, None, f_ax), (e_ax, f_ax, None)),
        ("batch", e_ax, None, None),
        partial=None if ep else ("mlp", m.w_up.shape[-1]))
    ex_out = sharding.hint(ex_out, "batch", e_ax, None, None)
    y = sharding.run_local(
        lambda eo, tv, ti, sl, kp: _combine(eo, tv, ti, sl, kp, cap),
        (ex_out, topv, topi, slot, keep),
        (("batch", None, None, None), rows, rows, rows, rows),
        rows).reshape(N, d)

    if m.shared:
        xt = x.reshape(N, d)
        for sp in m.shared:
            y = y + L.mlp_fwd(sp, xt, cfg)

    # global means under a mesh
    frac_tokens = sharding.global_mean(F.one_hot(topi[..., 0], E).float(),
                                       (0, 1))
    aux = E * torch.sum(frac_tokens * sharding.global_mean(probs, (0, 1)))
    return y.reshape(B, S, d), aux.float()
