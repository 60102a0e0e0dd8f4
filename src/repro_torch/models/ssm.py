"""State-space and recurrent mixers: Mamba2 (chunked SSD), mLSTM
(chunkwise) and sLSTM (a cell over the tokens) — the JAX package's
``models/ssm.py``.

Each mixer is an ``nn.Module`` holding its parameters under the JAX
package's names and layouts (so a JAX tree loads through
``repro_torch.convert``), plus plain functions:

* ``<kind>_fwd(p, u, cfg, return_state=False)``: the full sequence ``u``
  (B, S, d) in the activation dtype; with ``return_state`` also the
  end-of-sequence recurrent state, the prefill-to-decode handoff;
* ``init_<kind>_state(cfg, batch, dtype, device)`` and
  ``<kind>_step(p, u, state, cfg)``: the single-token recurrent update.

The projections are plain ``torch.matmul``/``einsum``, as the reference's
``@``/``jnp.einsum`` are: no PSG, no kernel.  Mamba2 and mLSTM run a Python
loop over chunks of 256 tokens (the reference's ``lax.scan``) that carries
the state and reads nothing back to the host, so a CUDA graph can capture
it; each chunk is checkpointed (``torch.utils.checkpoint``, non-reentrant)
whenever grad is enabled, whatever ``remat`` says, as the reference's
``jax.checkpoint`` on its chunk body keeps the O(L^2 nh) chunk tensors out
of the saved residuals.  The sLSTM cell is looped over the tokens.  The
inputs are split once into chunks (tokens), so that the backward gathers
their gradients in one op, not in one full-size accumulation a chunk.

``jax.nn.softplus`` (``logaddexp(x, 0)``) becomes ``F.softplus``, whose
threshold returns ``x`` above 20, where the two differ by less than 3e-9
relative; ``jax.nn.log_sigmoid`` becomes ``F.logsigmoid``.  Where the
reference takes ``jnp.maximum`` of two arrays, so does this module
(``torch.maximum``): both split the gradient of a tie in halves, which a
clamp would not (the sLSTM normalizer is exactly 1 after the first token).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import LocalWeights, dense_init, param_dtype

State = Dict[str, torch.Tensor]

MAMBA_HEAD_DIM = 64
SSD_CHUNK = 256
MLSTM_CHUNK = 256
M0 = -1e30              # the stabilizers' start: finite, as in the reference


def _chunk_len(S: int, chunk: int) -> int:
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} must be divisible by chunk {L}")
    return L


def _run_chunk(fn, *args):
    """``fn(*args)``, checkpointed while grad is enabled."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Mamba2 (chunked SSD)
# ---------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = max(di // MAMBA_HEAD_DIM, 1)
    return di, nh, di // nh


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, st = cfg.d_model, cfg.ssm_state
        di, nh, _ = _mamba_dims(cfg)
        dev, pd = generator.device, param_dtype(cfg)
        self.w_in = nn.Parameter(dense_init((d, 2 * di), generator, dtype=pd))
        self.conv = nn.Parameter(dense_init((cfg.ssm_conv_width, di),
                                            generator, scale=1.0, dtype=pd))
        self.w_bc = nn.Parameter(dense_init((d, 2 * st), generator, dtype=pd))
        self.w_dt = nn.Parameter(dense_init((d, nh), generator, dtype=pd))
        self.dt_bias = nn.Parameter(torch.zeros(nh, device=dev, dtype=pd))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, float(nh), nh, device=dev)).to(pd))
        self.D = nn.Parameter(torch.ones(nh, device=dev, dtype=pd))
        self.w_out = nn.Parameter(dense_init((di, d), generator, dtype=pd))


def _mamba_proj(p: Mamba, u: torch.Tensor):
    """u (B, S, d) -> x, z (B, S, di), B, C (B, S, st), dt (B, S, nh) and A
    (nh,) fp32, negative."""
    dt_ = u.dtype
    x, z = (u @ p.w_in.to(dt_)).chunk(2, dim=-1)
    Bm, Cm = (u @ p.w_bc.to(dt_)).chunk(2, dim=-1)
    dt = F.softplus(u.float() @ p.w_dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    return x, z, Bm, Cm, dt, A


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buf: Optional[torch.Tensor] = None):
    """Depthwise causal conv: x (B, S, di), w (W, di), ``buf`` the last W-1
    inputs before x (zeros if None) -> (silu(conv), the last W-1 inputs)."""
    W, S = w.shape[0], x.shape[1]
    pad = x.new_zeros(x.shape[0], W - 1, x.shape[2]) if buf is None else buf
    xp = torch.cat([pad, x], dim=1)
    # the taps summed from 0 in the reference's order
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(W))
    return F.silu(out), xp[:, -(W - 1):]


def _mamba_chunk(H, xn, Bn, Cn, dtn, lan, tri):
    """One SSD chunk: H (B, nh, st, hd) fp32 in, (H out, y (B, L, nh, hd)
    in the activation dtype)."""
    adt = xn.dtype
    s = torch.cumsum(lan, dim=1)                          # (B, L, nh)
    # intra-chunk: M[i, j] = (C_i . B_j) exp(s_i - s_j) dt_j, j <= i
    cb = torch.einsum("bis,bjs->bij", Cn, Bn)
    gap = s[:, :, None, :] - s[:, None, :, :]             # (B, L, L, nh)
    gap = gap.masked_fill(~tri[None, :, :, None], -math.inf)
    M = (cb[..., None] * torch.exp(gap) * dtn[:, None, :, :]).to(adt)
    y = torch.einsum("bijh,bjhd->bihd", M, xn)
    # inter-chunk: y_i += exp(s_i) * C_i @ H
    y = y + torch.einsum("bis,bhsd->bihd", Cn.to(adt), H.to(adt)) \
        * torch.exp(s)[..., None].to(adt)
    # state: H' = exp(s_L) H + sum_j exp(s_L - s_j) dt_j B_j x_j
    w_j = (torch.exp(s[:, -1:, :] - s) * dtn).to(adt)
    Hc = torch.einsum("bjh,bjs,bjhd->bhsd", w_j, Bn.to(adt), xn)
    H = H * torch.exp(s[:, -1, :])[..., None, None] + Hc.float()
    return H, y


def mamba_fwd(p: Mamba, u: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """Chunked SSD: per-chunk quadratic products and a carry over chunks of
    ``SSD_CHUNK`` tokens.  ``return_state`` also returns ``{"H", "conv_buf"}``
    (fp32), the state :func:`mamba_step` continues from."""
    Bsz, S, _ = u.shape
    di, nh, hd = _mamba_dims(cfg)
    L = _chunk_len(S, SSD_CHUNK)
    x, z, Bm, Cm, dt, A = _mamba_proj(p, u)
    x, conv_buf = _causal_conv(x, p.conv)
    xh = x.reshape(Bsz, S, nh, hd)
    loga = dt * A                                         # (B, S, nh) <= 0
    Bf, Cf = Bm.float(), Cm.float()
    tri = torch.ones(L, L, dtype=torch.bool, device=u.device).tril()
    H = torch.zeros(Bsz, nh, cfg.ssm_state, hd, device=u.device)
    ys = []
    for chunk in zip(*(t.split(L, dim=1) for t in (xh, Bf, Cf, dt, loga))):
        H, y = _run_chunk(_mamba_chunk, sharding.hint_batch(H), *chunk, tri)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xh * p.D.to(xh.dtype)[:, None]
    y = y.reshape(Bsz, S, di) * F.silu(z)
    out = y @ p.w_out.to(u.dtype)
    if return_state:
        return out, {"H": H, "conv_buf": conv_buf.float()}
    return out


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device=None) -> State:
    di, nh, hd = _mamba_dims(cfg)
    return {"H": torch.zeros(batch, nh, cfg.ssm_state, hd, dtype=dtype,
                             device=device),
            "conv_buf": torch.zeros(batch, cfg.ssm_conv_width - 1, di,
                                    dtype=dtype, device=device)}


def mamba_step(p: Mamba, u: torch.Tensor, state: State, cfg: ModelConfig):
    """u (B, 1, d): one token's recurrent update -> (y (B, 1, d), state)."""
    Bsz = u.shape[0]
    di, nh, hd = _mamba_dims(cfg)
    x, z, Bm, Cm, dt, A = _mamba_proj(p, u)
    x, buf = _causal_conv(x, p.conv, state["conv_buf"].to(x.dtype))
    xh = x.reshape(Bsz, nh, hd)
    a = torch.exp(dt[:, 0] * A)                           # (B, nh)
    H = state["H"]
    hdt = H.dtype
    upd = torch.einsum("bh,bs,bhd->bhsd", dt[:, 0].to(hdt), Bm[:, 0].to(hdt),
                       xh.to(hdt))
    H = H * a[..., None, None].to(hdt) + upd
    y = torch.einsum("bs,bhsd->bhd", Cm[:, 0].to(hdt), H)
    y = y + xh.to(hdt) * p.D.to(hdt)[:, None]
    y = y.reshape(Bsz, 1, di).to(u.dtype) * F.silu(z)
    return y @ p.w_out.to(u.dtype), \
        {"H": H, "conv_buf": buf.to(state["conv_buf"].dtype)}


# ---------------------------------------------------------------------------
# mLSTM (chunkwise)
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    return di, nh, di // nh


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di, nh, hd = _mlstm_dims(cfg)
        dev, pd = generator.device, param_dtype(cfg)
        self.w_in = nn.Parameter(dense_init((d, 2 * di), generator, dtype=pd))
        self.wq = nn.Parameter(dense_init((di, nh, hd), generator, dtype=pd))
        self.wk = nn.Parameter(dense_init((di, nh, hd), generator, dtype=pd))
        self.wv = nn.Parameter(dense_init((di, nh, hd), generator, dtype=pd))
        self.w_if = nn.Parameter(dense_init((di, 2 * nh), generator,
                                            dtype=pd))
        self.b_if = nn.Parameter(torch.cat([
            torch.zeros(nh, device=dev), torch.full((nh,), 3.0, device=dev)
        ]).to(pd))
        self.w_out = nn.Parameter(dense_init((di, d), generator, dtype=pd))


def _mlstm_qkv(p: MLSTM, u: torch.Tensor, hd: int):
    dt_ = u.dtype
    xi, z = (u @ p.w_in.to(dt_)).chunk(2, dim=-1)
    q = torch.einsum("...d,dnh->...nh", xi, p.wq.to(dt_)) / math.sqrt(hd)
    k = torch.einsum("...d,dnh->...nh", xi, p.wk.to(dt_))
    v = torch.einsum("...d,dnh->...nh", xi, p.wv.to(dt_))
    g = xi.float() @ p.w_if.float() + p.b_if.float()
    i_t, f_t = g.chunk(2, dim=-1)
    return z, q, k, v, i_t, F.logsigmoid(f_t)


def _mlstm_chunk(C_in, n_in, m_in, qi, ki, vi, ii, fi, tri):
    """One chunk: the stabilized memory (C (B, nh, hd, hd), n (B, nh, hd),
    m (B, nh)) in fp32 in; (C, n, m) out and y (B, L, nh, hd) in the
    activation dtype."""
    F_ = torch.cumsum(fi, dim=1)                          # (B, L, nh)
    # log-weights: inter = F_i + m_in; intra[i, j] = F_i - F_j + i_j
    inter_lw = F_ + m_in[:, None, :]
    intra_lw = F_[:, :, None, :] - F_[:, None, :, :] + ii[:, None, :, :]
    intra_lw = intra_lw.masked_fill(~tri[None, :, :, None], -math.inf)
    m_i = torch.maximum(inter_lw, intra_lw.amax(dim=2))   # (B, L, nh)
    Dm = torch.exp(intra_lw - m_i[:, :, None, :])         # (B, L, L, nh)
    wq_inter = torch.exp(inter_lw - m_i)
    qf, kf, vf = qi.float(), ki.float(), vi.float()
    Wm = torch.einsum("blnh,bjnh->bljn", qf, kf) * Dm
    y_num = torch.einsum("bljn,bjnh->blnh", Wm, vf) \
        + torch.einsum("blng,bngh->blnh", qf, C_in) * wq_inter[..., None]
    n_vec = torch.einsum("bljn,bjng->blng", Dm, kf) \
        + n_in[:, None, :, :] * wq_inter[..., None]
    den = torch.einsum("blng,blng->bln", qf, n_vec).abs()
    den = torch.maximum(den, torch.exp(-m_i))
    y = (y_num / den[..., None]).to(qi.dtype)
    # the state at the chunk's end
    F_L = F_[:, -1, :]                                    # (B, nh)
    st_lw = F_L[:, None, :] - F_ + ii                     # (B, L, nh)
    m_out = torch.maximum(m_in + F_L, st_lw.amax(dim=1))
    w_st = torch.exp(st_lw - m_out[:, None, :])
    decay = torch.exp(m_in + F_L - m_out)                 # (B, nh)
    C_out = C_in * decay[..., None, None] + torch.einsum(
        "blng,blnh,bln->bngh", kf, vf, w_st)
    n_out = n_in * decay[..., None] + torch.einsum("blng,bln->bng", kf, w_st)
    return C_out, n_out, m_out, y


def mlstm_fwd(p: MLSTM, u: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """Chunkwise-parallel mLSTM: per-chunk quadratic products and a carry of
    the stabilized matrix memory over chunks of ``MLSTM_CHUNK`` tokens;
    ``return_state`` also returns ``{"C", "n", "m"}`` (C as (k-dim, v-dim),
    :func:`mlstm_step`'s layout)."""
    Bsz, S, _ = u.shape
    di, nh, hd = _mlstm_dims(cfg)
    L = _chunk_len(S, MLSTM_CHUNK)
    z, q, k, v, i_t, logf = _mlstm_qkv(p, u, hd)
    tri = torch.ones(L, L, dtype=torch.bool, device=u.device).tril()
    C = torch.zeros(Bsz, nh, hd, hd, device=u.device)
    n = torch.zeros(Bsz, nh, hd, device=u.device)
    m = torch.full((Bsz, nh), M0, device=u.device)
    ys = []
    for qi, ki, vi, ii, fi in zip(*(t.split(L, dim=1)
                                    for t in (q, k, v, i_t, logf))):
        qi, ki, vi = (sharding.hint_batch(t) for t in (qi, ki, vi))
        C, n, m, y = _run_chunk(_mlstm_chunk, sharding.hint_batch(C), n, m,
                                qi, ki, vi, ii, fi, tri)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(Bsz, S, di) * F.silu(z)
    out = y @ p.w_out.to(u.dtype)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device=None) -> State:
    _, nh, hd = _mlstm_dims(cfg)
    return {"C": torch.zeros(batch, nh, hd, hd, dtype=dtype, device=device),
            "n": torch.zeros(batch, nh, hd, dtype=dtype, device=device),
            "m": torch.full((batch, nh), M0, dtype=dtype, device=device)}


def mlstm_step(p: MLSTM, u: torch.Tensor, state: State, cfg: ModelConfig):
    Bsz = u.shape[0]
    di, nh, hd = _mlstm_dims(cfg)
    z, q, k, v, i_t, logf = _mlstm_qkv(p, u[:, 0], hd)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, i_t)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i_t - m_new)
    # C is (B, nh, hd_k, hd_v): C += i' * k (outer) v
    C = C * fp[..., None, None] + ip[..., None, None] * torch.einsum(
        "bng,bnh->bngh", k.to(C.dtype), v.to(C.dtype))
    n = n * fp[..., None] + ip[..., None] * k.to(n.dtype)
    num = torch.einsum("bngh,bng->bnh", C, q.to(C.dtype))
    den = torch.maximum(
        torch.einsum("bng,bng->bn", n, q.to(n.dtype)).abs(),
        torch.exp(-m_new))[..., None]
    y = (num / den).reshape(Bsz, 1, di).to(u.dtype) * F.silu(z[:, None])
    return y @ p.w_out.to(u.dtype), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, a cell over the tokens)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        hd = d // nh
        dev, pd = generator.device, param_dtype(cfg)
        self.w_g = nn.Parameter(dense_init((d, 4 * d), generator, dtype=pd))
        self.r_g = nn.Parameter(dense_init((nh, hd, 4 * hd), generator,
                                           dtype=pd))
        self.b_g = nn.Parameter(torch.zeros(4 * d, device=dev, dtype=pd))
        self.w_out = nn.Parameter(dense_init((d, d), generator, dtype=pd))


def _slstm_cell(r_g, x_g, carry, one):
    """x_g (B, 4d) input pre-activation, ``r_g`` the block-diagonal
    recurrent weights in the activation dtype, carry (c, n, h, m) each (B,
    nh, hd), ``one`` a 0-d fp32 1."""
    c, n, h, m = carry
    nh, hd = r_g.shape[:2]
    rec = torch.einsum("bnh,nhg->bng", h, r_g)            # (B, nh, 4 hd)
    g = x_g.reshape(x_g.shape[0], nh, 4 * hd) + rec
    z, i_t, f_t, o = g.float().chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(logf + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h = o * c / torch.maximum(n, one)
    return c, n, h.to(x_g.dtype), m_new


def slstm_fwd(p: SLSTM, u: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """The sLSTM cell over every token; ``return_state`` also returns
    ``{"c", "n", "h", "m"}`` (h in the activation dtype, the rest fp32)."""
    Bsz, S, d = u.shape
    nh = cfg.num_heads
    dt_ = u.dtype
    x_g = u @ p.w_g.to(dt_) + p.b_g.to(dt_)               # (B, S, 4d)
    r_g = p.r_g.to(dt_)
    one = torch.ones((), device=u.device)
    zeros = torch.zeros(Bsz, nh, d // nh, device=u.device)
    carry = (zeros, zeros, zeros.to(dt_), torch.full_like(zeros, M0))
    hs = []
    for x_t in x_g.unbind(dim=1):
        carry = _slstm_cell(r_g, x_t, tuple(sharding.hint_batch(c)
                                            for c in carry), one)
        hs.append(carry[2])
    out = torch.stack(hs, dim=1).reshape(Bsz, S, d) @ p.w_out.to(dt_)
    if return_state:
        c, n, h, m = carry
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def init_slstm_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device=None) -> State:
    nh = cfg.num_heads
    shape = (batch, nh, cfg.d_model // nh)
    z = dict(dtype=dtype, device=device)
    return {"c": torch.zeros(shape, **z), "n": torch.zeros(shape, **z),
            "h": torch.zeros(shape, **z), "m": torch.full(shape, M0, **z)}


def slstm_step(p: SLSTM, u: torch.Tensor, state: State, cfg: ModelConfig):
    dt_ = u.dtype
    x_g = u[:, 0] @ p.w_g.to(dt_) + p.b_g.to(dt_)
    carry = (state["c"], state["n"], state["h"].to(dt_), state["m"])
    c, n, h, m = _slstm_cell(p.r_g.to(dt_), x_g, carry,
                             torch.ones((), device=u.device))
    y = h.reshape(u.shape[0], 1, cfg.d_model) @ p.w_out.to(dt_)
    return y, {"c": c, "n": n, "h": h, "m": m}


MIXERS = {"mamba": (Mamba, mamba_fwd), "mlstm": (MLSTM, mlstm_fwd),
          "slstm": (SLSTM, slstm_fwd)}


def mixer_fwd(kind: str, p: nn.Module, u: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The ``kind`` mixer's forward; on ``DTensor``s each rank runs the
    plain forward on its batch rows with the mixer's weights gathered
    whole (``sharding.run_local``: the mixers are data-parallel over the
    model axis, whose sequential chunk and token loops ``DTensor`` would
    dispatch op by op)."""
    fwd = MIXERS[kind][1]
    if not sharding.spmd(u):
        return fwd(p, u, cfg)
    names, ws = zip(*p.named_parameters())
    rows = ("batch", None, None)

    def local(u, *w):
        return fwd(LocalWeights(**dict(zip(names, w))), u, cfg)
    return sharding.run_local(local, (u,) + ws,
                              (rows,) + tuple((None,) * w.ndim for w in ws),
                              rows)
