"""Mamba-2 SSD (state-space duality) mixer.

Port of ``repro/models/ssm.py``.  Chunked SSD (Dao & Gu 2024): within a
chunk of length L the recurrence is a masked quadratic form
(attention-like); across chunks a small state S [H, N, P] is carried by a
loop over the chunks.  Decode is the plain single-step recurrence.
n_groups = 1.  A layer's cache is ``{"ssm": [B, H, N, P], "conv": [B,
d_conv - 1, di + 2N]}``, float32 as the reference's.

One departure from the reference, in the gradient only: the reference
builds the intra-chunk decay ``exp(cs_i - cs_j)`` for every (i, j) and
masks the upper triangle after the ``exp``.  Above the diagonal ``cs_i -
cs_j`` is a sum of positive terms ``A dt``; once ``A dt (L - 1)`` passes
88.7 it overflows float32, and although the forward stays finite (the mask
picks 0) the backward multiplies 0 by inf, so the gradients w.r.t. ``dt``
and ``a_log`` turn non-finite.  Here the segment sum is masked with -inf
before the ``exp``, as Mamba-2's own reference does: the forward values
are the reference's and the gradients stay finite.

On a rank of the tensor-parallel program (``models/tensor_parallel.py``)
the mixer is partitioned as GSPMD partitions the reference's (read off
its HLO for mamba2-130m on a model axis of 16, where neither the 3352
columns of ``in_proj`` nor the 24 heads divide the axis): each product
dimension is cut into ``ceil(n / m)`` a rank (``TensorParallel.chunk``)
and a rank computes its part (:class:`_Weights`):

* ``in_proj``: its columns of ``[z | x | B | C | dt]``, the products
  all-gathered (the whole concatenation on every rank);
* the conv: its channels of ``[x | B | C]`` (the ``conv`` cache's shard
  under ``mamba_cache_specs``), the outputs all-gathered;
* the SSD: its heads (the ``ssm`` cache's shard, at the reference's
  constrain of the heads) with all of B and C, ``C . B`` over its part
  of the state dimension summed over ``model``;
* the gated norm over every channel (the heads' outputs all-gathered),
  then ``out_proj`` by its rows: partial sums, summed over ``model``
  (``"ssm.out"``).

A cache that lies whole (heads or channels that do not divide the axis)
takes every rank's part, all-gathered.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import tensor_parallel
from .common import BATCH_AXES, MODEL_AXIS, P, Params, dense_init, rms_norm
from .config import ModelConfig, SSMConfig

__all__ = ["init_mamba", "mamba_specs", "mamba_forward", "mamba_decode",
           "init_mamba_cache", "mamba_cache_specs"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return s, di, nh


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with its operands promoted to their common type,
    as ``jnp.einsum`` promotes (bf16 with float32 gives float32): a decode
    step meets the float32 state with activations of the compute type."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> Params:
    s, di, nh = _dims(cfg)
    d = cfg.d_model
    conv_ch = di + 2 * s.d_state
    dev = gen.device
    return Params(
        in_proj=dense_init(gen, (d, 2 * di + 2 * s.d_state + nh)),
        conv_w=dense_init(gen, (s.d_conv, conv_ch)).mul_(0.1),
        conv_b=torch.zeros(conv_ch, device=dev),
        a_log=torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        d_skip=torch.ones(nh, device=dev),
        dt_bias=torch.full((nh,), math.log(math.expm1(1e-2)),
                           device=dev),                     # softplus^-1
        norm=torch.zeros(di, device=dev),
        out_proj=dense_init(gen, (di, d)))


def mamba_specs(cfg: ModelConfig) -> Dict:
    return {
        "in_proj": P("data", MODEL_AXIS),
        "conv_w": P(None, MODEL_AXIS),
        "conv_b": P(MODEL_AXIS),
        "a_log": P(None),
        "d_skip": P(None),
        "dt_bias": P(None),
        "norm": P(MODEL_AXIS),
        "out_proj": P(MODEL_AXIS, "data"),
    }


class _Weights:
    """A Mamba-2 mixer's weights as this rank reads them, its parts
    ``[lo, hi)`` of the products' dimensions (``cols`` of ``in_proj``,
    ``conv`` channels, ``heads``, ``state`` dimensions of ``C . B``,
    ``rows`` of ``out_proj``: all of each outside the tensor-parallel
    program), and the collectives that join them."""

    def __init__(self, p: Params, cfg: ModelConfig):
        s, di, nh = _dims(cfg)
        tp = self.tp = tensor_parallel.current()
        self.p = p
        self.n = {"cols": 2 * di + 2 * s.d_state + nh,
                  "conv": di + 2 * s.d_state, "heads": nh,
                  "state": s.d_state, "rows": di}
        if tp is None or tp.m == 1:
            self.tp = None
            for k, n in self.n.items():
                setattr(self, k, (0, n))
            for k in ("in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                      "dt_bias", "norm", "out_proj"):
                setattr(self, k, getattr(p, k))
            return
        for k, n in self.n.items():
            setattr(self, k, tp.chunk(n))
        self.in_proj = tp.part(p.in_proj, 1, self.n["cols"])
        self.conv_w = tp.part(p.conv_w, 1, self.n["conv"])
        self.conv_b = tp.part(p.conv_b, 0, self.n["conv"])
        self.a_log, self.d_skip, self.dt_bias = (
            tp.part(t, 0, nh) for t in (p.a_log, p.d_skip, p.dt_bias))
        self.norm = tp.part(p.norm, 0, di)
        self.out_proj = tp.part(p.out_proj, 0, di)

    def site(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Copy-to-model at ``"ssm.in"``, reduce-from-model at
        ``"ssm.out"``."""
        if self.tp is None:
            return x
        c = self.tp.comm
        return c.copy_to(x, MODEL_AXIS) if name == "ssm.in" \
            else c.reduce_from(x, MODEL_AXIS)

    def whole(self, y: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
        """Every rank's part of dimension ``kind`` (``y`` this rank's)
        along ``dim``, all-gathered."""
        return y if self.tp is None else self.tp.gather_chunks(
            y, self.n[kind], dim)

    def mine(self, t: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of a cache tensor that lies
        split by ``kind`` (its shard) or whole."""
        if self.tp is None or t.shape[dim] != self.n[kind]:
            return t
        lo, hi = getattr(self, kind)
        return t.narrow(dim, lo, hi - lo)

    def cached(self, t: torch.Tensor, kind: str, dim: int,
               like: torch.Tensor) -> torch.Tensor:
        """A new cache tensor, this rank's part ``t``, laid out as
        ``like`` lies: its shard, or whole (every rank's part
        all-gathered, no gradient)."""
        if self.tp is None or like.shape[dim] != self.n[kind]:
            return t.to(like.dtype)
        return self.tp.gather_chunks(t, self.n[kind], dim,
                                     grad="slice").to(like.dtype)

    def scores(self, c_c: torch.Tensor, b_c: torch.Tensor) -> torch.Tensor:
        """``C . B`` ``[B, nc, L, L]`` (float32) over every state
        dimension: this rank's part of them, summed over ``model``."""
        n0, n1 = self.state
        cb = torch.einsum("bcin,bcjn->bcij", c_c[..., n0:n1].float(),
                          b_c[..., n0:n1].float())
        return cb if self.tp is None else self.tp.psum(cb)


def _split_proj(w, x: torch.Tensor, cfg: ModelConfig):
    """(z, x B C, dt) of every channel, from the mixer's weights ``w`` (or
    a rank's :class:`_Weights`: its columns of ``in_proj``,
    all-gathered)."""
    s, di, _ = _dims(cfg)
    if not isinstance(w, _Weights):
        w = _Weights(w, cfg)
    zxbcdt = w.whole(tensor_parallel.dot(x, w.in_proj), "cols", -1)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * s.d_state,
                                      zxbcdt.shape[-1] - 2 * di
                                      - 2 * s.d_state], dim=-1)
    return z, xbc, dt


def _own_conv(w: _Weights, xbc: torch.Tensor, cfg: ModelConfig,
              state: Optional[torch.Tensor] = None):
    """The causal conv of the rank's channels of ``xbc`` (every
    channel's), the outputs all-gathered; (out, the rank's new state)."""
    k0, k1 = w.conv
    out, new_state = _causal_conv(xbc[..., k0:k1], w, cfg, state)
    return w.whole(out, "conv", -1), new_state


def _causal_conv(xbc: torch.Tensor, p, cfg: ModelConfig,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, then SiLU; returns (out,
    new_state), the state being the last ``d_conv - 1`` inputs."""
    w = p.conv_w.to(xbc.dtype)                             # [W, C]
    width = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                      # [B, T+W-1, C]
    t = xbc.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(width))
    out = F.silu(out + p.conv_b.to(xbc.dtype))
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return out, new_state


def _ssd_chunked(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 dt: torch.Tensor, a_log: torch.Tensor,
                 chunk: int, scores=None) -> torch.Tensor:
    """Chunked SSD.

    xh:   [B, T, H, P]   (dt-weighted inputs are formed here)
    bmat: [B, T, N], cmat: [B, T, N]   (n_groups = 1, shared across heads)
    dt:   [B, T, H]      (positive step sizes)
    scores: ``C . B`` of the chunks (``_Weights.scores``), by default
    every state dimension's here.
    Returns y [B, T, H, P].
    """
    bsz, t, h, pdim = xh.shape
    t_orig = t
    n = bmat.shape[-1]
    L = min(chunk, t)
    t_pad = -(-t // L) * L
    if t_pad != t:  # pad with identity steps (dt=0 => a=1, input 0)
        def z(v):
            return torch.cat([v, v.new_zeros((bsz, t_pad - t,
                                              *v.shape[2:]))], dim=1)
        xh, bmat, cmat, dt = z(xh), z(bmat), z(cmat), z(dt)
        t = t_pad
    nc = t // L
    la = -torch.exp(a_log.float())[None, None] * dt.float()  # log a [B,T,H]
    xdt = xh * dt[..., None].to(xh.dtype)                    # dt_j x_j

    def r(v):
        return v.reshape(bsz, nc, L, *v.shape[2:])

    la_c, x_c = r(la), r(xdt)
    b_c, c_c = r(bmat), r(cmat)
    cs = torch.cumsum(la_c, dim=2)                          # [B,nc,L,H] incl.

    # intra-chunk: scores[i,j] = (C_i . B_j) * exp(cs_i - cs_j) * (i >= j),
    # the segment sum masked to -inf above the diagonal before the exp
    cb = scores(c_c, b_c) if scores is not None else torch.einsum(
        "bcin,bcjn->bcij", c_c.float(), b_c.float())
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # [B,nc,i,j,H]
    tri = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    scores = cb[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(xh.dtype), x_c)

    # chunk state contribution: S_c = sum_j exp(cs_L - cs_j) B_j (dt_j x_j)
    tail = torch.exp(cs[:, :, -1:, :] - cs)                 # [B,nc,L,H]
    s_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp", b_c, tail.to(xh.dtype),
                       x_c)
    total = torch.exp(cs[:, :, -1]).to(xh.dtype)            # [B,nc,H]

    # inter-chunk: the state before each chunk, carried over the chunks
    s_prev = xh.new_zeros((bsz, h, n, pdim))
    prevs = []
    for c in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * total[:, c, :, None, None] + s_c[:, c]
    s_prevs = torch.stack(prevs, dim=1)                     # [B,nc,H,N,P]

    # y_i += exp(cs_i) * C_i . S_prev
    inter = torch.einsum("bcin,bcih,bchnp->bcihp", c_c,
                         torch.exp(cs).to(xh.dtype), s_prevs)
    y = (y_intra + inter).reshape(bsz, t, h, pdim)
    return y[:, :t_orig]


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence SSD forward.  x: [B, T, d]."""
    s, di, nh = _dims(cfg)
    w = _Weights(p, cfg)
    x = w.site("ssm.in", x)
    z, xbc, dt = _split_proj(w, x, cfg)
    xbc, conv_state = _own_conv(w, xbc, cfg)
    xin, bmat, cmat = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    h0, h1 = w.heads
    xh = xin[..., h0 * s.head_dim:h1 * s.head_dim].reshape(
        *xin.shape[:2], h1 - h0, s.head_dim)
    dt_pos = F.softplus(dt[..., h0:h1].float() + w.dt_bias.float())
    y = _ssd_chunked(xh, bmat, cmat, dt_pos, w.a_log, s.chunk,
                     scores=w.scores)
    y = y + w.d_skip.to(y.dtype)[None, None, :, None] * xh
    y = w.whole(y, "heads", 2).reshape(*x.shape[:2], di)
    y = rms_norm(y * F.silu(z), w.norm, cfg.norm_eps, cols=w.rows)
    out = w.site("ssm.out", tensor_parallel.dot(y, w.out_proj.to(x.dtype),
                                                cfg.d_model))
    if cache is None:
        return out, None
    # prefill: recompute the final SSM state for decode
    final = _final_state(xh, bmat, cmat, dt_pos, w.a_log)
    return out, {"ssm": w.cached(final, "heads", 1, cache["ssm"]),
                 "conv": w.cached(conv_state, "conv", -1, cache["conv"])}


def _final_state(xh, bmat, cmat, dt, a_log) -> torch.Tensor:
    """Exact state after the full sequence (for prefill -> decode handoff)."""
    la = -torch.exp(a_log.float())[None, None] * dt         # [B,T,H]
    cs = torch.cumsum(la, dim=1)
    tail = torch.exp(cs[:, -1:, :] - cs)                    # [B,T,H]
    xdt = xh * dt[..., None].to(xh.dtype)
    return torch.einsum("btn,bth,bthp->bhnp", bmat, tail.to(xh.dtype), xdt)


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None) -> Dict:
    s, di, nh = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                            dtype=dtype, device=device),
    }


def mamba_cache_specs(cfg: ModelConfig) -> Dict:
    return {"ssm": P(BATCH_AXES, MODEL_AXIS, None, None),
            "conv": P(BATCH_AXES, None, MODEL_AXIS)}


def mamba_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-step recurrence.  x: [B, 1, d]."""
    s, di, nh = _dims(cfg)
    w = _Weights(p, cfg)
    x = w.site("ssm.in", x)
    z, xbc, dt = _split_proj(w, x, cfg)
    xbc, conv_state = _own_conv(w, xbc, cfg,
                                state=w.mine(cache["conv"], "conv", -1))
    xin, bmat, cmat = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    h0, h1 = w.heads
    xh = xin[:, 0, h0 * s.head_dim:h1 * s.head_dim].reshape(
        x.shape[0], h1 - h0, s.head_dim)                     # [B,H,P]
    dt_pos = F.softplus(dt[..., h0:h1].float()
                        + w.dt_bias.float())[:, 0]           # [B,H]
    a = torch.exp(-torch.exp(w.a_log.float())[None] * dt_pos)
    xdt = xh * dt_pos[..., None].to(xh.dtype)
    st = w.mine(cache["ssm"], "heads", 1)
    h_new = st * a[..., None, None].to(st.dtype) \
        + _ein("bn,bhp->bhnp", bmat[:, 0], xdt)
    y = _ein("bn,bhnp->bhp", cmat[:, 0], h_new)
    y = y + w.d_skip.to(y.dtype)[None, :, None] * xh
    y = w.whole(y, "heads", 1).reshape(x.shape[0], 1, di)
    y = rms_norm(y * F.silu(z), w.norm, cfg.norm_eps, cols=w.rows)
    out = w.site("ssm.out", tensor_parallel.dot(    # y: the state's type
        y, w.out_proj.to(x.dtype), cfg.d_model))
    out = out.to(x.dtype)   # f32 state must not promote the residual
    return out, {"ssm": w.cached(h_new, "heads", 1, cache["ssm"]),
                 "conv": w.cached(conv_state, "conv", -1, cache["conv"])}
