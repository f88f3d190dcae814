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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    s, di, _ = _dims(cfg)
    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * s.d_state,
                                      zxbcdt.shape[-1] - 2 * di
                                      - 2 * s.d_state], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, p: Params, cfg: ModelConfig,
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
                 chunk: int) -> torch.Tensor:
    """Chunked SSD.

    xh:   [B, T, H, P]   (dt-weighted inputs are formed here)
    bmat: [B, T, N], cmat: [B, T, N]   (n_groups = 1, shared across heads)
    dt:   [B, T, H]      (positive step sizes)
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
    cb = torch.einsum("bcin,bcjn->bcij", c_c.float(), b_c.float())
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
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, p, cfg)
    xin, bmat, cmat = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    xh = xin.reshape(*xin.shape[:2], nh, s.head_dim)
    dt_pos = F.softplus(dt.float() + p.dt_bias.float())
    y = _ssd_chunked(xh, bmat, cmat, dt_pos, p.a_log, s.chunk)
    y = y + p.d_skip.to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(*x.shape[:2], di)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.out_proj.to(x.dtype)
    if cache is None:
        return out, None
    # prefill: recompute the final SSM state for decode
    final = _final_state(xh, bmat, cmat, dt_pos, p.a_log)
    return out, {"ssm": final.to(cache["ssm"].dtype),
                 "conv": conv_state.to(cache["conv"].dtype)}


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
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, p, cfg, state=cache["conv"])
    xin, bmat, cmat = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    xh = xin.reshape(x.shape[0], 1, nh, s.head_dim)[:, 0]   # [B,H,P]
    dt_pos = F.softplus(dt.float() + p.dt_bias.float())[:, 0]  # [B,H]
    a = torch.exp(-torch.exp(p.a_log.float())[None] * dt_pos)
    xdt = xh * dt_pos[..., None].to(xh.dtype)
    st = cache["ssm"]
    h_new = st * a[..., None, None].to(st.dtype) \
        + _ein("bn,bhp->bhnp", bmat[:, 0], xdt)
    y = _ein("bn,bhnp->bhp", cmat[:, 0], h_new)
    y = y + p.d_skip.to(y.dtype)[None, :, None] * xh
    y = y.reshape(x.shape[0], 1, di)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = _ein("bte,ed->btd", y, p.out_proj.to(x.dtype))
    out = out.to(x.dtype)   # f32 state must not promote the residual
    return out, {"ssm": h_new.to(st.dtype),
                 "conv": conv_state.to(cache["conv"].dtype)}
