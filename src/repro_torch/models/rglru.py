"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of ``repro/models/rglru.py``.  Block = linear-in x2 (x branch, GeLU
gate branch), temporal conv (width 4) on the x branch, the RG-LRU diagonal
linear recurrence, multiplicative gate, linear-out.  Gates use
block-diagonal projections (8 blocks) as in Griffin.

Where the reference runs ``jax.lax.associative_scan`` over time, the full
sequence here is a log-depth scan in float32 (:func:`_scan`): ceil(log2 T)
passes of ``h[t] = a[t] h[t-s] + h[t]``, ``a[t] = a[t] a[t-s]`` for s = 1,
2, 4, ...  Neither a T-step loop (T launches a layer) nor a closed form by
``cumprod`` and division (a product of hundreds of ``a < 1`` underflows to
0).  Decode is the plain one-step recurrence.  A layer's cache is
``{"h": [B, w], "conv": [B, 3, w]}``, float32 as the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import BATCH_AXES, MODEL_AXIS, P, Params, dense_init, gelu_tanh
from .config import ModelConfig

__all__ = ["init_rglru", "rglru_specs", "rglru_forward", "rglru_decode",
           "init_rglru_cache", "rglru_cache_specs"]

_NBLOCKS = 8
_CONV_W = 4
_C = 8.0  # Griffin's fixed gate sharpness


def _w(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, w = cfg.d_model, _w(cfg)
    wb = w // _NBLOCKS
    dev = gen.device
    return Params(
        in_x=dense_init(gen, (d, w)),
        in_gate=dense_init(gen, (d, w)),
        conv_w=dense_init(gen, (_CONV_W, w)).mul_(0.1),
        conv_b=torch.zeros(w, device=dev),
        gate_a=dense_init(gen, (_NBLOCKS, wb, wb), in_axis=1),
        gate_x=dense_init(gen, (_NBLOCKS, wb, wb), in_axis=1),
        gate_a_b=torch.zeros(w, device=dev),
        gate_x_b=torch.zeros(w, device=dev),
        # a = exp(-c * softplus(lam) * r); init so a^c ~ 0.9..0.999
        lam=torch.linspace(0.3, 1.5, w, device=dev),
        out=dense_init(gen, (w, d)))


def rglru_specs(cfg: ModelConfig) -> Dict:
    return {
        "in_x": P("data", MODEL_AXIS),
        "in_gate": P("data", MODEL_AXIS),
        "conv_w": P(None, MODEL_AXIS),
        "conv_b": P(MODEL_AXIS),
        "gate_a": P(None, None, MODEL_AXIS),
        "gate_x": P(None, None, MODEL_AXIS),
        "gate_a_b": P(MODEL_AXIS),
        "gate_x_b": P(MODEL_AXIS),
        "lam": P(MODEL_AXIS),
        "out": P(MODEL_AXIS, "data"),
    }


def _block_proj(x: torch.Tensor, wmat: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x: [..., w] -> block-diagonal projection, blocks on the last dim."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], _NBLOCKS, shape[-1] // _NBLOCKS)
    out = torch.einsum("...nb,nbc->...nc", xb, wmat.to(x.dtype))
    return out.reshape(shape) + bias.to(x.dtype)


def _gates(p: Params, xc: torch.Tensor):
    """(a, b) in float32: the recurrence's decay and its gated input."""
    r = torch.sigmoid(_block_proj(xc, p.gate_a, p.gate_a_b).float())
    i = torch.sigmoid(_block_proj(xc, p.gate_x, p.gate_x_b).float())
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * xc.float()


def _conv(xb: torch.Tensor, p: Params,
          state: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width 4 over time: (out, new_state), the
    state being the last 3 inputs (zeros before the first)."""
    w = p.conv_w.to(xb.dtype)
    if state is None:
        pad = xb.new_zeros((xb.shape[0], _CONV_W - 1, xb.shape[2]))
    else:
        pad = state.to(xb.dtype)
    xp = torch.cat([pad, xb], dim=1)
    t = xb.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(_CONV_W))
    new_state = xp[:, xp.shape[1] - (_CONV_W - 1):]
    return out + p.conv_b.to(xb.dtype), new_state


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h[t] = a[t] h[t-1] + b[t] (h[-1] = 0) along dim 1, by ceil(log2 T)
    doubling passes; each pass combines every element with the one ``s``
    back, whose pair covers the ``s`` steps before its own."""
    h = b
    t = a.shape[1]
    s = 1
    while s < t:
        h = h + a * F.pad(h, (0, 0, s, 0))[:, :t]
        if 2 * s < t:               # the last pass's products go unread
            a = a * F.pad(a, (0, 0, s, 0), value=1.0)[:, :t]
        s *= 2
    return h


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B, T, d] full-sequence forward by the log-depth scan."""
    xb = x @ p.in_x.to(x.dtype)
    gate = gelu_tanh(x @ p.in_gate.to(x.dtype))
    xc, conv_state = _conv(xb, p)
    a, b = _gates(p, xc)                     # [B,T,W] f32 each
    h = _scan(a, b).to(x.dtype)
    y = h * gate
    out = y @ p.out.to(x.dtype)
    if cache is None:
        return out, None
    return out, {"h": h[:, -1].to(cache["h"].dtype),
                 "conv": conv_state.to(cache["conv"].dtype)}


def init_rglru_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None) -> Dict:
    w = _w(cfg)
    return {"h": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                                device=device)}


def rglru_cache_specs(cfg: ModelConfig) -> Dict:
    return {"h": P(BATCH_AXES, MODEL_AXIS),
            "conv": P(BATCH_AXES, None, MODEL_AXIS)}


def rglru_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: [B, 1, d] single-step recurrence."""
    xb = x @ p.in_x.to(x.dtype)
    gate = gelu_tanh(x @ p.in_gate.to(x.dtype))
    xc, conv_state = _conv(xb, p, state=cache["conv"])
    a, b = _gates(p, xc)                     # [B,1,W]
    h = a[:, 0] * cache["h"].float() + b[:, 0]
    y = h.to(x.dtype)[:, None] * gate
    out = y @ p.out.to(x.dtype)
    return out, {"h": h.to(cache["h"].dtype),
                 "conv": conv_state.to(cache["conv"].dtype)}
