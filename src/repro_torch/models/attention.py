"""Grouped-query attention with QKV bias, logit softcap, local windows,
encoder (bidirectional) mode, and a ring-buffer KV cache for decode.

Port of ``repro/models/attention.py``.  A layer's cache is a dict of
tensors ``{"k": [B, S, K, hd], "v": [B, S, K, hd], "pos": int32 [B, S]}``
(the reference stacks one per layer unit; the port keeps one per layer).
Local (sliding-window) layers keep a cache of only ``window`` slots.  The
cache writes happen in place and the updated dict is returned, as the
reference returns its new cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import (BATCH_AXES, MODEL_AXIS, P, Params, apply_rope,
                     dense_init, rope, softcap)
from .config import ModelConfig

__all__ = ["init_attn", "attn_specs", "attn_forward", "attn_decode",
           "init_attn_cache", "attn_cache_specs", "cache_len", "NEG_INF",
           "BLOCKED_ATTN_THRESHOLD", "KV_CHUNK"]

NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)
INT32_MAX = 2 ** 31 - 1


def init_attn(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    p = dict(wq=dense_init(gen, (d, h * hd)), wk=dense_init(gen, (d, k * hd)),
             wv=dense_init(gen, (d, k * hd)), wo=dense_init(gen, (h * hd, d)))
    if cfg.qkv_bias:
        dev = gen.device
        p.update(bq=torch.zeros(h * hd, device=dev),
                 bk=torch.zeros(k * hd, device=dev),
                 bv=torch.zeros(k * hd, device=dev))
    return Params(**p)


def attn_specs(cfg: ModelConfig) -> Dict:
    """FSDP (over 'data') x TP (over 'model') parameter shardings."""
    p = {
        "wq": P("data", MODEL_AXIS),
        "wk": P("data", MODEL_AXIS),
        "wv": P("data", MODEL_AXIS),
        "wo": P(MODEL_AXIS, "data"),
    }
    if cfg.qkv_bias:
        p["bq"] = P(MODEL_AXIS)
        p["bk"] = P(MODEL_AXIS)
        p["bv"] = P(MODEL_AXIS)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    b, t = x.shape[:2]
    return (q.reshape(b, t, cfg.n_heads, hd),
            k.reshape(b, t, cfg.n_kv_heads, hd),
            v.reshape(b, t, cfg.n_kv_heads, hd))


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: [B,T,H,hd]; k,v: [B,S,K,hd]; mask: [B?,T,S] bool (True=attend).

    The scores are float32 whatever the operands' type (the reference's
    ``preferred_element_type``); the probabilities take v's type."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    q = q.reshape(b, t, kh, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())
    logits = logits * (hd ** -0.5)
    logits = softcap(logits, cfg.attn_softcap)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, hd)


def _pair_mask(cfg: ModelConfig, kind: str, pos_q: torch.Tensor,
               pos_k: torch.Tensor) -> torch.Tensor:
    """bool[Tq, Tk] attend mask from absolute positions."""
    i = pos_q[:, None]
    j = pos_k[None, :]
    if cfg.causal:
        m = j <= i
    else:
        m = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                       device=pos_q.device)
    if kind == "l" and cfg.local_window:
        m = m & (i - j < cfg.local_window)
    return m


# Sequences longer than this use the kv-chunked online-softmax path, which
# never materializes the [T, S] score matrix.
BLOCKED_ATTN_THRESHOLD = 8192
KV_CHUNK = 1024


def _sdpa_blocked(q, k, v, cfg: ModelConfig, kind: str, pos_q, pos_k,
                  kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention, looped over KV chunks.

    q: [B,T,H,hd]; k,v: [B,S,K,hd].  Score working set is
    [B,heads,T,chunk]."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    pad = (-s) % kv_chunk
    if pad:  # ragged tail: pad with masked-out slots, never shrink the chunk
        k = torch.cat([k, k.new_zeros((b, pad, kh, hd))], 1)
        v = torch.cat([v, v.new_zeros((b, pad, kh, hd))], 1)
        pos_k = torch.cat([pos_k, torch.full(
            (pad,), INT32_MAX, dtype=pos_k.dtype, device=pos_k.device)])
        s += pad
    qr = q.reshape(b, t, kh, g, hd).float() * (hd ** -0.5)
    m = torch.full((b, kh, g, t), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, t, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, s, kv_chunk):
        k_c = k[:, c0:c0 + kv_chunk].float()
        v_c = v[:, c0:c0 + kv_chunk].float()
        sc = torch.einsum("btkgd,bskd->bkgts", qr, k_c)
        sc = softcap(sc, cfg.attn_softcap)
        mask = _pair_mask(cfg, kind, pos_q, pos_k[c0:c0 + kv_chunk])
        sc = torch.where(mask[None, None, None], sc,
                         torch.tensor(NEG_INF, device=sc.device))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bskd->bkgtd", p,
                                                    v_c)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    # [b,kh,g,t,hd] -> [b,t,h,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor, cache: Optional[Dict] = None):
    """Full-sequence attention (train / prefill).

    If ``cache`` is given (prefill), k/v are written into it and the
    updated cache is returned alongside the output.
    """
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    sin, cos = rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if t > BLOCKED_ATTN_THRESHOLD:
        out = _sdpa_blocked(q, k, v, cfg, kind, positions, positions)
    else:
        mask = _pair_mask(cfg, kind, positions, positions)[None]
        out = _sdpa(q, k, v, mask, cfg)
    out = out.reshape(b, t, -1) @ p.wo.to(x.dtype)
    if cache is None:
        return out, None
    return out, _write_prefill(cache, k, v, positions, cfg, kind)


# ---------------------------------------------------------------------------
# KV cache (ring buffer for local layers)
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "l" and cfg.local_window:
        return min(cfg.local_window, max_len)
    return max_len


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> Dict:
    s = cache_len(cfg, kind, max_len)
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, s, kh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, s, kh, hd), dtype=dtype, device=device),
        # global position per slot, per request: rows advance independently
        # under continuous batching (see repro_torch.serving), -1 = never
        # written
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def attn_cache_specs(cfg: ModelConfig, kind: str) -> Dict:
    """KV cache sharding: heads over the model axis where the kv-head count
    covers the 16-way production axis, else the sequence (context
    parallelism), as the reference."""
    if cfg.n_kv_heads % 16 == 0:
        kv_spec = P(BATCH_AXES, None, MODEL_AXIS, None)
    else:
        kv_spec = P(BATCH_AXES, MODEL_AXIS, None, None)
    return {"k": kv_spec, "v": kv_spec, "pos": P(BATCH_AXES, None)}


def _write_prefill(cache: Dict, k, v, positions, cfg: ModelConfig,
                   kind: str) -> Dict:
    """Write a full prefill's k/v into the (possibly ring) cache.

    Only the trailing ``cache_len`` positions are written (earlier ones
    would be overwritten in the ring anyway), which keeps slot indices
    unique.
    """
    s = cache["k"].shape[1]
    t = k.shape[1]
    keep = min(t, s)
    pos_tail = positions[t - keep:]
    slots = (pos_tail % s).long()
    cache["k"][:, slots] = k[:, t - keep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, t - keep:].to(cache["v"].dtype)
    cache["pos"][:, slots] = pos_tail.to(torch.int32)[None, :]
    return cache


def attn_decode(p: Params, x: torch.Tensor, cache: Dict, pos,
                cfg: ModelConfig, kind: str) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode step.  x: [B, 1, d].

    ``pos`` is an int (all rows at the same position) or an int ``[B]``
    tensor of per-request positions, which lets continuous batching mix
    requests at different depths in one decode batch.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos_b.dim() == 0:
        pos_b = pos_b.expand(b)
    sin, cos = rope(pos_b[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    s = cache["k"].shape[1]
    slot = (pos_b % s).long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos_b
    # attend over valid slots: written, <= pos, and within window if local,
    # all per request, since each row carries its own position
    new_pos = cache["pos"]
    ok = (new_pos >= 0) & (new_pos <= pos_b[:, None])
    if kind == "l" and cfg.local_window:
        ok = ok & (pos_b[:, None] - new_pos < cfg.local_window)
    out = _sdpa(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                ok[:, None, :], cfg)
    out = out.reshape(b, 1, -1) @ p.wo.to(x.dtype)
    return out, cache
