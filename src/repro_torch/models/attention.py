"""Grouped-query attention with QKV bias, logit softcap, local windows,
encoder (bidirectional) mode, and a ring-buffer KV cache for decode.

Port of ``repro/models/attention.py``.  A layer's cache is a dict of
tensors ``{"k": [B, S, K, hd], "v": [B, S, K, hd], "pos": int32 [B, S]}``
(the reference stacks one per layer unit; the port keeps one per layer).
Local (sliding-window) layers keep a cache of only ``window`` slots.  The
cache writes happen in place and the updated dict is returned, as the
reference returns its new cache.

Head counts come from the weights, so a rank of the tensor-parallel
program (``models/tensor_parallel.py``) runs the same bodies on its own
heads: its weights come through ``tensor_parallel.attn_weights`` and its
activations pass the reference's constrain sites there.  Its cache is
its shard (``attn_cache_specs``): by head, or by sequence, where a decode
step attends over the rank's slots and merges the partial softmaxes
(:func:`attn_decode`).  Outside the program the weights view holds every
head and the cache is whole, so both run the same bodies.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import tensor_parallel
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
    """q, k, v ``[B, T, heads, hd]`` of every head of ``p``."""
    w = tensor_parallel.WholeAttnWeights(cfg, p)
    return (w.q(x), *w.kv(x))


def _scores(q, k, mask, cfg: ModelConfig) -> torch.Tensor:
    """The logits ``[B, K, G, T, S]`` of q ``[B, T, K G, hd]`` (grouped
    over k's K heads) against k ``[B, S, K, hd]``: float32 whatever the
    operands' type (the reference's ``preferred_element_type``), scaled,
    softcapped, and ``NEG_INF`` where ``mask`` ``[B?, T, S]`` is False."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    q = q.reshape(b, t, kh, h // kh, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())
    logits = softcap(logits * (hd ** -0.5), cfg.attn_softcap)
    return torch.where(mask[:, None, None, :, :], logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype,
                                    device=logits.device))


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: [B,T,H,hd]; k,v: [B,S,K,hd]; mask: [B?,T,S] bool (True=attend).

    The scores are float32 (:func:`_scores`); the probabilities take v's
    type."""
    b, t, h, hd = q.shape
    probs = torch.softmax(_scores(q, k, mask, cfg), dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, hd)


def _sdpa_partial(q, k, v, mask, cfg: ModelConfig):
    """:func:`_sdpa`'s softmax over some of the slots, unnormalised: (the
    max ``[b, kh, g, t, 1]``, the sum of the exponentials, the output
    ``[b, kh, g, t, hd]`` before the division), float32.  Parts over
    disjoint slots merge by their log-sum-exp."""
    logits = _scores(q, k, mask, cfg)
    top = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - top)
    return top, e.sum(-1, keepdim=True), torch.einsum(
        "bkgts,bskd->bkgtd", e, v.float())


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
    """Online-softmax attention, looped over KV chunks: each chunk's
    :func:`_sdpa_partial`, merged into a running max and sum.

    q: [B,T,H,hd]; k,v: [B,S,K,hd].  Score working set is
    [B,heads,T,chunk]."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    pad = (-s) % kv_chunk
    if pad:  # ragged tail: pad with masked-out slots, never shrink the chunk
        k = torch.cat([k, k.new_zeros((b, pad, kh, hd))], 1)
        v = torch.cat([v, v.new_zeros((b, pad, kh, hd))], 1)
        pos_k = torch.cat([pos_k, torch.full(
            (pad,), INT32_MAX, dtype=pos_k.dtype, device=pos_k.device)])
        s += pad
    m = torch.full((b, kh, h // kh, t, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, h // kh, t, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, s, kv_chunk):
        mask = _pair_mask(cfg, kind, pos_q, pos_k[c0:c0 + kv_chunk])[None]
        top, l_c, o_c = _sdpa_partial(q, k[:, c0:c0 + kv_chunk],
                                      v[:, c0:c0 + kv_chunk], mask, cfg)
        m_new = torch.maximum(m, top)
        alpha, beta = torch.exp(m - m_new), torch.exp(top - m_new)
        l = l * alpha + l_c * beta
        acc = acc * alpha + o_c * beta
        m = m_new
    out = acc / l.clamp_min(1e-30)
    # [b,kh,g,t,hd] -> [b,t,h,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor, cache: Optional[Dict] = None):
    """Full-sequence attention (train / prefill).

    If ``cache`` is given (prefill), k/v are written into it and the
    updated cache is returned alongside the output.
    """
    t = x.shape[1]
    w = tensor_parallel.attn_weights(p, cfg)
    x = w.site("attn.in", x)
    q, (k, v) = w.q(x), w.kv(x)
    sin, cos = rope(positions, w.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if t > BLOCKED_ATTN_THRESHOLD:
        out = _sdpa_blocked(q, k, v, cfg, kind, positions, positions)
    else:
        mask = _pair_mask(cfg, kind, positions, positions)[None]
        out = _sdpa(q, k, v, mask, cfg)
    out = w.site("attn.out", w.out(out))
    if cache is None:
        return out, None
    return out, _write_cache(w, cache, x, k, v, positions, sin, cos, cfg,
                             kind)


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


def _write_cache(w, cache: Dict, x, k, v, positions, sin, cos,
                 cfg: ModelConfig, kind: str) -> Dict:
    """:func:`_write_prefill` into the cache this program holds (``w``'s
    :meth:`cache_layout`; all of it outside the tensor-parallel program):
    every slot's position (``pos`` is whole on every rank), and k and v of
    the cache's kv heads at the tokens whose slots it holds.  k and v of
    other kv heads than those attended with are read off ``w.kv`` (roped
    by ``sin``, ``cos``).  The tail's slots are unique, so each slot of
    the shard takes at most one token, found on the device."""
    s0, s, h0 = w.cache_layout(cache)
    s_loc, k_loc = cache["k"].shape[1:3]
    if (h0, h0 + k_loc) != w.kv_heads:
        k, v = w.kv(x, (h0, h0 + k_loc))      # collective: every rank asks
        k = apply_rope(k, sin, cos)
    if s_loc == s:
        return _write_prefill(cache, k, v, positions, cfg, kind)
    t = k.shape[1]
    keep = min(t, s)
    tail = positions[t - keep:]
    slots = (tail % s).long()
    cache["pos"][:, slots] = tail.to(torch.int32)[None, :]
    src = torch.full((s,), -1, dtype=torch.long, device=k.device)
    src[slots] = torch.arange(t - keep, t, device=k.device)
    src = src[s0:s0 + s_loc]             # the token of each of its slots
    got = (src >= 0)[None, :, None, None]
    src = src.clamp_min(0)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c.copy_(torch.where(got, new[:, src].to(c.dtype), c))
    return cache


def attn_decode(p: Params, x: torch.Tensor, cache: Dict, pos,
                cfg: ModelConfig, kind: str) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode step.  x: [B, 1, d].

    ``pos`` is an int (all rows at the same position) or an int ``[B]``
    tensor of per-request positions, which lets continuous batching mix
    requests at different depths in one decode batch.

    On a rank of the tensor-parallel program ``cache`` is the rank's
    shard: the new token's position goes to every rank's ``pos``, its k
    and v (the shard's kv heads) to the rank whose slots hold ``pos % s``.
    On a cache split by sequence every rank attends with every q head
    (gathered: one token's) over its own slots and the partial softmaxes
    are merged by their log-sum-exp; else with its own heads over every
    slot.  ``wo`` then takes the rank's heads, as in the forward.
    """
    w = tensor_parallel.attn_weights(p, cfg)
    b = x.shape[0]
    x = w.site("attn.in", x)
    s0, s, h0 = w.cache_layout(cache)
    s_loc, k_loc = cache["k"].shape[1:3]
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos_b.dim() == 0:
        pos_b = pos_b.expand(b)
    sin, cos = rope(pos_b[:, None], w.hd, cfg.rope_theta)
    q = apply_rope(w.q(x), sin, cos)
    k, v = w.kv(x, (h0, h0 + k_loc))
    k = apply_rope(k, sin, cos)
    slot = (pos_b % s).long()
    bidx = torch.arange(b, device=x.device)
    cache["pos"][bidx, slot] = pos_b
    local = (slot - s0).clamp(0, s_loc - 1)
    mine = ((slot >= s0) & (slot < s0 + s_loc))[:, None, None]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[bidx, local] = torch.where(mine, new[:, 0].to(c.dtype),
                                     c[bidx, local])
    # attend over valid slots: written, <= pos, and within window if local,
    # all per request, since each row carries its own position
    slots = cache["pos"][:, s0:s0 + s_loc]
    ok = (slots >= 0) & (slots <= pos_b[:, None])
    if kind == "l" and cfg.local_window:
        ok = ok & (pos_b[:, None] - slots < cfg.local_window)
    kc, vc = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    if s_loc < s:       # the cache split by sequence over the ranks
        tp = w.tp
        q = tp.all_heads(q)
        merged = tp.merge_softmax(*_sdpa_partial(q, kc, vc, ok[:, None, :],
                                                 cfg))
        out = tp.own_heads(merged.permute(0, 3, 1, 2, 4).reshape(
            b, 1, q.shape[2], w.hd).to(x.dtype))
    else:
        kv0, kv1 = (i - h0 for i in w.kv_heads)
        out = _sdpa(q, kc[:, :, kv0:kv1], vc[:, :, kv0:kv1], ok[:, None, :],
                    cfg)
    return w.site("attn.out", w.out(out)), cache
