"""Serving steps: prefill, decode and greedy decoding.

Port of the serving half of ``repro/models/lm.py``; the loss and the train
step wait for the port of ``optim/`` (``ROADMAP.md``, Queue A item 9).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import transformer as tf
from .config import ModelConfig

__all__ = ["prefill", "make_decode_step", "greedy_decode"]


def _mask_pad_slots(caches: List[Dict], lengths: torch.Tensor
                    ) -> List[Dict]:
    """Invalidate KV-cache slots written by right-padding tokens.

    Each layer's cache carries per-request slot positions (``pos: [B,
    s]``); slots at or beyond a request's real length are marked -1 so
    decode masks them out.  Requires no ring wrap over the padded span
    (``padded len <= cache_len``), which the batcher guarantees.
    """
    ln = lengths[:, None].to(torch.int32)
    for c in caches:
        c["pos"] = torch.where(c["pos"] < ln, c["pos"], -1).to(torch.int32)
    return caches


def prefill(params: tf.Transformer, batch: Dict, cfg: ModelConfig,
            max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling a fresh decode cache.

    Returns (last_token_logits [B, V], caches, next_pos).  ``lengths``
    (int [B], optional) marks right-padded prompts: logits are read at each
    request's last real token, pad-written cache slots are invalidated, and
    ``next_pos`` is the per-request vector ``lengths`` instead of an int.
    Under causal attention a right-padded prefill is then exactly the
    unpadded one.
    """
    if cfg.is_encoder:
        raise ValueError("encoder models have no decode path")
    toks = batch["tokens"]
    caches = tf.init_cache(cfg, toks.shape[0], max_len, cache_dtype,
                           device=params.device)
    logits, caches, _ = tf.forward(params, batch, cfg, caches=caches)
    t = logits.shape[1]
    if lengths is None:
        return logits[:, -1], caches, t
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=logits.device)
    last = logits[torch.arange(logits.shape[0], device=logits.device),
                  lengths.long() - 1]
    return last, _mask_pad_slots(caches, lengths), lengths


def make_decode_step(cfg: ModelConfig, with_aux: bool = False):
    """Returns decode_step(params, token [B,1], caches, pos) ->
    (logits [B,V], new_caches) (with ``with_aux``, also the summed layer
    aux dict).  ``pos`` may be an int or a [B] tensor."""

    def decode_step(params, token, caches, pos):
        logits, new_caches = tf.decode_step(params, token, caches, pos, cfg)
        return logits[:, 0], new_caches

    def decode_step_aux(params, token, caches, pos):
        logits, new_caches, aux = tf.decode_step(params, token, caches, pos,
                                                 cfg, return_aux=True)
        return logits[:, 0], new_caches, aux

    return decode_step_aux if with_aux else decode_step


def greedy_decode(params: tf.Transformer, batch: Dict, cfg: ModelConfig,
                  steps: int, max_len: int,
                  cache_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Prefill + N greedy steps (the reference path of the tests): int32
    tokens [B, steps]."""
    logits, caches, pos = prefill(params, batch, cfg, max_len, cache_dtype)
    step = make_decode_step(cfg)
    out = []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, caches = step(params, tok, caches, pos)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        pos = pos + 1
    return torch.cat(out, dim=1)
