"""Losses and step functions (train, prefill, decode) for all families.

Port of ``repro/models/lm.py``.  ``make_train_step`` differentiates
``loss_fn`` with autograd where the reference calls ``jax.value_and_grad``,
and updates the model in place (the reference donates its parameters).
The serving steps run without gradients.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import transformer as tf
from .config import ModelConfig

__all__ = ["cross_entropy", "loss_fn", "make_train_step", "prefill",
           "make_decode_step", "greedy_decode"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions.  logits: [B, T, V] float32."""
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom


def _shift_batch(batch: Dict, cfg: ModelConfig
                 ) -> Tuple[Dict, torch.Tensor]:
    """(model inputs, labels) from a raw batch: next-token prediction; an
    audio encoder predicts each frame's unit (no shift), and a vlm's patch
    positions are labelled -1 (ignored)."""
    if cfg.frontend == "audio":
        return {"frames": batch["frames"]}, batch["labels"]
    toks = batch["tokens"]
    if cfg.frontend == "vlm":
        inputs = {"tokens": toks[:, :-1], "patches": batch["patches"]}
        ignore = toks.new_full((toks.shape[0], batch["patches"].shape[1]),
                               -1)
        return inputs, torch.cat([ignore, toks[:, 1:]], dim=1)
    return {"tokens": toks[:, :-1]}, toks[:, 1:]


def loss_fn(params: tf.Transformer, batch: Dict, cfg: ModelConfig):
    """(total loss, metrics): cross-entropy plus the layers' aux losses;
    the metrics ``loss``, ``aux`` and ``dropped`` are detached."""
    inputs, labels = _shift_batch(batch, cfg)
    logits, _, aux = tf.forward(params, inputs, cfg)
    loss = cross_entropy(logits, labels)
    total = loss + aux["aux"]
    metrics = {"loss": loss.detach(), "aux": aux["aux"].detach(),
               "dropped": aux["dropped"].detach()}
    return total, metrics


def make_train_step(cfg: ModelConfig, optimizer):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The optimizer is a ``repro_torch.optim`` object (init,
    update, apply).  ``params`` (the model) is made trainable and updated
    in place, ``opt_state``'s moments too; ``batch`` holds int tensors on
    the model's device.  Nothing is read back to the host: the metrics
    (``loss``, ``aux``, ``dropped``, ``grad_norm``) are 0-d tensors."""

    def train_step(params: tf.Transformer, opt_state: Dict, batch: Dict):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        total, metrics = loss_fn(params, batch, cfg)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        opt_state = optimizer.apply(named, grads, opt_state)
        metrics["grad_norm"] = optimizer.last_grad_norm(opt_state)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _mask_pad_slots(caches: List[Dict], lengths: torch.Tensor
                    ) -> List[Dict]:
    """Invalidate KV-cache slots written by right-padding tokens.

    An attention layer's cache carries per-request slot positions (``pos:
    [B, s]``); slots at or beyond a request's real length are marked -1 so
    decode masks them out.  Requires no ring wrap over the padded span
    (``padded len <= cache_len``), which the batcher guarantees.
    Recurrent-state caches (no ``pos`` key) pass through untouched.
    """
    ln = lengths[:, None].to(torch.int32)
    for c in caches:
        if "pos" in c:
            c["pos"] = torch.where(c["pos"] < ln, c["pos"], -1).to(
                torch.int32)
    return caches


@torch.no_grad()
def prefill(params: tf.Transformer, batch: Dict, cfg: ModelConfig,
            max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling a fresh decode cache.

    Returns (last_token_logits [B, V], caches, next_pos), without
    gradients.  ``lengths`` (int [B], optional) marks right-padded
    prompts: logits are read at each request's last real token,
    pad-written cache slots are invalidated, and ``next_pos`` is the
    per-request vector ``lengths`` instead of an int.  Under causal
    attention a right-padded prefill is then exactly the unpadded one.
    """
    if cfg.is_encoder:
        raise ValueError("encoder models have no decode path")
    bsz = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[0]
    caches = tf.init_cache(cfg, bsz, max_len, cache_dtype,
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
    aux dict), without gradients.  ``pos`` may be an int or a [B]
    tensor."""

    @torch.no_grad()
    def decode_step(params, token, caches, pos):
        logits, new_caches = tf.decode_step(params, token, caches, pos, cfg)
        return logits[:, 0], new_caches

    @torch.no_grad()
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
