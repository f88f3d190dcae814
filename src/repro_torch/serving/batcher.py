"""Shape-bucketed request admission for the serving engine.

Port of ``repro/serving/batcher.py`` (host numpy, unchanged).

Prompts arrive with arbitrary lengths; a prefill per exact length would
re-plan per tenant.  The batcher rounds each prompt up
to a small set of padded buckets, so concurrent tenants share a handful of
prefill shapes — and therefore the capacity-bucketed ``plan_matmul`` LRU
caches hit across requests (the serving-layer analogue of
``DistBSR.from_dense(capacity="bucket")``).

Right-padding is exact under causal attention: ``lm.prefill(lengths=...)``
reads logits at the last real token and invalidates pad-written cache
slots.  Two model families opt out of padding:

* recurrent layers ('r' RG-LRU / 'm' Mamba) fold *every* position into
  their state, pad tokens included — padded prefill would corrupt it;
* local-attention ring buffers shorter than the bucket would wrap, letting
  pad slots overwrite real ones before they can be invalidated.

For those, :func:`effective_bucket` degrades to the exact prompt length
(correct, just one plan set per distinct length).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)


@dataclasses.dataclass
class Request:
    """One tenant request: a prompt and a generation budget."""
    rid: int
    tokens: np.ndarray               # int32 [L]
    max_new_tokens: int
    arrival: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


def bucket_for(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= length."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]}")


def padding_supported(cfg, bucket: int, max_len: int) -> bool:
    """True if right-padded prefill up to ``bucket`` is exact for ``cfg``."""
    from ..models import attention as attn_mod
    for kind in cfg.pattern:
        if kind not in ("g", "l"):
            return False                 # recurrent state sees pad tokens
        if bucket > attn_mod.cache_len(cfg, kind, max_len):
            return False                 # ring would wrap over pad slots
    return True


def effective_bucket(cfg, length: int, max_len: int,
                     buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Bucketed prefill length, degrading to exact length when padding
    would be unsound for this config (see module docstring)."""
    b = bucket_for(length, buckets)
    if b == length or padding_supported(cfg, b, max_len):
        return b
    return length


def pad_prompt(tokens: np.ndarray, bucket: int) -> np.ndarray:
    """Right-pad a [L] prompt to [bucket] with zeros (masked out later)."""
    out = np.zeros((bucket,), np.int32)
    out[: tokens.shape[0]] = tokens
    return out


class RequestBatcher:
    """FIFO admission queue with arrival times and shape bucketing."""

    def __init__(self, cfg, max_len: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.cfg = cfg
        self.max_len = max_len
        self.buckets = tuple(buckets)
        self._queue: Deque[Request] = collections.deque()
        self._next_rid = 0

    def submit(self, tokens, max_new_tokens: int,
               arrival: float = 0.0, rid: Optional[int] = None) -> Request:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid, tokens, max_new_tokens, arrival)
        if req.prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"request {rid}: prompt {req.prompt_len} + gen "
                f"{max_new_tokens} exceeds max_len {self.max_len}")
        self._queue.append(req)
        return req

    def pop(self, now: float) -> Optional[Request]:
        """Next admissible request (FIFO among those already arrived)."""
        if self._queue and self._queue[0].arrival <= now:
            return self._queue.popleft()
        return None

    def next_arrival(self) -> Optional[float]:
        return self._queue[0].arrival if self._queue else None

    def bucket(self, req: Request) -> int:
        return effective_bucket(self.cfg, req.prompt_len, self.max_len,
                                self.buckets)

    def padded(self, req: Request) -> Tuple[np.ndarray, int]:
        """(padded [1, bucket] prompt, real length) for prefill."""
        b = self.bucket(req)
        return pad_prompt(req.tokens, b)[None, :], req.prompt_len

    def __len__(self) -> int:
        return len(self._queue)
