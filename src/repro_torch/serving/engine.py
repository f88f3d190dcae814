"""ServeEngine: request-level serving over the plan API.

Port of ``repro/serving/engine.py``.  Admission -> prefill -> decode with
**continuous batching**: the engine owns a fixed pool of ``max_batch``
decode slots; new requests prefill at a bucketed shape (one plan set per
bucket, shared by every tenant in it; a recurrent model's prompts at their
exact length, ``effective_bucket``), their cache rows (KV or recurrent
state) are spliced into the batch cache at a free slot, and they join the
very next decode step.  A model with a frontend or an encoder is refused.
Finished requests retire at step boundaries and their slots are reusable
at once.

Each decode-batch row carries its own position (``pos: [B]``), so requests
at different depths share one step.  Vacant slots keep decoding garbage
into their own cache row; their outputs are ignored and the row is
overwritten at the next admission.

With ``sparse=True`` the hot path runs on the paper's engine: MoE dispatch
and combine and prefill attention scoring become ``DistBSR`` x
``DistDense`` products through the shared plan cache (see
``serving/sparse.py``); :meth:`cache_stats` gives the hit/miss/eviction
counters that show plans reused across tenants.

Parameters are float32 (``init_params``) and cast per use to the config's
``compute_dtype``; the cache is float32 by default, as in the reference.
Prefill and decode run without gradients, whatever the parameters'
``requires_grad``.
Import :class:`ServeEngine` from ``repro_torch.serving``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs as _obs
from ..core import api as _api
from ..models import lm, transformer as tf
from ..models.config import ModelConfig
from ..runtime.device import resolve_device, strict_fp32
from .batcher import DEFAULT_BUCKETS, RequestBatcher
from .metrics import ServingMetrics, sync_elapsed
from .sparse import SparseOps, sparse_attn_forward, sparse_moe_forward


@dataclasses.dataclass
class _Active:
    rid: int
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching serving engine over one model on one device
    (the card unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, *, params=None, seed: int = 0,
                 max_batch: int = 4, max_len: int = 64,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 sparse: bool = False, block_size: int = 8, device=None,
                 cache_dtype: torch.dtype = torch.float32, replanner=None,
                 replan_budget_s: float = float("inf"),
                 keep_first_logits: bool = False):
        if cfg.is_encoder:
            raise ValueError("encoder models have no decode path")
        if cfg.frontend:
            raise ValueError(f"{cfg.name}: the engine serves token prompts; "
                             f"a {cfg.frontend!r} model's prompts carry "
                             "its frontend's inputs (lm.greedy_decode "
                             "takes them)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_fp32()
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.sparse = sparse
        # optional ElasticReplanner (duck-typed: should_replan/refit),
        # checked at batch boundaries; see _maybe_replan
        self.replanner = replanner
        self.replan_budget_s = replan_budget_s
        self.replans = 0
        self.params = params if params is not None else \
            tf.init_params(cfg, seed, self.device)
        if isinstance(self.params, tf.Transformer) and self.params.device \
                != torch.empty(0, device=self.device).device:
            raise ValueError(f"parameters are on {self.params.device}, the "
                             f"engine runs on {self.device}")
        self.batcher = RequestBatcher(cfg, max_len, buckets)
        self.metrics = ServingMetrics()
        self.ops = SparseOps(block_size=block_size, device=self.device) \
            if sparse else None

        # decode-slot state (B = max_batch rows, recycled across requests)
        self.caches = tf.init_cache(cfg, max_batch, max_len, cache_dtype,
                                    self.device)
        self.pos = torch.zeros(max_batch, dtype=torch.int32,
                               device=self.device)
        self._pos_host = np.zeros(max_batch, np.int64)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.active: Dict[int, _Active] = {}        # slot -> request state
        self.results: Dict[int, np.ndarray] = {}
        # with keep_first_logits: rid -> float32 [V] logits of the prefill's
        # last real token (the first generated token's), for checking
        self.first_logits: Optional[Dict[int, torch.Tensor]] = \
            {} if keep_first_logits else None
        self._cache_dtype = cache_dtype
        self._decode_fn = lm.make_decode_step(cfg, with_aux=True)
        self._n_moe = (sum(1 for k in cfg.pattern if k in ("g", "l"))
                       if cfg.moe is not None else 0)

    # ------------------------------------------------------------ sparse fns
    def _moe_fn(self, p, x, cfg):
        return sparse_moe_forward(self.ops, p, x, cfg)

    def _attn_fn(self, p, x, cfg, kind, positions, cache):
        return sparse_attn_forward(self.ops, p, x, cfg, kind, positions,
                                   cache)

    # -------------------------------------------------------------- requests
    def submit(self, tokens, max_new_tokens: int, arrival: float = 0.0,
               rid: Optional[int] = None):
        """Queue a request.  ``arrival`` is an offset (s) from run start."""
        return self.batcher.submit(tokens, max_new_tokens, arrival, rid)

    # --------------------------------------------------------------- prefill
    @staticmethod
    def _insert_row(caches: List[Dict], row: List[Dict], slot: int) -> None:
        """Splice a batch-1 prefilled cache into the decode cache at
        ``slot`` (in place; the batch dim is axis 0 of every layer's
        tensors: an attention layer's ``k``/``v``/``pos``, an RG-LRU
        layer's ``h``/``conv``, a Mamba layer's ``ssm``/``conv``)."""
        for c, r in zip(caches, row):
            for key, val in r.items():
                c[key][slot] = val[0].to(c[key].dtype)

    @torch.no_grad()
    def _prefill(self, toks: torch.Tensor, lengths: torch.Tensor):
        cfg = self.cfg
        if not self.sparse:
            return lm.prefill(self.params, {"tokens": toks}, cfg,
                              self.max_len, self._cache_dtype, lengths)
        # the sparse forward interleaves host-side operator construction
        # with device math, layer by layer; the products themselves run
        # through cached MatmulPlans
        caches = tf.init_cache(cfg, 1, self.max_len, self._cache_dtype,
                               self.device)
        logits, caches, _ = tf.forward_unscanned(
            self.params, {"tokens": toks}, cfg, caches=caches,
            moe_fn=self._moe_fn, attn_fn=self._attn_fn)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      lengths.long() - 1]
        return last, lm._mask_pad_slots(caches, lengths), lengths

    def _admit(self, req) -> None:
        slot = next(s for s in range(self.max_batch)
                    if s not in self.active)
        toks_np, length = self.batcher.padded(req)
        bucket = toks_np.shape[1]
        sp = _obs.span("serve.admit", rid=req.rid, bucket=bucket)
        with sp:
            self.metrics.admitted(req.rid, bucket)
            t0 = time.perf_counter()
            with _obs.span("serve.prefill", rid=req.rid, bucket=bucket):
                toks = torch.as_tensor(toks_np, device=self.device)
                lengths = torch.tensor([length], dtype=torch.int32,
                                       device=self.device)
                last, row, _ = self._prefill(toks, lengths)
                tok = last.argmax(-1).to(torch.int32)         # [1]
                self._insert_row(self.caches, row, slot)
                self.pos[slot] = length
                self.tokens[slot, 0] = tok[0]
                dt = sync_elapsed(t0, (self.caches, self.tokens))
            sp.note(prefill_s=dt)
        self._pos_host[slot] = length
        if self.first_logits is not None:
            self.first_logits[req.rid] = last[0]
        self.metrics.prefill_done(req.rid, dt)
        st = _Active(req.rid, req.max_new_tokens)
        st.out.append(int(tok[0]))
        self.active[slot] = st
        self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        st = self.active[slot]
        if len(st.out) >= st.max_new_tokens \
                or self._pos_host[slot] >= self.max_len:
            self.results[st.rid] = np.asarray(st.out, np.int32)
            self.metrics.finished(st.rid)
            del self.active[slot]

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode_step(self) -> None:
        with _obs.span("serve.decode_step", batch=len(self.active)) as sp:
            self._decode_step_inner(sp)

    def _decode_step_inner(self, sp) -> None:
        t0 = time.perf_counter()
        if self.sparse:
            logits, caches, aux = tf.decode_step_unscanned(
                self.params, self.tokens, self.caches, self.pos, self.cfg,
                moe_fn=self._moe_fn)
            logits = logits[:, 0]
        else:
            logits, caches, aux = self._decode_fn(
                self.params, self.tokens, self.caches, self.pos)
        tok = logits.argmax(-1).to(torch.int32)               # [B]
        active_mask = np.zeros((self.max_batch,), np.int32)
        for s in self.active:
            active_mask[s] = 1
        self.caches = caches
        self.pos = self.pos + torch.as_tensor(active_mask,
                                              device=self.device)
        self._pos_host += active_mask
        self.tokens = tok[:, None]
        dt = sync_elapsed(t0, (self.tokens, self.caches))
        sp.note(step_s=dt)
        dropped = (float(aux["dropped"]) / self._n_moe
                   if self._n_moe else None)
        rids = [st.rid for st in self.active.values()]
        self.metrics.decode_step_done(dt, rids, dropped)
        tok_np = tok.cpu().numpy()
        for slot in list(self.active):
            self.active[slot].out.append(int(tok_np[slot]))
            self._maybe_finish(slot)

    # ----------------------------------------------------------- replanning
    def _maybe_replan(self) -> bool:
        """Drain-and-refit at a batch boundary when the replanner trips.

        In-flight requests decode to completion first so no request ever
        straddles a plan swap; then the replanner re-fits and evicts the
        stale plans (they rebuild on the next cache miss).  Overruns of
        ``replan_budget_s`` are counted, never raised.
        """
        rp = self.replanner
        if rp is None:
            return False
        trips = rp.should_replan()
        if not trips:
            return False
        t0 = time.perf_counter()
        with _obs.span("serve.replan", trips=",".join(sorted(trips))) as sp:
            drained = 0
            while self.active:
                self._decode_step()
                drained += 1
            rp.refit(trips)
            dt = sync_elapsed(t0, (self.tokens, self.caches))
            sp.note(drained_steps=drained, replan_s=dt)
        reg = _obs.registry()
        reg.counter("serve.replans").inc()
        reg.histogram("serve.replan_s").observe(dt)
        if dt > self.replan_budget_s:
            reg.counter("serve.replan_budget_exceeded").inc()
        self.replans += 1
        return True

    # ------------------------------------------------------------------- run
    def run(self) -> Dict[int, np.ndarray]:
        """Serve every queued request to completion; returns rid -> tokens.

        Admission happens at step boundaries: before each decode step any
        arrived request takes a free slot (continuous batching).  Each
        prefill and each decode step is timed to the end of its work.
        """
        m = self.metrics
        t0 = m.start()
        for req in list(self.batcher._queue):
            m.submitted(req.rid, t0 + req.arrival, req.prompt_len)
        while len(self.batcher) or self.active:
            self._maybe_replan()
            now = time.perf_counter() - t0
            while len(self.active) < self.max_batch:
                req = self.batcher.pop(now)
                if req is None:
                    break
                self._admit(req)
            if not self.active:
                nxt = self.batcher.next_arrival()
                if nxt is not None and nxt > now:
                    time.sleep(min(nxt - now, 0.005))
                continue
            self._decode_step()
        m.stop()
        return dict(self.results)

    # ------------------------------------------------------------- observab.
    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Plan-layer cache counters (``repro_torch.core.api.cache_stats``)."""
        return _api.cache_stats()

    def summary(self) -> Dict:
        return self.metrics.summary()
