"""Deterministic, restartable data pipelines.

A copy of ``repro/data/pipeline.py`` (numpy and threads; the port imports
nothing of the JAX package).  Batches are numpy arrays, bit-equal to the
reference's for the same (seed, step, host); the training loop moves them
to the card.

* :class:`SyntheticLM`: seeded synthetic token/frames/patch streams for
  all model families; batch content is a pure function of (seed, step), so
  a restarted job resumes bit-identically from a checkpointed step, part
  of the fault-tolerance contract.
* :class:`MemmapTokens`: flat binary token file (np.memmap),
  sequence-chunked, sharded by (host_index, num_hosts); what a real corpus
  would use.
* :class:`Prefetcher`: background-thread prefetch of the next N batches
  (overlaps host data work with device compute).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "MemmapTokens", "Prefetcher", "make_batch_specs"]


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Shape/dtype dict of one raw batch for every family (pre-shift)."""
    if cfg.frontend == "audio":
        return {
            "frames": ((batch, seq, cfg.frontend_dim), np.float32),
            "labels": ((batch, seq), np.int32),
        }
    if cfg.frontend == "vlm":
        text = seq - cfg.num_patches
        return {
            "tokens": ((batch, text + 1), np.int32),
            "patches": ((batch, cfg.num_patches, cfg.frontend_dim),
                        np.float32),
        }
    return {"tokens": ((batch, seq + 1), np.int32)}


class SyntheticLM:
    """Learnable synthetic streams (not uniform noise: a bigram-ish process
    so that a training run shows decreasing loss)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 host_index: int = 0, num_hosts: int = 1):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.host_index, self.num_hosts = seed, host_index, num_hosts

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host_index)
        cfg = self.cfg
        if cfg.frontend == "audio":
            labels = rng.integers(0, cfg.vocab_size,
                                  (self.batch, self.seq), dtype=np.int32)
            # frames correlate with labels so the task is learnable
            proto = rng.standard_normal((cfg.vocab_size, cfg.frontend_dim))
            frames = proto[labels] + 0.1 * rng.standard_normal(
                (self.batch, self.seq, cfg.frontend_dim))
            return {"frames": frames.astype(np.float32), "labels": labels}
        if cfg.frontend == "vlm":
            text = self.seq - cfg.num_patches
            toks = self._bigram(rng, self.batch, text + 1, cfg.vocab_size)
            patches = rng.standard_normal(
                (self.batch, cfg.num_patches, cfg.frontend_dim))
            return {"tokens": toks,
                    "patches": patches.astype(np.float32)}
        return {"tokens": self._bigram(rng, self.batch, self.seq + 1,
                                       cfg.vocab_size)}

    @staticmethod
    def _bigram(rng, b: int, t: int, vocab: int) -> np.ndarray:
        """next ~ (3*prev + noise) mod vocab — low-entropy, learnable."""
        out = np.zeros((b, t), dtype=np.int64)
        out[:, 0] = rng.integers(0, vocab, b)
        noise = rng.integers(0, 7, (b, t))
        for i in range(1, t):
            out[:, i] = (3 * out[:, i - 1] + noise[:, i]) % vocab
        return out.astype(np.int32)


class MemmapTokens:
    """Sequence-chunked reader over a flat int32 token file."""

    def __init__(self, path: str, batch: int, seq: int,
                 host_index: int = 0, num_hosts: int = 1):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq = batch, seq
        self.host_index, self.num_hosts = host_index, num_hosts
        per = seq + 1
        self.n_seqs = len(self.data) // per
        if self.n_seqs < batch * num_hosts:
            raise ValueError("token file too small for one global batch")

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        per = self.seq + 1
        # deterministic strided order, disjoint across hosts
        base = (step * self.batch * self.num_hosts
                + self.host_index * self.batch)
        idx = (base + np.arange(self.batch)) % self.n_seqs
        toks = np.stack([self.data[i * per:(i + 1) * per] for i in idx])
        return {"tokens": toks.astype(np.int32)}


class Prefetcher:
    """Thread prefetch of next batches; .get(step) keyed by step for resume.

    Asking for a step before the last one returned (a restarted loop
    re-entering at its checkpoint) restarts the producer there.  The
    reference's ``Prefetcher`` would drain its queue for that step forever,
    since its producer only counts up.
    """

    def __init__(self, source, depth: int = 2, start_step: int = 0):
        self.source = source
        self.depth = depth
        self._start(start_step)

    def _start(self, step: int) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._want = step
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(self._q, self._stop, step), daemon=True)
        self._thread.start()

    def _work(self, q: "queue.Queue", stop: threading.Event, step: int):
        while not stop.is_set():
            q.put((step, self.source(step)))
            step += 1

    def get(self, step: int) -> Dict[str, np.ndarray]:
        if step < self._want:
            self.close()
            self._start(step)
        while True:
            s, b = self._q.get()
            if s == step:
                self._want = step + 1
                return b
            # stale (post-restart): drop and keep draining

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()     # unblock a producer waiting to put
        except queue.Empty:
            pass
