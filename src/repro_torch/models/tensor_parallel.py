"""The FSDP x tensor-parallel program of every config of the registry:
the one place that decides, for each ``constrain`` site of the JAX
package, which collective turns its producer's layout into the
constrained one.

The JAX package runs its LMs as "FSDP (over 'data') x TP (over 'model')"
(``repro/models/attention.py``, ``moe.py``, ``rglru.py``, ``ssm.py``,
``frontend.py``): the specs shard heads, MLP hidden units, experts,
recurrent channels, SSM projections and the vocabulary over ``model``,
and GSPMD partitions every product at the ``constrain`` sites.  Here the
rank body is explicit.  Inside :func:`use`
(``sharded.ShardedModel.running`` opens it) each parameter is gathered
over the batch axes only, so it keeps its shard along ``model``: the
top-level ones for the whole step, a layer's at its turn (:func:`layer`),
as FSDP gathers JAX's scanned layers; the
layers read their weights through :func:`attn_weights`,
:func:`mlp_weights`, :func:`moe_weights`, :func:`frontend_weights` and
:func:`head_weight` (the RG-LRU's and the SSM's through their modules'
``_Weights``) and call :func:`site` where the reference constrains.
Outside it all of these are the identity and the layers run the
single-process program.

A rank computes the q heads, MLP hidden units, experts, recurrent
channels, frontend columns and vocabulary entries of its ``model``
coordinate where the count divides the axis (the sanitize rule of the
reference's ``constrain``), and all of them where it does not; the SSM's
products take ``ceil(n / m)`` a rank (:meth:`TensorParallel.chunk`):

=============  ==============================  ====================  =====================
site           reference                       producer              collective
=============  ==============================  ====================  =====================
``attn.in``    (before ``attention.py:60``)    replicated x          copy-to-model
q, k, v        ``attention.py:71-73``          the rank's heads      none
``attn.out``   ``attention.py:182``            partial sums          reduce-from-model
``mlp.in``     (before ``mlp.py:42``)          replicated x          copy-to-model
hidden         ``mlp.py:48``                   the rank's units      none
``mlp.out``    ``mlp.py:50``                   partial sums          reduce-from-model
``moe.in``     ``moe.py:168-169``              replicated tokens,    copy-to-model
                                               combine weights
xe, ye         ``moe.py:176``, ``:180``        the rank's experts    none
``moe.out``    ``moe.py:190``, ``:193``        partial sums          reduce-from-model
``rec.in``     (before ``rglru.py:98``)        replicated x          copy-to-model
xc             ``rglru.py:105``                the rank's channels   none (gates: blocks)
``rec.out``    ``rglru.py:117``                partial sums          reduce-from-model
``ssm.in``     (before ``ssm.py:150``)         replicated x          copy-to-model
xh             ``ssm.py:154``                  the rank's heads      all-gathers (ssm.py)
``ssm.out``    ``ssm.py:162``                  partial sums          reduce-from-model
``front.in``   (before ``frontend.py:55``)     replicated patches    copy-to-model
``front.out``  (``frontend.py:57``)            partial sums          reduce-from-model
``embed``      ``transformer.py:281``          x's ``d`` shard       all-gather (slice back)
``head.in``    (before ``transformer.py:335``) replicated x          copy-to-model
logits         ``transformer.py:339``          the rank's vocabulary none (vocab-parallel)
``head.in``    tied, head rows                 replicated x          its ``d`` columns
``head.out``   ``transformer.py:339``          partial sums          reduce-from-model
=============  ==============================  ====================  =====================

Copy-to-model is the identity forward and sums the gradient over
``model``; reduce-from-model sums forward and passes the gradient.  A MoE
layer routes its tokens alike on every rank of ``model`` (the router is
replicated), then copies to ``model`` the tokens it dispatches and the
weights it combines with: each rank fills and runs its own experts' slots
only and its combine reads the others' as zeros, so the layer's output is
a partial sum (``models/moe.py``).  The routing is the global batch's
(:attr:`TensorParallel.shards`: the slots' offsets and the aux losses
over the batch axes).  A weight whose layout at rest is not the one its
product reads is moved by :meth:`TensorParallel.relayout`: a tied
embedding, at rest ``[V, d / m]``, is exchanged all-to-all into the
head's ``[V / m, d]`` for a train step or a prefill; a decode step, and
any step where the vocabulary does not divide the axis, reads it as it
lies and all-reduces partial logits of every entry instead (the head
rows), as GSPMD partitions the reference's.  The audio frontend's
projection gives the rank's ``d`` columns, all-gathered at the
``"embed"`` site before its layer norm.  Where the kv heads do not divide
the axis but their columns do, each rank projects its columns of k and v
and the projections are all-gathered; where the q heads do not, its
columns of q and rows of ``wo`` (:class:`AttnWeights`).  A KV cache is
read where it lies (``attention.attn_cache_specs``): by head, or by
sequence, where each rank attends over its own slots and a log-sum-exp
merge (:meth:`TensorParallel.merge_softmax`) all-reduces the partial
results.  A decode step whose rows the batch axes do not split leaves
'data' idle: nothing is gathered, and each product is partitioned over
'data' as its weight lies (:func:`dot`, :func:`embed_rows`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch

from .common import BATCH_AXES
from .common import MODEL_AXIS as AXIS

FSDP_AXIS = "data"      # the axis the parameter specs split besides model
from .config import ModelConfig

__all__ = ["TensorParallel", "WholeAttnWeights", "AttnWeights", "supported",
           "use", "current", "layer", "site", "dot", "embed_rows",
           "attn_weights", "mlp_weights", "frontend_weights", "moe_weights",
           "head_weight"]


def supported(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` runs the FSDP x TP program on a mesh: every layer
    kind of the registry (global and local attention, causal or not, with
    a dense MLP or experts; the RG-LRU block; the Mamba-2 mixer) and both
    frontends.  Nothing else has a program on a mesh."""
    return (set(cfg.pattern) <= {"g", "l", "r", "m"}
            and cfg.frontend in (None, "audio", "vlm"))


class WholeAttnWeights:
    """One attention layer's projections outside the program: every head
    of ``p``, a cache whole.  :meth:`q` the q heads, :meth:`kv` k and v of
    the kv heads ``kv_heads`` (or of a range of them), :meth:`out` the
    output projection, :meth:`cache_layout` where a cache's slots and
    heads lie, and :meth:`site` its collectives at the attention's
    constrain sites (none)."""
    tp = None

    def __init__(self, cfg: ModelConfig, p):
        self.cfg, self.p = cfg, p
        self.hd = cfg.resolved_head_dim
        self.kv_heads = (0, cfg.n_kv_heads)
        self.wq, self.wo = p.wq, p.wo
        self.bq = p.bq if cfg.qkv_bias else None

    def site(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """The output projection of the attention's output ``o`` ``[B, T,
        heads, hd]``."""
        return dot(o.reshape(*o.shape[:2], -1), self.wo, self.cfg.d_model)

    def _proj(self, x, w, b):
        y = dot(x, w)
        if b is not None:
            y = y + b.to(x.dtype)
        return y.reshape(*x.shape[:2], -1, self.hd)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """The q heads ``[B, T, heads, hd]``."""
        return self._proj(x, self.wq, self.bq)

    def kv(self, x: torch.Tensor, heads: Optional[Tuple[int, int]] = None):
        """k, v ``[B, T, heads, hd]`` of kv heads ``heads`` (default
        ``kv_heads``)."""
        p, bias = self.p, self.cfg.qkv_bias
        h0, h1 = heads or self.kv_heads
        return tuple(self._proj(x, w, b)[:, :, h0:h1] for w, b in (
            (p.wk, p.bk if bias else None), (p.wv, p.bv if bias else None)))

    def cache_layout(self, cache) -> Tuple[int, int, int]:
        """(first slot, whole slot count, first kv head) of the cache this
        program holds: all of it."""
        return 0, cache["pos"].shape[1], 0


class AttnWeights(WholeAttnWeights):
    """One attention layer's projections as a rank of the program
    computes them: :meth:`q` its own q heads (``q_heads``), :meth:`kv` the
    kv heads those read (``kv_heads``) or any range (a cache shard's),
    :meth:`out` through its rows of ``wo``, :meth:`cache_layout` its cache
    shard's (``TensorParallel.cache_layout``).

    Where the q heads do not divide ``model`` but q's columns do (``by_
    cols``; arctic's 56 heads on 16), the rank still projects only its
    column shard of q, all-gathered over ``model``, and only its rows of
    ``wo`` (partial sums, reduced at ``attn.out``), as GSPMD partitions
    the reference's: no parameter moves.  In between it attends with the
    heads of its group, the ``gcd(heads, m)`` groups each computed alike
    by ``m / gcd`` ranks (GSPMD's choice: 7 heads a device for arctic),
    or, in a decode step, with every head over its slots.  Where m
    divides neither, attention is whole on every rank.

    Where the kv heads do not divide ``model`` but their columns do (the
    at-rest shard is not head-aligned), each rank projects its column
    shard and the projections are all-gathered over ``model`` (their
    gradient reduce-scattered back, as GSPMD partitions the reference's
    replicated k and v): no rank computes another's columns."""

    def __init__(self, tp: "TensorParallel", p):
        super().__init__(tp.cfg, p)
        cfg, self.tp = tp.cfg, tp
        self.q_heads, self.kv_heads = tp.q_heads, tp.kv_heads
        nq = cfg.n_heads * self.hd
        self.nkv = cfg.n_kv_heads * self.hd
        m = tp.m
        self.by_cols = (m > 1 and not tp.q_split
                        and p.wq.shape[1] * m == nq
                        and (not cfg.qkv_bias or p.bq.shape[0] * m == nq))
        # each rank computes a part of the layer from its input
        self.split = tp.q_split or self.by_cols
        if self.by_cols:
            self.wq, self.wo = p.wq, p.wo
            self.bq = p.bq if cfg.qkv_bias else None
            if not tp.decode:
                self.q_heads, self.kv_heads = tp.head_group()
        else:
            s = tp.q_split
            self.wq = tp.relayout(p.wq, 1, nq, s, s)
            self.wo = tp.relayout(p.wo, 0, nq, s, s)
            self.bq = tp.relayout(p.bq, 0, nq, s, s) \
                if cfg.qkv_bias else None
        self._every = None

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.by_cols:
            return super().q(x)
        y = dot(x, self.wq)
        if self.bq is not None:
            y = y + self.bq.to(x.dtype)
        y = self.tp.comm.gather_along(y, AXIS, y.dim() - 1, grad="sum")
        q0, q1 = self.q_heads
        return y[..., q0 * self.hd:q1 * self.hd].reshape(
            *x.shape[:2], -1, self.hd)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        if not self.by_cols:
            return super().out(o)
        # the rank's columns of the output are its rows of wo
        n = self.wo.shape[0]
        c0 = self.tp.j * n - self.q_heads[0] * self.hd
        o = o.reshape(*o.shape[:2], -1)[..., c0:c0 + n]
        return dot(o, self.wo, self.cfg.d_model)

    def site(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The collective at the attention's constrain site ``name``:
        ``tp.site``'s, or, over q's columns, copy-to-model at ``attn.in``
        and reduce-from-model at ``attn.out``."""
        if self.by_cols:
            c = self.tp.comm
            return c.copy_to(x, AXIS) if name == "attn.in" else \
                c.reduce_from(x, AXIS)
        return self.tp.site(name, x)

    def cache_layout(self, cache) -> Tuple[int, int, int]:
        return self.tp.cache_layout(cache)

    def kv(self, x: torch.Tensor, heads: Optional[Tuple[int, int]] = None):
        """k, v ``[B, T, heads, hd]`` of kv heads ``heads`` (default the
        ones the rank's q heads read).  A range other than the rank's own
        (a cache shard's) is read off every head's projection, made once
        a layer call (collective: every rank asks alike)."""
        tp, p = self.tp, self.p
        bias = tp.cfg.qkv_bias
        heads = heads or self.kv_heads
        if tp.kv_split and heads == self.kv_heads:
            return tuple(self._proj(x, tp.relayout(w, 1, self.nkv, True,
                                                   True),
                                    tp.relayout(b, 0, self.nkv, True, True)
                                    if bias else None)
                         for w, b in ((p.wk, p.bk if bias else None),
                                      (p.wv, p.bv if bias else None)))
        if self._every is None or self._every[0] is not x:
            self._every = (x, self._every_head(x))
        h0, h1 = heads
        return tuple(y[:, :, h0:h1] for y in self._every[1])

    def _every_head(self, x):
        tp, p, n, c = self.tp, self.p, self.nkv, self.tp.comm
        bias = tp.cfg.qkv_bias
        out = []
        for w, b in ((p.wk, p.bk if bias else None),
                     (p.wv, p.bv if bias else None)):
            if tp.m > 1 and w.shape[1] * tp.m == n:
                # the rank's columns, then every rank's: the gradient of a
                # part each rank reads is summed back (reduce-scatter); the
                # input's, a part of the whole, too (copy-to: where the
                # rank computes a part of the layer, the attention's input
                # came through one already)
                xin = x if self.split else c.copy_to(x, AXIS)
                y = dot(xin, w)
                if b is not None:
                    y = y + b.to(x.dtype)
                y = c.gather_along(y, AXIS, y.dim() - 1,
                                   grad="sum" if self.split else "slice")
                out.append(y.reshape(*x.shape[:2], -1, self.hd))
            else:
                s = self.split
                out.append(self._proj(
                    x, tp.relayout(w, 1, n, False, s),
                    tp.relayout(b, 0, n, False, s) if b is not None
                    else None))
        return out


class TensorParallel:
    """The layouts of ``cfg``'s tensor-parallel program over the ``model``
    axis of ``comm`` (a :class:`~repro_torch.launch.mesh.MeshComm`), and
    the collectives at its sites.

    ``q_split``: each rank computes the q heads of its coordinate (the
    heads divide the axis and the rank's kv heads group uniformly);
    ``kv_split``: and its own kv heads (those divide it too);
    ``ff_split``, ``vocab_split``: MLP hidden units and vocabulary
    entries likewise; ``moe_split``: the experts; ``front_split``: a
    frontend's projections (their ``d`` columns); ``head_rows``: a tied
    head reads the embedding's ``d`` slice as it lies and sums the
    partial logits over ``model`` (then the logits are whole,
    ``vocab_split`` is off), in a ``decode`` step and wherever the
    vocabulary does not divide the axis (GSPMD's partition of mamba2's
    50280 entries on 16).  With one rank on the axis nothing is split.
    :meth:`chunk`, :meth:`part` and :meth:`gather_chunks` cut and join a
    dimension the way GSPMD partitions a product over one the axis does
    not divide (the recurrent and SSM layers').

    ``batch_axes``, ``shards`` and ``shard``: the batch axes of the mesh,
    how many parts of the batch the layers' tokens are one of, and which
    (row-major over the batch axes, as ``sharded.place_batch`` cuts it):
    the parts of a batch split over the batch axes (``batch_split``), or
    one, the whole batch on every rank."""

    def __init__(self, cfg: ModelConfig, comm, decode: bool = False,
                 batch_split: bool = True):
        self.cfg, self.comm, self.decode = cfg, comm, decode
        m = comm.size(AXIS) if AXIS in comm.sizes else 1
        j = comm.index(AXIS) if AXIS in comm.sizes else 0
        self.m, self.j = m, j
        h, k = cfg.n_heads, cfg.n_kv_heads
        g = h // k
        # a rank's q heads must group uniformly over the kv heads they
        # read (one kv head, or whole groups), on every rank alike; else
        # attention stays whole on every rank
        self.q_split = m > 1 and h % m == 0 and all(
            q0 // g == (q0 + h // m - 1) // g or not (q0 % g or h // m % g)
            for q0 in range(0, h, max(h // m, 1)))
        q0, q1 = (j * h // m, (j + 1) * h // m) if self.q_split else (0, h)
        self.q_heads = (q0, q1)
        self.kv_heads = (q0 // g, (q1 - 1) // g + 1)
        self.kv_split = self.q_split and k % m == 0
        self.ff_split = m > 1 and cfg.d_ff % m == 0
        # one token's logits of every entry move, not the embedding (and
        # a batch's, where the vocabulary does not divide the axis)
        self.head_rows = (cfg.tie_embeddings and m > 1
                          and cfg.d_model % m == 0
                          and (decode or cfg.vocab_size % m != 0))
        self.vocab_split = (m > 1 and cfg.vocab_size % m == 0
                            and not self.head_rows)
        self.moe_split = (m > 1 and cfg.moe is not None
                          and cfg.moe.n_experts % m == 0)
        self.front_split = m > 1 and cfg.d_model % m == 0
        # a decode step whose rows the batch axes do not split (one row:
        # long_500k) leaves 'data' idle: the parameters stay split over it
        # as they lie and the products are partitioned over it (:func:`dot`)
        self.fsdp_split = (decode and not batch_split and cfg.moe is None
                           and comm.sizes.get(FSDP_AXIS, 1) > 1)
        self.batch_axes = [a for a in BATCH_AXES if a in comm.sizes]
        # gather_layer(block): a context inside which the block holds its
        # parameters as the program reads them (:func:`layer`); None: as
        # they lie
        self.gather_layer = None
        self.shards, self.shard = 1, 0
        if batch_split:
            for a in self.batch_axes:
                self.shards *= comm.size(a)
                self.shard = self.shard * comm.size(a) + comm.index(a)

    # -- weights ----------------------------------------------------------
    def relayout(self, w: torch.Tensor, dim: int, whole: int,
                 want_split: bool, partial: bool,
                 want_dim: Optional[int] = None) -> torch.Tensor:
        """``w`` (gathered over the batch axes) in the layout its product
        reads: split over ``model`` along ``want_dim`` (default ``dim``)
        when ``want_split``, whole otherwise.  At rest its dimension
        ``dim`` (``whole`` long) is split where the axis divides it (the
        sanitized spec), whole otherwise.  ``partial``: each rank's
        product reads a part of the result (its gradient of ``w`` is its
        part, summed over ``model`` below); else every rank computes the
        same thing."""
        want_dim = dim if want_dim is None else want_dim
        have_split = self.m > 1 and w.shape[dim] * self.m == whole
        c = self.comm
        if have_split and want_split:
            if want_dim == dim:
                return w
            return c.exchange(w, AXIS, want_dim, dim)
        if have_split:
            return c.gather_along(w, AXIS, dim,
                                  grad="sum" if partial else "slice")
        if want_split:
            return c.copy_to(w, AXIS).chunk(self.m, want_dim)[self.j]
        return c.copy_to(w, AXIS) if partial and self.m > 1 else w

    def chunk(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's part of a dimension of ``n`` as GSPMD cuts
        a product's dimension over ``model``: ``ceil(n / m)`` a rank in
        coordinate order, so the last ranks' parts are shorter or empty
        where ``m`` does not divide ``n`` (then the dimension lies whole
        at rest, by the sanitize rule), its shard where it does."""
        c = -(-n // self.m)
        lo = min(self.j * c, n)
        return lo, min(lo + c, n)

    def part(self, w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """``w`` (gathered over the batch axes) cut to this rank's
        :meth:`chunk` of its dimension ``dim`` (``n`` long), which the
        rank's product reads: its shard where it lies split, else a
        slice of the whole (the gradient summed over ``model``)."""
        if self.m == 1 or w.shape[dim] * self.m == n:
            return w
        lo, hi = self.chunk(n)
        return self.comm.copy_to(w, AXIS).narrow(dim, lo, hi - lo)

    def gather_chunks(self, y: torch.Tensor, n: int, dim: int,
                      grad: str = "sum") -> torch.Tensor:
        """Every rank's :meth:`chunk` of a dimension of ``n``, ``y`` this
        rank's, all-gathered along ``dim`` (each padded to ``ceil(n /
        m)`` for the transfer): the whole dimension.  ``grad`` as
        ``MeshComm.gather_along``'s."""
        if self.m == 1:
            return y
        dim %= y.dim()
        pad = -(-n // self.m) - y.shape[dim]
        if pad:
            shape = list(y.shape)
            shape[dim] = pad
            y = torch.cat([y, y.new_zeros(shape)], dim)
        return self.comm.gather_along(y, AXIS, dim, grad=grad).narrow(
            dim, 0, n)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model``, and its gradient too (JAX's
        ``psum``): partial sums whose total each rank reads for a part
        of its own."""
        c = self.comm
        return c.copy_to(c.reduce_from(x, AXIS), AXIS) if self.m > 1 else x

    def head_group(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """(q heads, kv heads) of this rank's group where the q heads do
        not divide the axis: ``gcd(heads, m)`` groups of consecutive
        heads, group ``j // (m / gcd)`` this rank's; every head where a
        group's heads would not read whole kv-head groups."""
        h, g = self.cfg.n_heads, self.cfg.n_heads // self.cfg.n_kv_heads
        n = math.gcd(h, self.m)
        q0 = self.j // (self.m // n) * (h // n)
        q1 = q0 + h // n
        if q0 // g != (q1 - 1) // g and (q0 % g or (q1 - q0) % g):
            q0, q1 = 0, h
        return (q0, q1), (q0 // g, (q1 - 1) // g + 1)

    def head(self, embed: torch.Tensor, lm_head: Optional[torch.Tensor]
             ) -> torch.Tensor:
        """The ``[d, V]`` output projection's columns of this rank's
        vocabulary (all of them where the vocabulary does not divide the
        axis): ``lm_head`` as it lies, or the tied embedding exchanged
        from its ``[V, d / m]`` shard into ``[V / m, d]``.  Under
        ``head_rows`` the ``[d / m, V]`` rows of the rank's ``d`` slice,
        as the embedding lies."""
        v, s = self.cfg.vocab_size, self.vocab_split
        if lm_head is not None:
            return self.relayout(lm_head, 1, v, s, s)
        if self.head_rows:
            return embed.T
        return self.relayout(embed, 1, self.cfg.d_model, s, s,
                             want_dim=0).T

    # -- activations ------------------------------------------------------
    def site(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The collective at constrain site ``name`` (module docstring's
        table) applied to its producer's ``x``."""
        c = self.comm
        if self.m == 1:
            return x
        if name in ("attn.in", "attn.out"):
            split = self.q_split
        elif name in ("mlp.in", "mlp.out"):
            split = self.ff_split
        elif name in ("moe.in", "moe.out"):
            split = self.moe_split
        elif name in ("front.in", "front.out"):
            split = self.front_split
        elif name == "head.in":
            if self.head_rows:
                return c.copy_to(x, AXIS).chunk(self.m, -1)[self.j]
            split = self.vocab_split
        elif name == "head.out":
            return c.reduce_from(x, AXIS) if self.head_rows else x
        elif name == "embed":
            if x.shape[-1] == self.cfg.d_model:
                return x
            return c.gather_along(x, AXIS, x.dim() - 1, grad="slice")
        else:
            raise KeyError(f"no constrain site {name!r}")
        if not split:
            return x
        return c.copy_to(x, AXIS) if name.endswith(".in") \
            else c.reduce_from(x, AXIS)

    def vocab_range(self) -> Tuple[int, int]:
        """[v0, v1): the vocabulary entries of this rank's logits."""
        v = self.cfg.vocab_size
        if not self.vocab_split:
            return 0, v
        return self.j * v // self.m, (self.j + 1) * v // self.m

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The head's logits gathered whole where they are vocab-parallel
        (no gradient: the serving steps' outputs)."""
        if not self.vocab_split:
            return logits
        return self.comm.all_gather(logits, AXIS, logits.dim() - 1)

    def all_heads(self, q: torch.Tensor) -> torch.Tensor:
        """A decode step's q ``[b, 1, heads, hd]`` gathered over every
        head (no gradient)."""
        if not self.q_split:
            return q
        return self.comm.all_gather(q, AXIS, 2)

    def own_heads(self, out: torch.Tensor) -> torch.Tensor:
        """This rank's q heads of an output over every head."""
        q0, q1 = self.q_heads
        return out[:, :, q0:q1] if self.q_split else out

    def cache_layout(self, cache) -> Tuple[int, int, int]:
        """(first slot, whole slot count, first kv head) of this rank's
        shard of an attention cache: ``pos`` holds every slot (its spec
        splits the batch only), ``k``/``v`` the rank's slots or heads."""
        s = cache["pos"].shape[1]
        s_loc, k_loc = cache["k"].shape[1:3]
        s0 = self.j * s_loc if s_loc < s else 0
        h0 = self.j * k_loc if k_loc < self.cfg.n_kv_heads else 0
        return s0, s, h0

    def merge_softmax(self, m: torch.Tensor, l: torch.Tensor,
                      o: torch.Tensor) -> torch.Tensor:
        """Attention over slots split by rank: each rank's running max
        ``m`` and sum ``l`` of its exponentials (``[..., t, 1]``) and its
        unnormalised output ``o`` (``[..., t, hd]``), merged by their
        log-sum-exp (no gradient)."""
        c = self.comm
        top = c.all_gather(m, AXIS, m.dim() - 1).amax(-1, keepdim=True)
        scale = torch.exp(m - top)
        num = c.all_reduce(o * scale, [AXIS])
        den = c.all_reduce(l * scale, [AXIS])
        return num / den


_CURRENT: List[TensorParallel] = []


@contextlib.contextmanager
def use(tp: TensorParallel) -> Iterator[TensorParallel]:
    """Make ``tp`` the layers' program inside the block."""
    _CURRENT.append(tp)
    try:
        yield tp
    finally:
        _CURRENT.pop()


def current() -> Optional[TensorParallel]:
    """The program of the innermost :func:`use` block, or None."""
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def layer(block) -> Iterator:
    """Inside the block ``block`` (one layer) holds its parameters as the
    current program reads them: gathered over the batch axes at the
    layer's turn and dropped after it (``TensorParallel.gather_layer``,
    which ``sharded.ShardedModel.running`` sets); as they lie outside a
    program."""
    tp = current()
    if tp is None or tp.gather_layer is None:
        yield
    else:
        with tp.gather_layer(block):
            yield


def site(name: str, x: torch.Tensor) -> torch.Tensor:
    """:meth:`TensorParallel.site` of the current program; the identity
    outside one."""
    tp = current()
    return x if tp is None else tp.site(name, x)


def dot(x: torch.Tensor, w: torch.Tensor,
        n_out: Optional[int] = None) -> torch.Tensor:
    """``x @ w`` (``w`` cast to ``x``'s type) as this rank computes it.
    Where the current program's ``fsdp_split`` holds, ``w`` lies split
    over 'data' as at rest (its rows where they are fewer than ``x``'s
    columns, else its columns where fewer than ``n_out``), and so does the
    product, as GSPMD partitions the reference's when the batch leaves
    'data' idle: the rank's slice of the contraction, the partial sums
    all-reduced over 'data', or its columns of the output, all-gathered
    (no gradient: decode steps only)."""
    w = w.to(x.dtype)
    tp = current()
    if tp is None or not tp.fsdp_split:
        return x @ w
    c, k = tp.comm, w.shape[0]
    if k < x.shape[-1]:
        i = c.index(FSDP_AXIS)
        return c.all_reduce(x[..., i * k:(i + 1) * k] @ w, [FSDP_AXIS])
    y = x @ w
    if n_out is not None and y.shape[-1] < n_out:
        y = c.all_gather(y, FSDP_AXIS, y.dim() - 1)
    return y


def embed_rows(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (of the rank's ``d`` shard): under
    ``fsdp_split`` an embedding whose vocabulary lies split over 'data'
    gives its own tokens' rows, summed over 'data'."""
    tp = current()
    v = embed.shape[0]
    if tp is None or not tp.fsdp_split or v == tp.cfg.vocab_size:
        return embed[tokens]
    local = tokens - tp.comm.index(FSDP_AXIS) * v
    mine = ((local >= 0) & (local < v))[..., None]
    rows = torch.where(mine, embed[local.clamp(0, v - 1)], 0)
    return tp.comm.all_reduce(rows, [FSDP_AXIS])


def attn_weights(p, cfg: ModelConfig) -> WholeAttnWeights:
    """An attention layer's weights as this rank reads them
    (:class:`AttnWeights`); every head (:class:`WholeAttnWeights`)
    outside the program."""
    tp = current()
    return WholeAttnWeights(cfg, p) if tp is None else AttnWeights(tp, p)


def mlp_weights(p):
    """An MLP's (w_up, w_gate, w_down) as this rank reads them: its hidden
    units' columns and rows (every rank's at rest already)."""
    tp = current()
    gate = p.w_gate if "w_gate" in p else None
    if tp is None:
        return p.w_up, gate, p.w_down
    f, s = tp.cfg.d_ff, tp.ff_split
    return (tp.relayout(p.w_up, 1, f, s, s),
            None if gate is None else tp.relayout(gate, 1, f, s, s),
            tp.relayout(p.w_down, 0, f, s, s))


def frontend_weights(p):
    """A vlm projector's (proj1, proj2) as this rank reads them: its
    columns of ``proj1`` and rows of ``proj2`` (every rank's at rest
    already), like an MLP's hidden units."""
    tp = current()
    if tp is None:
        return p.proj1, p.proj2
    d, s = tp.cfg.d_model, tp.front_split
    return (tp.relayout(p.proj1, 1, d, s, s),
            tp.relayout(p.proj2, 0, d, s, s))


def moe_weights(p, tp: Optional[TensorParallel] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """A MoE layer's ``(w_gate, w_up, w_down, first expert)`` as a rank of
    ``tp`` (the current program by default) computes them: its ``e / m``
    experts, which lie here already (``moe_specs`` puts the experts over
    ``model``), or all of them where ``m`` does not divide ``e``; all of
    them, from expert 0, outside a program."""
    tp = tp or current()
    if tp is None:
        return p.w_gate, p.w_up, p.w_down, 0
    e, s = tp.cfg.moe.n_experts, tp.moe_split
    ws = [tp.relayout(w, 0, e, s, s) for w in (p.w_gate, p.w_up, p.w_down)]
    return (*ws, tp.j * ws[0].shape[0] if s else 0)


def head_weight(model) -> torch.Tensor:
    """The model's ``[d, V]`` output projection, this rank's vocabulary
    columns inside the program."""
    tp = current()
    if tp is None:
        return model.head()
    top = model.top
    return tp.head(top.embed, top.lm_head if "lm_head" in top else None)
