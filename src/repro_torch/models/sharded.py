"""The LM stack placed on a mesh: parameters and AdamW moments as DTensor
shards, and the programs that run on them.

The JAX package shards its parameters with ``NamedSharding`` and lets
GSPMD partition the train step.  Here every parameter lives, at rest, as
this rank's shard of it (a DTensor over the ``(data, model)`` or ``(pod,
data, model)`` mesh, placed by the sanitized specs of
``transformer.param_specs``), and so do the optimizer's moments
(``AdamW.state_specs``).  The step is an explicit program on each rank,
JAX's "FSDP (over 'data') x TP (over 'model')" (:func:`program`,
``"fsdp_tp"``, for every config of the registry).  Each parameter is
all-gathered over the batch axes only and keeps its shard along
``model``, one FSDP unit at a time as GSPMD gathers JAX's scanned layer
units (:meth:`ShardedModel.running`): the top-level parameters for the
step, each layer's just before the layer runs, dropped after it, and with
remat gathered again by the recomputation in the backward; a unit's
parameters of one type and split travel as one flat buffer.  The rank
runs forward and backward on its batch shard through
its own q heads, MLP hidden units, experts, recurrent channels, SSM heads
and vocabulary entries, with the collective each of the reference's
constrain sites implies (``models/tensor_parallel.py``), the loss a
vocab-parallel cross-entropy where the vocabulary divides the axis
(:class:`_VocabNLL`: max and sum all-reduced over ``model``, the gold
logit from its owner, a backward that never forms the whole logits).
Each gradient is then the rank's ``model`` slice already: the gather's
backward sums a unit's gradients over the batch axes (a reduce-scatter
where they split them, one flat buffer) onto the rank's shards while the
backward runs, so no rank holds its whole slice's gradients.

The loss is the sum of the rank's tokens' negative log-likelihoods over
the global token count, plus the layers' aux losses over the number of
batch shards (the batch split over the batch axes by
``batch_partition_spec``); the global gradient norm comes from the shards
(one all-reduce of a scalar, each shard counted once), and AdamW updates
the rank's shards of the parameters and moments in place.  So the loss
and the update are the single-process step's on the whole batch, up to
the order of the sums.  A MoE layer routes the whole batch as the
reference does, whatever ``moe_dispatch_groups`` is (``models/moe.py``):
its slots, capacity, drops and aux losses are the global batch's, the
same on every rank, so the aux losses over the batch shards, with their
gradients summed over the batch axes, are the aux losses once.

Serving (:func:`sharded_prefill`, :func:`make_sharded_decode_step`) runs
the same program without gradients on the rank's shards of the caches
(``transformer.cache_specs``), in place: a cache split by sequence is
attended slot-shard by slot-shard and merged (``attention.attn_decode``),
a recurrent or SSM state is the rank's channels or heads, or whole where
they do not divide the axis; a decode step's tied head all-reduces one
token's partial logits rather than move the embedding.  The logits they
return are whole.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..launch.mesh import (batch_partition_spec, local_chunk, local_shape,
                           mesh_comm, mesh_sizes, sanitized_placements)
from . import lm
from . import tensor_parallel
from . import transformer as tf
from .common import BATCH_AXES, MODEL_AXIS
from .config import ModelConfig

__all__ = ["ShardedModel", "program", "place_batch", "sharded_loss",
           "make_sharded_train_step", "cache_shards",
           "sharded_prefill", "make_sharded_decode_step"]


def program(cfg: ModelConfig) -> str:
    """The program ``cfg`` runs on a mesh: ``"fsdp_tp"`` (module
    docstring), for every config ``tensor_parallel.supported`` takes; any
    other raises (no other program runs on a mesh)."""
    if not tensor_parallel.supported(cfg):
        raise ValueError(f"{cfg.name}: no tensor-parallel program for "
                         f"layers {cfg.pattern!r}, frontend "
                         f"{cfg.frontend!r}")
    return "fsdp_tp"


def _dtensor(local: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = []
    acc = 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


class ShardedModel:
    """A :class:`~repro_torch.models.transformer.Transformer` placed on
    ``mesh``: ``local`` is the model holding this rank's shard of every
    parameter (plain tensors), ``placements`` and ``shapes`` each
    parameter's DTensor placements and whole shape, by name.
    :meth:`named_parameters` gives the DTensors (views of the shards)."""

    def __init__(self, local: tf.Transformer, mesh, placements: Dict,
                 shapes: Dict):
        self.local = local
        self.cfg = local.cfg
        self.mesh = mesh
        self.placements = placements
        self.shapes = shapes
        self.comm = mesh_comm(mesh, local.device)
        self.program = program(self.cfg)
        self._index = {id(b): i for i, b in enumerate(local.layers)}
        self._units: Dict[str, list] = {}

    @classmethod
    def init(cls, cfg: ModelConfig, mesh, *, seed: int = 0, device=None,
             specs: Optional[Dict] = None,
             dtype: Optional[torch.dtype] = None,
             uninitialised: bool = False) -> "ShardedModel":
        """``tf.init_params(cfg, seed)``'s values, each parameter cut to
        this rank's shard (cast to ``dtype`` where given) as soon as its
        layer is drawn, placed by the sanitized ``specs`` (default
        ``transformer.param_specs``).

        With ``uninitialised`` the draws are made on the CPU and each shard
        is left uninitialised on ``device``: the shapes, types and
        placements are the same.  That is for ``FakeTensorMode`` (the dry
        run, ``launch/dryrun.py``), where nothing is drawn or allocated
        and a fake tensor cannot move between devices."""
        specs = specs or tf.param_specs(cfg)
        placements, shapes = {}, {}

        def keep(name, t):
            shapes[name] = tuple(t.shape)
            placements[name] = sanitized_placements(
                {name: specs[name]}, {name: t}, mesh)[name]
            part = local_chunk(t, placements[name], mesh)
            dt = dtype if dtype is not None else t.dtype
            if uninitialised:
                return part.new_empty(part.shape, dtype=dt, device=device)
            return part.to(dt, copy=True)

        local = tf.init_params(cfg, seed=seed,
                               device="cpu" if uninitialised else device,
                               keep=keep)
        return cls(local, mesh, placements, shapes)

    @classmethod
    def place(cls, model: tf.Transformer, mesh,
              specs: Optional[Dict] = None) -> "ShardedModel":
        """``model`` (whole on every rank) cut to this rank's shards, by
        ``specs`` sanitized on the mesh, as :meth:`init` places them (the
        reference's ``sanitized_shardings``: an axis that does not divide
        a dimension leaves it whole)."""
        specs = specs or tf.param_specs(model.cfg)
        named = dict(model.named_parameters())
        placements = sanitized_placements(specs, named, mesh)
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        keep = {n: local_chunk(p.data, placements[n], mesh).clone()
                for n, p in named.items()}
        local = _rebuilt(model, keep)
        return cls(local, mesh, placements, shapes)

    # -- views ------------------------------------------------------------
    def local_named(self) -> Dict[str, torch.Tensor]:
        return dict(self.local.named_parameters())

    def named_parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, DTensor) for every parameter: the rank's shard, placed."""
        for n, p in self.local.named_parameters():
            yield n, _dtensor(p.data, self.mesh, self.placements[n],
                              self.shapes[n])

    def placed_like(self, local: Dict[str, torch.Tensor]) -> Dict:
        """Shards shaped like the parameters' (moments) as DTensors."""
        return {n: _dtensor(t, self.mesh, self.placements[n],
                            self.shapes[n]) for n, t in local.items()}

    def local_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.local.parameters())

    # -- whole parameters ---------------------------------------------------
    def gather(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by name (collective)."""
        return {n: self.comm.gather_full(p.data, self.placements[n])
                for n, p in self.local.named_parameters()}

    def step_placements(self, name: str) -> tuple:
        """What the step gathers of parameter ``name``: its placements
        over the batch axes (the ``model`` shard is kept)."""
        pl = self.placements[name]
        other, batch = _split(pl, self.mesh, _batch_axes(self.mesh))
        if {p.dim for p in other if p.is_shard()} \
                & {p.dim for p in batch if p.is_shard()}:
            raise ValueError(f"{name}: a dimension split over a batch axis "
                             "and model at once has no model slice to keep")
        return batch

    def _unit(self, prefix: str) -> list:
        """The parameters of one FSDP unit (``prefix`` a layer's
        ``"layers.i."``, or ``""`` the top level: every other one) by
        group, one flat buffer each (type, and the batch axes that split
        them): ``[[(owner module, leaf, step placements), ...], ...]``."""
        if prefix not in self._units:
            groups: Dict = {}
            axes = _batch_axes(self.mesh)
            for n, p in self.local.named_parameters():
                if (n.startswith(prefix) if prefix
                        else not n.startswith("layers.")):
                    pl = self.step_placements(n)
                    key = (p.dtype, tuple(self.comm.split_axes([pl], axes)))
                    groups.setdefault(key, []).append(
                        (*_owner(self.local, n), pl))
            self._units[prefix] = list(groups.values())
        return self._units[prefix]

    @contextlib.contextmanager
    def _gathered(self, prefix: str):
        """Inside the block the parameters of the unit ``prefix``
        (:meth:`_unit`) are whole over the batch axes in place of their
        shards (one all-gather a group, ``MeshComm.gather_params``: where
        the shards require gradients, its backward sums each gradient
        over the batch axes onto its shard); the shards are put back after
        it, and the gathered ones dropped."""
        axes = _batch_axes(self.mesh)
        kept = []
        try:
            for group in self._unit(prefix):
                shards = [owner._parameters[leaf] for owner, leaf, _ in group]
                whole = self.comm.gather_params(
                    shards, [pl for _, _, pl in group], axes)
                for (owner, leaf, _), shard, t in zip(group, shards, whole):
                    kept.append((owner, leaf, shard))
                    owner._parameters[leaf] = t
            yield
        finally:
            for owner, leaf, shard in kept:
                owner._parameters[leaf] = shard

    def _layer_gather(self, block):
        return self._gathered(f"layers.{self._index[id(block)]}.")

    @contextlib.contextmanager
    def running(self, train: bool = False, decode: bool = False,
                batch_split: bool = True):
        """Inside the block ``self.local`` runs the program on this rank:
        the layers' collectives are those of ``tensor_parallel.use``'s
        program (a ``decode`` step's where it is one; ``batch_split``:
        the layers' tokens are the rank's part of a batch split over the
        batch axes, not the whole batch), and the parameters are gathered
        over the batch axes only (:meth:`step_placements`), FSDP's way,
        one unit at a time: the top-level ones (embedding, final norm,
        head, frontend) for the whole block, each layer's at its turn
        (``tensor_parallel.layer``: just before the layer runs, dropped
        after it; inside a train step's ``checkpoint``, so that the
        recomputation in the backward gathers it again).  With ``train``
        the shards require gradients and each gather's backward sums a
        unit's gradients over the batch axes onto them while the backward
        runs (:meth:`take_grads`).  A decode step whose rows the batch
        axes do not split gathers nothing: its products are partitioned
        over 'data' instead (``TensorParallel.fsdp_split``).  Yields the
        program."""
        tp = tensor_parallel.TensorParallel(self.cfg, self.comm, decode,
                                            batch_split)
        if not tp.fsdp_split:
            tp.gather_layer = self._layer_gather
        shards = list(self.local.parameters())
        for p in shards:
            p.grad = None
            p.requires_grad_(train)
        try:
            with tensor_parallel.use(tp), (
                    contextlib.nullcontext() if tp.fsdp_split
                    else self._gathered("")):
                yield tp
        finally:
            for p in shards:
                p.requires_grad_(False)

    def take_grads(self) -> Dict[str, torch.Tensor]:
        """Each shard's gradient from the last :meth:`running` block with
        ``train`` (zeros where none arrived), by name; the shards'
        ``.grad`` cleared."""
        out = {}
        for n, p in self.local.named_parameters():
            out[n] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        return out


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def _rebuilt(model: tf.Transformer, tensors: Dict[str, torch.Tensor]
             ) -> tf.Transformer:
    """A model of ``model``'s structure holding ``tensors`` (by name)."""
    import copy
    # the structure copied, the parameters left out (set below)
    out = copy.deepcopy(model, memo={id(p): None for p in
                                     model.parameters()})
    for n, t in tensors.items():
        owner, leaf = _owner(out, n)
        owner.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    return out


def _batch_axes(mesh):
    return [a for a in BATCH_AXES if a in mesh_sizes(mesh)]


def _split(placements, mesh, axes):
    """``placements`` as (those of the axes outside ``axes``, those of
    ``axes``), the rest ``Replicate()`` in each."""
    from torch.distributed.tensor import Replicate
    names = list(mesh_sizes(mesh))
    other = tuple(Replicate() if a in axes else pl
                  for a, pl in zip(names, placements))
    batch = tuple(pl if a in axes else Replicate()
                  for a, pl in zip(names, placements))
    return other, batch


def _replicas(placements, mesh) -> int:
    """How many ranks hold each shard (the sizes of the axes that do not
    split the tensor)."""
    sizes = list(mesh_sizes(mesh).values())
    return math.prod(n for n, pl in zip(sizes, placements)
                     if not pl.is_shard())


def _splits(rows: int, mesh) -> bool:
    """Whether a whole batch of ``rows`` is split over the batch axes."""
    return batch_partition_spec(rows, mesh)[0] is not None


def _rows_split(cache_placements, mesh) -> bool:
    """Whether caches under ``cache_placements`` hold the rank's part of a
    batch split over the batch axes (their rows are: every cache tensor's
    spec splits its rows alike)."""
    names = list(mesh_sizes(mesh))
    first = next(iter(cache_placements[0].values()))
    return any(pl.is_shard() and pl.dim == 0 and a in BATCH_AXES
               for a, pl in zip(names, first))


def place_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict:
    """This rank's shard of a whole batch (every rank holds the same one),
    cut along the batch dimension by ``batch_partition_spec``."""
    from ..launch.mesh import placements_of
    out = {}
    for k, v in batch.items():
        spec = batch_partition_spec(v.shape[0], mesh,
                                    (None,) * (v.dim() - 1))
        out[k] = local_chunk(v, placements_of(spec, mesh), mesh)
    return out


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """(sum of the negative log-likelihoods, count) of the labelled
    tokens (``lm.cross_entropy``'s numerator and denominator)."""
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


class _VocabNLL(torch.autograd.Function):
    """Per-token negative log-likelihood of vocab-parallel logits (this
    rank's ``[..., V / m]``): the max gathered and the sum of
    exponentials all-reduced over ``model``, the gold logit all-reduced
    from the rank that holds it.  Backward gives the rank's slice of
    ``softmax - onehot``: no rank forms the whole logits."""

    @staticmethod
    def forward(ctx, logits, gold, owned, comm):
        last = logits.dim() - 1
        top = comm.all_gather(logits.amax(-1, keepdim=True), MODEL_AXIS,
                              last).amax(-1)
        total = comm.all_reduce(torch.exp(logits - top[..., None]).sum(-1),
                                [MODEL_AXIS])
        logz = top + torch.log(total)
        mine = torch.take_along_dim(logits, gold[..., None], -1)[..., 0]
        gold_logit = comm.all_reduce(mine * owned, [MODEL_AXIS])
        ctx.save_for_backward(logits, logz, gold, owned)
        return logz - gold_logit

    @staticmethod
    def backward(ctx, g):
        logits, logz, gold, owned = ctx.saved_tensors
        grad = torch.exp(logits - logz[..., None])
        grad.scatter_add_(-1, gold[..., None], -owned[..., None])
        return grad * g[..., None], None, None, None


def _vocab_nll(logits: torch.Tensor, labels: torch.Tensor, tp,
               ignore: int = -1):
    """:func:`_nll` of vocab-parallel logits (``tp``'s vocabulary
    slice)."""
    mask = labels != ignore
    v0, v1 = tp.vocab_range()
    owned = mask & (labels >= v0) & (labels < v1)
    gold = torch.where(owned, labels - v0, 0).long()
    nll = _VocabNLL.apply(logits, gold, owned.to(logits.dtype), tp.comm)
    return (nll * mask).sum(), mask.sum()


def _local_loss(model: tf.Transformer, batch: Dict, cfg: ModelConfig,
                comm, axes) -> Tuple[torch.Tensor, Dict]:
    """The rank's share of the global loss (its tokens' NLL sum over the
    global count, plus the aux losses over the number of batch shards:
    a MoE layer's are the global batch's on every rank, so the shards'
    shares sum to them once, and so do their gradients, summed over the
    batch axes) and the global metrics; vocab-parallel inside the
    tensor-parallel program."""
    inputs, labels = lm._shift_batch(batch, cfg)
    logits, _, aux = tf.forward(model, inputs, cfg)
    tp = tensor_parallel.current()
    nll, count = _vocab_nll(logits, labels, tp) \
        if tp is not None and tp.vocab_split else _nll(logits, labels)
    n_tok = torch.clamp(comm.all_reduce(count.float(), axes), min=1)
    shards = math.prod(comm.size(a) for a in axes)
    total = nll / n_tok + aux["aux"] / shards
    metrics = {"loss": comm.all_reduce(nll.detach(), axes) / n_tok,
               "aux": comm.all_reduce(aux["aux"].detach(), axes, "mean"),
               "dropped": comm.all_reduce(aux["dropped"].detach(), axes,
                                          "mean")}
    return total, metrics


def sharded_loss(sm: ShardedModel, batch: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """``lm.loss_fn`` of the placed model on the whole ``batch`` (every
    rank passes the same one; each computes on its shard), without
    gradients: (loss with the aux losses, metrics), equal on every
    rank."""
    axes = _batch_axes(sm.mesh)
    split = _splits(next(iter(batch.values())).shape[0], sm.mesh)
    with torch.no_grad(), sm.running(batch_split=split):
        total, metrics = _local_loss(sm.local, place_batch(batch, sm.mesh),
                                     cfg, sm.comm, axes)
    return metrics["loss"] + metrics["aux"], metrics


def make_sharded_train_step(cfg: ModelConfig, optimizer) -> Callable:
    """Returns ``train_step(sm, opt_state, batch, placed=False) -> (sm,
    opt_state, metrics)`` for a :class:`ShardedModel`: ``opt_state``
    holds this rank's shards of the moments (``optimizer.init(sm.local)``)
    and ``batch`` the whole batch (every rank the same), or with
    ``placed`` this rank's part of it split over the batch axes
    (:func:`place_batch`'s of a batch they divide).  Updates
    the shards in place; the metrics (``loss``, ``aux``, ``dropped``,
    ``grad_norm``) are global."""

    def train_step(sm: ShardedModel, opt_state: Dict, batch: Dict,
                   placed: bool = False):
        axes = _batch_axes(sm.mesh)
        local_batch = batch if placed else place_batch(batch, sm.mesh)
        split = placed or _splits(next(iter(batch.values())).shape[0],
                                  sm.mesh)
        with sm.running(train=True, batch_split=split):
            total, metrics = _local_loss(sm.local, local_batch, cfg,
                                         sm.comm, axes)
            total.backward()
        del total
        mine = sm.take_grads()
        # each shard's square counted once over the ranks that hold it
        sq = sum(torch.sum(torch.square(g.float()))
                 / _replicas(sm.placements[n], sm.mesh)
                 for n, g in mine.items())
        gnorm = torch.sqrt(sm.comm.all_reduce(sq, sm.comm.names))
        opt_state = optimizer.apply(sm.local_named(), mine, opt_state,
                                    gnorm=gnorm)
        metrics["grad_norm"] = optimizer.last_grad_norm(opt_state)
        return sm, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serving on a mesh: prefill and decode, in the train step's program
# ---------------------------------------------------------------------------
def cache_shards(cfg: ModelConfig, batch: int, max_len: int, mesh,
                 dtype: torch.dtype = torch.bfloat16, device=None
                 ) -> Tuple[list, list]:
    """This rank's shard of ``transformer.init_cache(cfg, batch, max_len)``
    placed by the sanitized ``transformer.cache_specs``: (the shards, their
    placements), one dict each a layer."""
    full = tf.init_cache(cfg, batch, max_len, dtype, device=device)
    placements = sanitized_placements(tf.cache_specs(cfg), full, mesh)
    shards = [{k: local_chunk(v, placements[i][k], mesh).clone()
               for k, v in c.items()} for i, c in enumerate(full)]
    return shards, placements


def _empty_shards(cfg: ModelConfig, batch: int, max_len: int, placements,
                  mesh, dtype: torch.dtype, device) -> list:
    """This rank's shards of a fresh cache for its ``batch`` rows under
    ``placements`` (attention layers' zeros, positions -1, in ``dtype``;
    recurrent states float32 zeros), allocated at the shard's size only
    (``transformer.init_cache``'s shapes)."""
    sizes = list(mesh_sizes(mesh).values())
    first = next(iter(placements[0].values()))
    rows = batch * math.prod(n for n, pl in zip(sizes, first)
                             if pl.is_shard() and pl.dim == 0)
    out = []
    for kind, pl in zip(cfg.pattern, placements):
        shards = {}
        for k, (shape, dt) in _cache_shapes(cfg, kind, rows, max_len,
                                            dtype).items():
            shape = local_shape(shape, pl[k], mesh)
            shards[k] = (torch.full(shape, -1, dtype=dt, device=device)
                         if k == "pos" else
                         torch.zeros(shape, dtype=dt, device=device))
        out.append(shards)
    return out


def _cache_shapes(cfg: ModelConfig, kind: str, rows: int, max_len: int,
                  dtype: torch.dtype) -> Dict:
    """(whole shape, type) of each tensor of one layer's cache, as
    ``transformer.init_cache`` makes it, without making it (a dry run
    would count the whole cache)."""
    from . import rglru, ssm
    from .attention import cache_len
    f32 = torch.float32
    if kind in ("g", "l"):
        s = cache_len(cfg, kind, max_len)
        kv = (rows, s, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": (kv, dtype), "v": (kv, dtype),
                "pos": ((rows, s), torch.int32)}
    if kind == "r":
        w = rglru._w(cfg)
        return {"h": ((rows, w), f32),
                "conv": ((rows, rglru._CONV_W - 1, w), f32)}
    s, di, nh = ssm._dims(cfg)
    return {"ssm": ((rows, nh, s.d_state, s.head_dim), f32),
            "conv": ((rows, s.d_conv - 1, di + 2 * s.d_state), f32)}


def sharded_prefill(sm: ShardedModel, batch: Dict, cfg: ModelConfig,
                    max_len: int, cache_placements=None,
                    cache_dtype: torch.dtype = torch.bfloat16):
    """``lm.prefill`` of the placed model on ``batch``, this rank's shard
    of the batch (:func:`place_batch`'s), the parameters gathered as in
    the train step, without gradients.  Returns (last-token logits, whole,
    the rank's cache shards under ``cache_placements``
    (:func:`cache_shards`'), written in place by the layers, the next
    position).  An encoder has no cache (``cache_placements`` unused):
    its ``transformer.forward`` logits, whole."""
    if cfg.is_encoder:
        with torch.no_grad(), sm.running() as tp:
            return tp.whole_logits(tf.forward(sm.local, batch, cfg)[0])
    rows = next(iter(batch.values())).shape[0]
    t = sum(v.shape[1] for k, v in batch.items()
            if k in ("tokens", "patches"))
    split = _rows_split(cache_placements, sm.mesh)
    with torch.no_grad(), sm.running(batch_split=split) as tp:
        caches = _empty_shards(cfg, rows, max_len, cache_placements,
                               sm.mesh, cache_dtype, sm.local.device)
        logits, caches, _ = tf.forward(sm.local, batch, cfg, caches=caches)
        last = tp.whole_logits(logits[:, -1])
    return last, caches, t


def make_sharded_decode_step(cfg: ModelConfig) -> Callable:
    """Returns ``decode_step(sm, token, caches, cache_placements, pos) ->
    (logits, caches)``: one token of this rank's batch shard (``token``
    [b, 1], the rank's rows) with the rank's cache shards
    (:func:`cache_shards`), which the step updates in place; the logits
    whole."""
    step = lm.make_decode_step(cfg)

    @torch.no_grad()
    def decode_step(sm: ShardedModel, token: torch.Tensor, caches: list,
                    cache_placements: list, pos):
        with sm.running(decode=True, batch_split=_rows_split(
                cache_placements, sm.mesh)) as tp:
            logits, caches = step(sm.local, token, caches, pos)
            return tp.whole_logits(logits), caches

    return decode_step
