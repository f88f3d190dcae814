"""The LM stack placed on a mesh: parameters and AdamW moments as DTensor
shards, and the train step that runs on them.

The JAX package shards its parameters with ``NamedSharding`` and lets
GSPMD partition the train step.  Here every parameter lives, at rest, as
this rank's shard of it (a DTensor over the ``(data, model)`` or ``(pod,
data, model)`` mesh, placed by the sanitized specs of
``transformer.param_specs``), and so do the optimizer's moments
(``AdamW.state_specs``).  The step is an explicit program on each rank
(ZeRO-3 over the whole mesh):

1. each parameter is all-gathered whole from its shards;
2. the rank runs forward and backward on its shard of the batch (the
   batch dimension split over the batch axes by ``batch_partition_spec``,
   whole on the model axis), its loss the sum of its tokens' negative
   log-likelihoods over the global token count, plus the layers' aux
   losses over the number of batch shards;
3. each rank cuts every gradient to its shard along the other axes (the
   model axis computed the same gradients), sums that over the batch axes
   and keeps its shard of the sum; the global gradient norm comes from
   the shards (one all-reduce of a scalar);
4. AdamW updates the rank's shards of the parameters and moments in place.

So the loss and the update are the single-process step's on the whole
batch, up to the order of the sums.  A MoE layer's aux loss and capacity
are, as with the reference's ``moe_dispatch_groups`` set to the batch
shards, those of each shard's tokens.  The gathered parameters are freed
after the step: between steps no rank holds a whole copy of a sharded
parameter.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..launch.mesh import (batch_partition_spec, local_chunk, mesh_comm,
                           mesh_sizes, sanitized_placements)
from . import lm
from . import transformer as tf
from .common import BATCH_AXES
from .config import ModelConfig

__all__ = ["ShardedModel", "place_batch", "sharded_loss",
           "make_sharded_train_step", "model_slice"]


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

    @classmethod
    def init(cls, cfg: ModelConfig, mesh, *, seed: int = 0, device=None,
             specs: Optional[Dict] = None,
             dtype: Optional[torch.dtype] = None) -> "ShardedModel":
        """``tf.init_params(cfg, seed)``'s values, each parameter cut to
        this rank's shard (cast to ``dtype`` where given) as soon as its
        layer is drawn, placed by the sanitized ``specs`` (default
        ``transformer.param_specs``)."""
        specs = specs or tf.param_specs(cfg)
        placements, shapes = {}, {}

        def keep(name, t):
            shapes[name] = tuple(t.shape)
            placements[name] = sanitized_placements(
                {name: specs[name]}, {name: t}, mesh)[name]
            part = local_chunk(t, placements[name], mesh)
            return part.to(dtype if dtype is not None else t.dtype,
                           copy=True)

        local = tf.init_params(cfg, seed=seed, device=device, keep=keep)
        return cls(local, mesh, placements, shapes)

    @classmethod
    def place(cls, model: tf.Transformer, mesh,
              specs: Optional[Dict] = None) -> "ShardedModel":
        """``model`` (whole on every rank) cut to this rank's shards, by
        ``specs`` filtered to the mesh's axes (the reference's
        ``shardings_for``: every sharded dimension must divide)."""
        from ..launch.mesh import placements_for
        specs = specs or tf.param_specs(model.cfg)
        named = dict(model.named_parameters())
        placements = placements_for(specs, mesh)
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

    @contextlib.contextmanager
    def gathered(self, requires_grad: bool = False):
        """Inside the block ``self.local`` holds every parameter whole
        (gathered, collective); the shards are put back after it, and the
        whole ones dropped.  Yields the whole parameters by name."""
        shards = {}
        full = self.gather()
        for n, t in full.items():
            owner, leaf = _owner(self.local, n)
            shards[n] = owner._parameters[leaf]
            owner.register_parameter(leaf, nn.Parameter(
                t, requires_grad=requires_grad))
        try:
            yield dict(self.local.named_parameters())
        finally:
            for n, p in shards.items():
                owner, leaf = _owner(self.local, n)
                owner.register_parameter(leaf, p)


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


def model_slice(g: torch.Tensor, placements, mesh, axes) -> torch.Tensor:
    """The piece of ``g`` (a whole gradient) this rank keeps along the
    mesh axes outside ``axes`` (the batch axes): what it sums over the
    batch axes.  A tensor dimension split by a batch axis and another one
    at once is kept whole (it cannot be cut before the sum)."""
    other, batch = _split(placements, mesh, axes)
    if {p.dim for p in other if p.is_shard()} \
            & {p.dim for p in batch if p.is_shard()}:
        return g
    return local_chunk(g, other, mesh)


def _reduced_shard(comm, g, placements, mesh, axes) -> torch.Tensor:
    """This rank's shard of ``g`` summed over the batch ``axes``."""
    part = model_slice(g, placements, mesh, axes)
    summed = comm.all_reduce(part, axes)
    if part is g:
        return local_chunk(summed, placements, mesh)
    return local_chunk(summed, _split(placements, mesh, axes)[1], mesh)


def _replicas(placements, mesh) -> int:
    """How many ranks hold each shard (the sizes of the axes that do not
    split the tensor)."""
    sizes = list(mesh_sizes(mesh).values())
    return math.prod(n for n, pl in zip(sizes, placements)
                     if not pl.is_shard())


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


def _local_loss(model: tf.Transformer, batch: Dict, cfg: ModelConfig,
                comm, axes) -> Tuple[torch.Tensor, Dict]:
    """The rank's share of the global loss (its tokens' NLL sum over the
    global count, plus its aux losses over the number of batch shards)
    and the global metrics."""
    inputs, labels = lm._shift_batch(batch, cfg)
    logits, _, aux = tf.forward(model, inputs, cfg)
    nll, count = _nll(logits, labels)
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
    with torch.no_grad(), sm.gathered():
        total, metrics = _local_loss(sm.local, place_batch(batch, sm.mesh),
                                     cfg, sm.comm, axes)
    return metrics["loss"] + metrics["aux"], metrics


def make_sharded_train_step(cfg: ModelConfig, optimizer) -> Callable:
    """Returns ``train_step(sm, opt_state, batch) -> (sm, opt_state,
    metrics)`` for a :class:`ShardedModel`: ``opt_state`` holds this
    rank's shards of the moments (``optimizer.init(sm.local)``) and
    ``batch`` the whole batch (every rank the same).  Updates the shards
    in place; the metrics (``loss``, ``aux``, ``dropped``,
    ``grad_norm``) are global."""

    def train_step(sm: ShardedModel, opt_state: Dict, batch: Dict):
        axes = _batch_axes(sm.mesh)
        local_batch = place_batch(batch, sm.mesh)
        with sm.gathered(requires_grad=True) as full:
            total, metrics = _local_loss(sm.local, local_batch, cfg,
                                         sm.comm, axes)
            total.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in full.items()}
        del full, total
        mine = {}
        for n in list(grads):
            mine[n] = _reduced_shard(sm.comm, grads.pop(n), sm.placements[n],
                                     sm.mesh, axes)
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
