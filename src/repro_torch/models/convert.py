"""Carry a JAX parameter tree across into the port's modules.

``params_from_jax(tree, cfg, device)`` takes the reference's
``init_params`` pytree with its leaves as numpy arrays (``np.asarray`` of
each JAX array; bfloat16 leaves are reinterpreted bit for bit) and builds
the :class:`~repro_torch.models.transformer.Transformer` holding the same
values.  The reference stacks each layer group's units along a leading
``[n_units, ...]`` axis (``params["groups"]``, grouped by
:func:`~repro_torch.models.transformer.layer_plan`); here they are
unstacked into one :class:`~repro_torch.models.transformer.Block` per
layer, in ``cfg.pattern`` order.  ``opt_state_from_jax`` carries the
reference's AdamW state across the same way, into the port's state keyed
by parameter name, and ``caches_from_jax`` a decode cache into the port's
per-layer caches.  Nothing of JAX is imported: the tree is plain dicts,
lists and arrays.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from ..runtime.device import as_tensor, resolve_device
from .common import Params
from .config import ModelConfig
from .transformer import Block, Transformer, layer_plan

__all__ = ["params_from_jax", "opt_state_from_jax", "caches_from_jax",
           "unstack_layers"]


def unstack_layers(cfg: ModelConfig, groups: List) -> List[Dict]:
    """The reference's grouped ``[n_units, ...]`` trees (parameters or
    caches) as one tree per layer in ``cfg.pattern`` order, leaves still
    numpy (``repro.models.transformer.unstack_groups``'s order)."""
    def take(node, ui):
        if isinstance(node, Mapping):
            return {k: take(v, ui) for k, v in node.items()}
        return np.asarray(node)[ui]

    layers = []
    for gi, (unit, n_units) in enumerate(layer_plan(cfg)):
        for ui in range(n_units):
            for li in range(len(unit)):
                layers.append(take(groups[gi][li], ui))
    return layers


def _params(sub: Mapping, device) -> Params:
    return Params(**{k: as_tensor(np.asarray(v), device)
                     for k, v in sub.items()})


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's model holding the JAX parameter tree's values on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    layers = []
    for lp in unstack_layers(cfg, tree["groups"]):
        vec = {k: as_tensor(lp[k], dev) for k in ("ln1", "ln2", "pn1", "pn2")
               if k in lp}
        mods = {k: _params(lp[k], dev) for k in ("attn", "rec", "mamba",
                                                 "moe", "mlp") if k in lp}
        layers.append(Block(vec["ln1"], ln2=vec.get("ln2"),
                            pn1=vec.get("pn1"), pn2=vec.get("pn2"), **mods))
    lm_head = as_tensor(np.asarray(tree["lm_head"]), dev) \
        if "lm_head" in tree else None
    frontend = _params(tree["frontend"], dev) if "frontend" in tree else None
    return Transformer(cfg, as_tensor(np.asarray(tree["embed"]), dev),
                       as_tensor(np.asarray(tree["final_norm"]), dev),
                       layers, lm_head=lm_head, frontend=frontend)


def caches_from_jax(groups: List, cfg: ModelConfig,
                    device=None) -> List[Dict]:
    """The reference's decode cache (``init_cache``/``prefill``'s grouped
    tree, numpy leaves) as the port's: one dict of tensors per layer, in
    ``cfg.pattern`` order, dtypes kept, on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return [{k: as_tensor(np.asarray(v), dev) for k, v in layer.items()}
            for layer in unstack_layers(cfg, groups)]


def _by_name(tree: Mapping, cfg: ModelConfig, device) -> Dict:
    """A parameter-shaped JAX tree as tensors keyed by the port's parameter
    names (``named_parameters()``), dtypes kept."""
    return {n: p.detach() for n, p in
            params_from_jax(tree, cfg, device).named_parameters()}


def opt_state_from_jax(state: Mapping, cfg: ModelConfig,
                       device=None) -> Dict:
    """The reference's AdamW state ``{"step", "mu", "nu", "gnorm"}`` (numpy
    leaves) as the port's (``repro_torch.optim.AdamW``) on ``device`` (the
    card by default): ``mu`` and ``nu`` unstacked and keyed by parameter
    name, ``nu`` in its own dtype."""
    dev = resolve_device(device)
    return {"step": as_tensor(np.asarray(state["step"]), dev,
                              dtype=torch.int32),
            "mu": _by_name(state["mu"], cfg, dev),
            "nu": _by_name(state["nu"], cfg, dev),
            "gnorm": as_tensor(np.asarray(state["gnorm"]), dev,
                               dtype=torch.float32)}
