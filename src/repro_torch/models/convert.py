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
per-layer caches.  :func:`specs_from_jax` and :func:`cache_specs_from_jax`
map the reference's sharding-spec trees (``param_specs``,
``cache_specs``) onto the port's the same way: the scan's leading
``None`` of each stacked spec is dropped and the specs are keyed by
parameter name (a list of per-layer dicts for caches).  Nothing of JAX is
imported: the tree is plain dicts, lists and arrays (a spec leaf is any
sequence of its entries).
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from ..runtime.device import as_tensor, resolve_device
from .common import P, Params
from .config import ModelConfig
from .transformer import Block, Transformer, layer_plan

__all__ = ["params_from_jax", "opt_state_from_jax", "caches_from_jax",
           "unstack_layers", "specs_from_jax", "cache_specs_from_jax"]


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


def _spec(leaf, drop_scan: bool = False) -> P:
    entries = [tuple(e) if isinstance(e, (list, tuple)) else e
               for e in leaf]
    return P(*(entries[1:] if drop_scan else entries))


def _layer_spec_trees(cfg: ModelConfig, groups: List) -> List[Dict]:
    """The grouped ``[[unit specs]]`` as one spec dict per layer in
    ``cfg.pattern`` order, the scan's leading entry dropped."""
    layers = []
    for gi, (unit, n_units) in enumerate(layer_plan(cfg)):
        for _ in range(n_units):
            for li in range(len(unit)):
                layers.append(groups[gi][li])
    def strip(node):
        if isinstance(node, Mapping):
            return {k: strip(v) for k, v in node.items()}
        return _spec(node, drop_scan=True)
    return [strip(t) for t in layers]


def specs_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, P]:
    """The reference's ``param_specs(cfg)`` tree keyed by the port's
    parameter names (``transformer.param_specs``'s keys)."""
    out = {"top.embed": _spec(tree["embed"]),
           "top.final_norm": _spec(tree["final_norm"])}
    if "lm_head" in tree:
        out["top.lm_head"] = _spec(tree["lm_head"])
    for k, v in tree.get("frontend", {}).items():
        out[f"frontend.{k}"] = _spec(v)
    for i, layer in enumerate(_layer_spec_trees(cfg, tree["groups"])):
        for k, v in layer.items():
            if isinstance(v, Mapping):
                out.update({f"layers.{i}.{k}.{n}": s for n, s in v.items()})
            else:
                out[f"layers.{i}.norms.{k}"] = v
    return out


def cache_specs_from_jax(groups: List, cfg: ModelConfig) -> List[Dict]:
    """The reference's ``cache_specs(cfg)`` as one dict of specs per layer
    (``transformer.cache_specs``)."""
    return _layer_spec_trees(cfg, groups)
