"""The layer stack: embed -> per-layer blocks -> norm -> logits.

Port of ``repro/models/transformer.py``.  Layer kinds (``"g"`` global
attention, ``"l"`` local attention, ``"r"`` RG-LRU, ``"m"`` Mamba-2 SSD)
come from ``cfg.layer_pattern``; an attention layer carries a dense MLP or
a token-choice MoE (plus arctic's dense residual), an RG-LRU layer a dense
MLP, a Mamba layer nothing else.  A model with a modality frontend
(``cfg.frontend``: ``"audio"`` frames or ``"vlm"`` patches) embeds its
batch through ``models/frontend.py``.

The reference scans each layer group over stacked parameters; eager torch
runs one Python loop over per-layer :class:`Block` modules, so
:func:`forward` and :func:`forward_unscanned` (and the two decode steps)
are the same loop, both names kept.  ``layer_plan`` still describes the
reference's grouping: :func:`repro_torch.models.convert.params_from_jax`
unstacks a JAX parameter tree by it.  Caches are a list with one dict per
layer, in ``cfg.pattern`` order: an attention layer's ``{"k", "v",
"pos"}``, an RG-LRU layer's ``{"h", "conv"}``, a Mamba layer's ``{"ssm",
"conv"}``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..runtime.device import resolve_device
from . import attention as attn_mod
from . import frontend as front_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import (MODEL_AXIS, P, Params, dense_init, dtype_of, rms_norm,
                     softcap)
from .config import ModelConfig

__all__ = ["Block", "Transformer", "layer_plan", "init_params", "init_cache",
           "param_specs", "cache_specs", "forward", "forward_unscanned",
           "decode_step", "decode_step_unscanned"]


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(unit_pattern, n_units), ...]; remainder layers become a 1-unit
    group (the reference's scan grouping)."""
    unit = cfg.layer_pattern
    n_full = cfg.n_layers // len(unit)
    rem = cfg.pattern[n_full * len(unit):]
    plan = []
    if n_full:
        plan.append((unit, n_full))
    if rem:
        plan.append((rem, 1))
    return plan


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer: a pre-norm mixer (``attn`` for ``"g"``/``"l"``, ``rec``
    for ``"r"``, ``mamba`` for ``"m"``), then a pre-norm MLP or MoE where
    the kind has one (optional gemma2 post-norms).  ``ln1``/``ln2``/``pn1``/
    ``pn2`` are the norms' scales; ``attn``, ``rec``, ``mamba``, ``moe``
    and ``mlp`` hold their weights."""

    def __init__(self, ln1: torch.Tensor, attn: Optional[Params] = None,
                 ln2: Optional[torch.Tensor] = None,
                 moe: Optional[Params] = None, mlp: Optional[Params] = None,
                 pn1: Optional[torch.Tensor] = None,
                 pn2: Optional[torch.Tensor] = None,
                 rec: Optional[Params] = None,
                 mamba: Optional[Params] = None):
        super().__init__()
        self.norms = Params(ln1=ln1, ln2=ln2, pn1=pn1, pn2=pn2)
        for name, mod in (("attn", attn), ("rec", rec), ("mamba", mamba),
                          ("moe", moe), ("mlp", mlp)):
            if mod is not None:
                self.add_module(name, mod)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self.norms


class Transformer(nn.Module):
    """Embedding, the frontend (where the model has one), the per-layer
    blocks, the final norm and the LM head (``lm_head`` absent with tied
    embeddings)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, layers: List[Block],
                 lm_head: Optional[torch.Tensor] = None,
                 frontend: Optional[Params] = None):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, got "
                             f"{len(layers)} blocks")
        if (frontend is None) != (not cfg.frontend):
            raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} needs "
                             "its weights, and only it has them")
        self.cfg = cfg
        self.top = Params(embed=embed, final_norm=final_norm,
                          lm_head=lm_head)
        if frontend is not None:
            self.frontend = frontend
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    def head(self) -> torch.Tensor:
        """[d, V] output projection (the embedding's transpose if tied)."""
        return self.top.embed.T if self.cfg.tie_embeddings \
            else self.top.lm_head


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator) -> Block:
    """One layer of ``kind``, the reference's ``_init_layer``."""
    d = cfg.d_model
    dev = gen.device

    def zeros():
        return torch.zeros(d, device=dev)

    if kind == "m":
        return Block(zeros(), mamba=ssm_mod.init_mamba(cfg, gen))
    if kind == "r":
        rec = rglru_mod.init_rglru(cfg, gen)
        if cfg.mlp_kind == "none":
            return Block(zeros(), rec=rec)
        return Block(zeros(), rec=rec, ln2=zeros(),
                     mlp=mlp_mod.init_mlp(cfg, gen))
    if kind not in ("g", "l"):
        raise ValueError(f"unknown layer kind {kind!r}")
    attn = attn_mod.init_attn(cfg, gen)
    moe = mlp = ln2 = pn1 = pn2 = None
    if cfg.moe is not None:
        ln2 = zeros()
        moe = moe_mod.init_moe(cfg, gen)
        if cfg.moe.dense_residual:
            mlp = mlp_mod.init_mlp(cfg, gen)
    elif cfg.mlp_kind != "none":
        ln2 = zeros()
        mlp = mlp_mod.init_mlp(cfg, gen)
    if cfg.post_norms:
        pn1, pn2 = zeros(), zeros()
    return Block(zeros(), attn, ln2=ln2, moe=moe, mlp=mlp, pn1=pn1,
                 pn2=pn2)


def _keep_params(mod: nn.Module, prefix: str, keep: Callable) -> None:
    """Replace each parameter of ``mod`` by ``keep(name, tensor)``."""
    for name, p in list(mod.named_parameters()):
        *path, leaf = name.split(".")
        owner = mod
        for part in path:
            owner = getattr(owner, part)
        owner.register_parameter(leaf, nn.Parameter(
            keep(prefix + name, p.data), requires_grad=False))


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                keep: Optional[Callable] = None) -> Transformer:
    """Random float32 parameters on ``device`` (the card by default), from
    a ``torch.Generator`` seeded with ``seed`` on that device.  The values
    are the port's own draws, not the reference's: carry JAX parameters
    across with :func:`repro_torch.models.convert.params_from_jax`.

    ``keep(name, tensor)`` (optional) is applied to every parameter as
    soon as its layer is drawn, by its ``named_parameters()`` name: a rank
    of a mesh keeps its shard (cast, if it likes) and the draws of the
    whole model are never held at once.  The draws are the same either
    way, so a kept shard is a slice of the full init."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = keep or (lambda name, t: t)
    with torch.no_grad():
        embed = keep("top.embed", dense_init(
            gen, (cfg.vocab_size, cfg.d_model), in_axis=1))
        lm_head = None if cfg.tie_embeddings else keep(
            "top.lm_head", dense_init(gen, (cfg.d_model, cfg.vocab_size)))
        frontend = front_mod.init_frontend(cfg, gen)
        if frontend is not None:
            _keep_params(frontend, "frontend.", keep)
        layers = []
        for i, kind in enumerate(cfg.pattern):
            blk = _init_block(cfg, kind, gen)
            _keep_params(blk, f"layers.{i}.", keep)
            layers.append(blk)
        final_norm = keep("top.final_norm",
                          torch.zeros(cfg.d_model, device=dev))
    return Transformer(cfg, embed, final_norm, layers, lm_head=lm_head,
                       frontend=frontend)


def _layer_specs(cfg: ModelConfig, kind: str) -> Dict:
    """One layer's specs by its parameters' names within the block (the
    reference's ``_layer_specs``, without the scan's leading axis)."""
    p: Dict = {"norms.ln1": P(None)}
    mods: Dict = {}
    if kind in ("g", "l"):
        mods["attn"] = attn_mod.attn_specs(cfg)
        if cfg.moe is not None:
            p["norms.ln2"] = P(None)
            mods["moe"] = moe_mod.moe_specs(cfg)
            if cfg.moe.dense_residual:
                mods["mlp"] = mlp_mod.mlp_specs(cfg)
        elif cfg.mlp_kind != "none":
            p["norms.ln2"] = P(None)
            mods["mlp"] = mlp_mod.mlp_specs(cfg)
        if cfg.post_norms:
            p["norms.pn1"] = P(None)
            p["norms.pn2"] = P(None)
    elif kind == "r":
        mods["rec"] = rglru_mod.rglru_specs(cfg)
        if cfg.mlp_kind != "none":
            p["norms.ln2"] = P(None)
            mods["mlp"] = mlp_mod.mlp_specs(cfg)
    elif kind == "m":
        mods["mamba"] = ssm_mod.mamba_specs(cfg)
    for mod, specs in mods.items():
        p.update({f"{mod}.{k}": s for k, s in specs.items()})
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Every parameter's sharding spec, keyed by its ``named_parameters()``
    name (the reference's ``param_specs``; one module per layer, so a
    layer's specs have no leading scan axis)."""
    specs: Dict[str, P] = {"top.embed": P("data", MODEL_AXIS),
                           "top.final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["top.lm_head"] = P("data", MODEL_AXIS)
    specs.update({f"frontend.{k}": s for k, s in
                  front_mod.frontend_specs(cfg).items()})
    for i, kind in enumerate(cfg.pattern):
        specs.update({f"layers.{i}.{k}": s for k, s in
                      _layer_specs(cfg, kind).items()})
    return specs


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> List[Dict]:
    """One cache per layer, in ``cfg.pattern`` order: attention layers'
    in ``dtype``, the recurrent states in float32 whatever ``dtype`` (the
    reference's ``_init_layer_cache``)."""
    dev = resolve_device(device)
    return [_init_layer_cache(cfg, kind, batch, max_len, dtype, dev)
            for kind in cfg.pattern]


def cache_specs(cfg: ModelConfig) -> List[Dict[str, P]]:
    """The decode cache's specs, one dict per layer in ``cfg.pattern``
    order (the reference's ``cache_specs``, unstacked)."""
    out = []
    for kind in cfg.pattern:
        if kind in ("g", "l"):
            out.append(attn_mod.attn_cache_specs(cfg, kind))
        elif kind == "r":
            out.append(rglru_mod.rglru_cache_specs(cfg))
        elif kind == "m":
            out.append(ssm_mod.mamba_cache_specs(cfg))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return out


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> Dict:
    if kind in ("g", "l"):
        return attn_mod.init_attn_cache(cfg, kind, batch, max_len, dtype,
                                        device)
    if kind == "r":
        return rglru_mod.init_rglru_cache(cfg, batch, device=device)
    if kind == "m":
        return ssm_mod.init_mamba_cache(cfg, batch, device=device)
    raise ValueError(f"unknown layer kind {kind!r}")


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------
def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {"aux": torch.zeros((), device=device),
            "dropped": torch.zeros((), device=device)}


def _apply_layer(p: Block, x: torch.Tensor, kind: str, cfg: ModelConfig,
                 positions, cache: Optional[Dict], pos=None,
                 decode: bool = False, moe_fn: Optional[Callable] = None,
                 attn_fn: Optional[Callable] = None):
    """Returns (x, new_cache, aux_scalar_dict).

    ``moe_fn`` / ``attn_fn`` replace the MoE and (forward-path) attention
    bodies: the hook the serving engine uses to route expert dispatch and
    attention scoring through the plan API while every other piece of the
    layer (norms, residuals, cache plumbing) stays as it is.  ``attn_fn``
    takes ``attn_forward``'s arguments, ``moe_fn`` ``moe_forward``'s.
    """
    aux = _zero_aux(x.device)
    nm = p.norms
    h = rms_norm(x, nm.ln1, cfg.norm_eps)
    if kind == "r":
        if decode:
            y, new_cache = rglru_mod.rglru_decode(p.rec, h, cache, cfg)
        else:
            y, new_cache = rglru_mod.rglru_forward(p.rec, h, cfg, cache)
    elif kind == "m":
        if decode:
            y, new_cache = ssm_mod.mamba_decode(p.mamba, h, cache, cfg)
        else:
            y, new_cache = ssm_mod.mamba_forward(p.mamba, h, cfg, cache)
    elif decode:
        y, new_cache = attn_mod.attn_decode(p.attn, h, cache, pos, cfg, kind)
    elif attn_fn is not None:
        y, new_cache = attn_fn(p.attn, h, cfg, kind, positions, cache)
    else:
        y, new_cache = attn_mod.attn_forward(p.attn, h, cfg, kind,
                                             positions, cache)
    if cfg.post_norms:
        y = rms_norm(y, nm.pn1, cfg.norm_eps)
    x = x + y

    if "mlp" in p or "moe" in p:
        h2 = rms_norm(x, nm.ln2, cfg.norm_eps)
        if "moe" in p:
            if moe_fn is None:
                moe_fn = moe_mod.ring_moe_forward if cfg.moe_impl == "ring" \
                    else moe_mod.moe_forward
            y2, moe_aux = moe_fn(p.moe, h2, cfg)
            aux["aux"] = aux["aux"] + moe_aux["moe_aux"] + moe_aux["moe_z"]
            aux["dropped"] = aux["dropped"] + moe_aux["moe_dropped"]
            if "mlp" in p:  # arctic's parallel dense residual branch
                y2 = y2 + mlp_mod.mlp_forward(p.mlp, h2, cfg)
        else:
            y2 = mlp_mod.mlp_forward(p.mlp, h2, cfg)
        if cfg.post_norms:
            y2 = rms_norm(y2, nm.pn2, cfg.norm_eps)
        x = x + y2
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------
def _embed_inputs(params: Transformer, batch: Dict, cfg: ModelConfig,
                  decode: bool = False) -> torch.Tensor:
    """x [B, T, d] in the compute type: a frontend model's frames
    (``"frames"``, audio) or patches prepended to its tokens
    (``"patches"``, vlm), else the tokens' embeddings; gemma's
    ``emb_scale`` applies to each.  A decode step (``decode``) embeds its
    one token the tokens' way, frontend or not (the reference's
    ``decode_step``)."""
    dtype = dtype_of(cfg.compute_dtype)
    front = None if decode else cfg.frontend
    if front == "audio":
        x = front_mod.audio_embed(params.frontend,
                                  batch["frames"].to(dtype), cfg)
    elif front == "vlm":
        tok = params.top.embed[batch["tokens"].long()].to(dtype)
        patches = front_mod.vlm_embed(params.frontend,
                                      batch["patches"].to(dtype), cfg)
        x = torch.cat([patches.to(dtype), tok], dim=1)
    else:
        x = params.top.embed[batch["tokens"].long()].to(dtype)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def _head_logits(params: Transformer, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Final norm, LM head (float32 logits, as the reference's
    ``preferred_element_type``), softcap."""
    x = rms_norm(x, params.top.final_norm, cfg.norm_eps)
    head = params.head().to(x.dtype)
    logits = (x.float() @ head.float()) if x.dtype != torch.float32 \
        else x @ head
    return softcap(logits, cfg.final_softcap)


def forward_unscanned(params: Transformer, batch: Dict, cfg: ModelConfig,
                      caches: Optional[List[Dict]] = None,
                      positions: Optional[torch.Tensor] = None,
                      moe_fn: Optional[Callable] = None,
                      attn_fn: Optional[Callable] = None):
    """Full-sequence forward, one layer at a time; ``moe_fn`` / ``attn_fn``
    may do host-side work per layer (the serving engine builds its sparse
    operators there).  ``batch`` holds ``"tokens"`` (int [B, T]), and a
    frontend model's ``"frames"`` or ``"patches"`` (float, see
    :func:`_embed_inputs`).  Returns (logits [B, T, V] float32,
    new_caches, aux).

    Follows the caller's grad mode.  With gradients on and ``cfg.remat``,
    each layer without a cache is recomputed in the backward pass instead
    of keeping its activations (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint(..., nothing_saveable)`` around each
    layer unit): the recomputation's outputs are dropped, so ``dropped``
    and the aux losses count once, and a layer with a cache is never
    recomputed (its cache write happens once)."""
    x = _embed_inputs(params, batch, cfg)
    t = x.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    layers_c = caches if caches is not None else [None] * cfg.n_layers
    aux_sum = _zero_aux(x.device)
    new_caches = []
    remat = cfg.remat and torch.is_grad_enabled()
    for blk, c_l, kind in zip(params.layers, layers_c, cfg.pattern):
        if remat and c_l is None:
            x, nc, aux = checkpoint(
                _apply_layer, blk, x, kind, cfg, positions, c_l,
                moe_fn=moe_fn, attn_fn=attn_fn, use_reentrant=False,
                preserve_rng_state=False)      # the layers draw nothing
        else:
            x, nc, aux = _apply_layer(blk, x, kind, cfg, positions, c_l,
                                      moe_fn=moe_fn, attn_fn=attn_fn)
        new_caches.append(nc)
        aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
    return (_head_logits(params, x, cfg),
            new_caches if caches is not None else None, aux_sum)


def forward(params: Transformer, batch: Dict, cfg: ModelConfig,
            caches: Optional[List[Dict]] = None,
            positions: Optional[torch.Tensor] = None):
    """Full-sequence forward.  Returns (logits, new_caches, aux)."""
    return forward_unscanned(params, batch, cfg, caches, positions)


def decode_step_unscanned(params: Transformer, token: torch.Tensor,
                          caches: List[Dict], pos, cfg: ModelConfig,
                          moe_fn: Optional[Callable] = None):
    """One-token step, without gradients.  token: int [B, 1]; pos: an int
    or an int [B] tensor of per-request positions (continuous batching).
    Returns (logits [B, 1, V], new_caches, aux)."""
    with torch.no_grad():
        x = _embed_inputs(params, {"tokens": token}, cfg, decode=True)
        aux_sum = _zero_aux(x.device)
        new_caches = []
        for blk, c_l, kind in zip(params.layers, caches, cfg.pattern):
            x, nc, aux = _apply_layer(blk, x, kind, cfg, None, c_l, pos=pos,
                                      decode=True, moe_fn=moe_fn)
            new_caches.append(nc)
            aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
        return _head_logits(params, x, cfg), new_caches, aux_sum


def decode_step(params: Transformer, token: torch.Tensor,
                caches: List[Dict], pos, cfg: ModelConfig,
                return_aux: bool = False):
    """One-token step: (logits [B, 1, V], new_caches), plus the summed
    per-layer aux dict when ``return_aux`` is set."""
    logits, new_caches, aux = decode_step_unscanned(params, token, caches,
                                                    pos, cfg)
    if return_aux:
        return logits, new_caches, aux
    return logits, new_caches
