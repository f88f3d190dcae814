"""Modality frontends: precomputed frame and patch embeddings into the
model's width.

Port of ``repro/models/frontend.py``.  The conv feature extractor and the
vision tower are out of scope there too: the batches hold their outputs
(``repro_torch.data.pipeline.SyntheticLM`` makes them).

* audio (HuBERT-style): conv-feature frames [B, T, frontend_dim],
  projected and layer-normed into the encoder width;
* vlm (LLaVA-NeXT-style): anyres patch embeddings [B, num_patches,
  frontend_dim] through the 2-layer MLP projector, then prepended to the
  token embeddings (``transformer._embed_inputs``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import MODEL_AXIS, P, Params, dense_init, gelu_tanh, layer_norm
from .config import ModelConfig

__all__ = ["init_frontend", "frontend_specs", "audio_embed", "vlm_embed"]


def init_frontend(cfg: ModelConfig, gen: torch.Generator
                  ) -> Optional[Params]:
    """The frontend's weights, or None for a model without one."""
    dev = gen.device
    if cfg.frontend == "audio":
        return Params(proj=dense_init(gen, (cfg.frontend_dim, cfg.d_model)),
                      ln_scale=torch.ones(cfg.d_model, device=dev),
                      ln_bias=torch.zeros(cfg.d_model, device=dev))
    if cfg.frontend == "vlm":
        return Params(proj1=dense_init(gen, (cfg.frontend_dim, cfg.d_model)),
                      proj2=dense_init(gen, (cfg.d_model, cfg.d_model)))
    if cfg.frontend:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    return None


def frontend_specs(cfg: ModelConfig) -> Dict:
    if cfg.frontend == "audio":
        return {"proj": P(None, MODEL_AXIS), "ln_scale": P(None),
                "ln_bias": P(None)}
    if cfg.frontend == "vlm":
        return {"proj1": P(None, MODEL_AXIS), "proj2": P(MODEL_AXIS, None)}
    return {}


def audio_embed(p: Params, frames: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """frames [B, T, frontend_dim] -> [B, T, d]."""
    x = frames @ p.proj.to(frames.dtype)
    return layer_norm(x, p.ln_scale, p.ln_bias)


def vlm_embed(p: Params, patches: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """patches [B, P, frontend_dim] -> [B, P, d]."""
    h = gelu_tanh(patches @ p.proj1.to(patches.dtype))
    return h @ p.proj2.to(patches.dtype)
