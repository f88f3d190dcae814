"""Architecture registry: ``get_config(arch, smoke=False)``.

Every assigned architecture is a selectable config (``--arch <id>``); smoke
variants are family-preserving reductions used by the CPU tests.

A copy of ``repro/configs`` (data only), so ``get_config`` gives the JAX
package's configurations field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from ..models.config import ModelConfig, MoEConfig, SSMConfig
from .shapes import SHAPES, Shape, cell_supported  # noqa: F401

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-3b": "qwen2_5_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "arctic-480b": "arctic_480b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {list_archs()}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    cfg: ModelConfig = mod.FULL
    return make_smoke(cfg) if smoke else cfg


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction: tiny dims, same layer kinds/features."""
    unit = len(cfg.layer_pattern)
    n_layers = max(2, unit + 1)          # keep pattern + a remainder layer
    head_dim = 16
    n_heads = max(2, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // min(ratio, n_heads))
    moe = None
    if cfg.moe:
        # high capacity factor => no token drops => decode == full forward
        moe = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=32, capacity_factor=8.0)
    ssm = None
    if cfg.ssm:
        ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        local_window=16 if cfg.local_window else None,
        lru_width=64 if cfg.lru_width else None,
        moe=moe,
        ssm=ssm,
        frontend_dim=32 if cfg.frontend else 0,
        num_patches=4 if cfg.frontend == "vlm" else 0,
        compute_dtype="float32",
        remat=False,
    )
