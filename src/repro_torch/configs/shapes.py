"""Assigned input shapes and per-(arch, shape) applicability rules."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.config import ModelConfig

__all__ = ["Shape", "SHAPES", "cell_supported"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int           # context length (KV cache length for decode)
    batch: int         # global batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ModelConfig, shape_name: str
                   ) -> Tuple[bool, Optional[str]]:
    """(supported, skip_reason).  Skip rules per assignment + DESIGN.md."""
    shape = SHAPES[shape_name]
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full/global attention is quadratic at 500k; "
                       "runs only for SSM/hybrid archs (see DESIGN.md)")
    return True, None
