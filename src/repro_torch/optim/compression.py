"""int8 gradient compression with error feedback.

Port of the single-device half of ``repro/optim/compression.py``: per-tensor
symmetric quantization ``q = round(g / s)`` with ``s = max|g| / 127``, and
the residual ``g - dequant(q)`` carried to the next step (error feedback),
which keeps SGD/Adam convergence unbiased in practice.  The reference's
``compressed_psum`` (the int8 all-reduce over a slow data-parallel axis)
waits for the sharding of the LM stack over a process group
(``ROADMAP.md``, Queue A item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["compress_int8", "decompress_int8", "ErrorFeedbackState"]


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale) with ``g ~= q * scale``."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Dict[str, torch.Tensor]   # by name, like the gradients

    @classmethod
    def init(cls, grads_like: Mapping[str, torch.Tensor]
             ) -> "ErrorFeedbackState":
        return cls({n: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for n, g in grads_like.items()})
