"""int8 gradient compression with error feedback.

Port of ``repro/optim/compression.py``: per-tensor symmetric quantization
``q = round(g / s)`` with ``s = max|g| / 127``, and the residual ``g -
dequant(q)`` carried to the next step (error feedback), which keeps
SGD/Adam convergence unbiased in practice.  :func:`compressed_psum` sums
the quantized gradients over one axis of the ambient mesh
(``launch.mesh.set_mesh``), from an explicit rank body.

What crosses the wire is the dequantized float32 tensor, as in the
reference (its ``psum`` of ``deq`` is the "wire-equivalent" of an int8
sum): the sum is what an int8 all-reduce with float32 scales would give,
but the bytes moved are float32 ones, four per element.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["compress_int8", "decompress_int8", "ErrorFeedbackState",
           "compressed_psum"]


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


def compressed_psum(grads: Mapping[str, torch.Tensor], axis_name: str,
                    ef: ErrorFeedbackState
                    ) -> Tuple[Dict[str, torch.Tensor], ErrorFeedbackState]:
    """``psum(grads)`` over ``axis_name`` of the ambient mesh with int8
    quantization and error feedback: per tensor, ``g + residual`` is
    quantized, its dequantized value all-reduced (float32 on the wire,
    see above), and ``g + residual - deq`` becomes the new residual.
    Collective: every rank of the axis calls it."""
    from ..launch.mesh import current_mesh, mesh_comm
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("compressed_psum runs on a mesh "
                           "(launch.mesh.set_mesh)")
    summed, resid = {}, {}
    for n, g in grads.items():
        g = g.to(torch.float32) + ef.residual[n]
        deq = decompress_int8(*compress_int8(g))
        resid[n] = g - deq
        summed[n] = mesh_comm(mesh, g.device).all_reduce(deq, [axis_name])
    return summed, ErrorFeedbackState(resid)
