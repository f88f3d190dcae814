"""Shared model building blocks: init, norms, RoPE, softcap, sharding.

Port of ``repro/models/common.py``.  The mesh axis conventions are the
reference's (``launch/mesh.py``): batch-like dimensions shard over
``BATCH_AXES`` = ``("pod", "data")``, hidden, head and expert dimensions
over ``MODEL_AXIS`` = ``"model"``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..launch.mesh import P, current_mesh, placements_of, sanitize_spec

__all__ = ["Params", "dense_init", "rms_norm", "layer_norm", "rope",
           "apply_rope", "softcap", "gelu_tanh", "dtype_of", "constrain",
           "BATCH_AXES", "MODEL_AXIS", "P"]

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


class Params(nn.Module):
    """A module holding named tensors as parameters, frozen when built
    (``requires_grad=False``), so serving and inference build no autograd
    graph; the train step (``repro_torch.models.lm.make_train_step``) makes
    them trainable with ``requires_grad_(True)``.  ``name in p`` tells
    whether a parameter or child module of that name is present, as
    ``"bq" in p`` does on the reference's parameter dicts."""

    def __init__(self, **tensors: Optional[torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            if t is not None:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """LeCun-normal (fan-in) init from ``gen``, on ``gen``'s device unless
    ``device`` says otherwise (the two must agree)."""
    fan_in = shape[in_axis]
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=device if device is not None else gen.device)
    return x.mul_(fan_in ** -0.5)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` follows gemma's (1 + scale) convention.

    The reduction runs in float32; for bf16 inputs the normalize and scale
    multiplies stay in bf16 (normalizer rounded), as the reference does.
    """
    w = (1.0 + scale) if zero_centered else scale
    var = x.float().square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    if x.dtype == torch.bfloat16:
        return x * r.to(x.dtype) * w.to(x.dtype)
    return (x.float() * r * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Rotary position embedding tables.

    positions: int ``[...]``; returns (sin, cos) of shape
    ``[..., head_dim // 2]`` in float32.
    """
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: ``[..., T, n_heads, head_dim]``; sin/cos: ``[..., T, head_dim//2]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin_ = sin[..., None, :]     # broadcast over heads
    cos_ = cos[..., None, :]
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu``'s default)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Apply a sharding constraint under an ambient mesh
    (``launch.mesh.set_mesh``); a no-op outside one, as the reference's.

    Axes the mesh does not have, and axes whose size does not divide the
    dimension (8 kv heads on a 16-way model axis), are dropped
    (``sanitize_spec``).  On a DTensor the constraint is a
    ``redistribute`` to the sanitized spec's placements; on a plain
    tensor, which inside a mesh is the local shard of an explicit rank
    body (the counterpart of a ``shard_map`` body), it is a no-op: the
    body's collectives already placed it.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = placements_of(sanitize_spec(P(*spec), tuple(x.shape), mesh),
                               mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
