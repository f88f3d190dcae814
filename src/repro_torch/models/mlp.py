"""Gated MLPs (SwiGLU / GeGLU) and the plain GELU MLP.

Port of ``repro/models/mlp.py``: the dense ``"g"``/``"l"`` layers' FFN and
arctic's dense residual branch beside its experts.  On a rank of the
tensor-parallel program (``models/tensor_parallel.py``) ``w_up`` and
``w_gate`` are column-parallel and ``w_down`` row-parallel: the rank's
hidden units, their output summed over ``model`` at the reference's
constrain site.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import tensor_parallel
from .common import MODEL_AXIS, P, Params, dense_init, gelu_tanh
from .config import ModelConfig

__all__ = ["init_mlp", "mlp_specs", "mlp_forward"]


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    w_gate = dense_init(gen, (d, f)) if gated else None
    return Params(w_up=dense_init(gen, (d, f)),
                  w_down=dense_init(gen, (f, d)), w_gate=w_gate)


def mlp_specs(cfg: ModelConfig) -> Dict:
    p = {"w_up": P("data", MODEL_AXIS), "w_down": P(MODEL_AXIS, "data")}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = P("data", MODEL_AXIS)
    return p


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """x: ``[B, T, d]``; the weights are cast to x's type per use."""
    w_up, w_gate, w_down = tensor_parallel.mlp_weights(p)
    x = tensor_parallel.site("mlp.in", x)
    u = tensor_parallel.dot(x, w_up)
    if cfg.mlp_kind == "gelu":          # plain 2-matrix MLP (hubert)
        h = gelu_tanh(u)
    else:                               # gated: swiglu / geglu
        act = F.silu if cfg.mlp_kind == "swiglu" else gelu_tanh
        h = act(tensor_parallel.dot(x, w_gate)) * u
    return tensor_parallel.site("mlp.out", tensor_parallel.dot(
        h, w_down, cfg.d_model))
