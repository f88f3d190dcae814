"""Model configuration dataclasses for every assigned architecture family.

A copy of ``repro/models/config.py`` (the port imports nothing of the JAX
package), field for field, so the two registries compare equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False      # arctic: parallel dense FFN branch
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                # SSD head size P
    chunk: int = 256                  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # --- attention flavor ---
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    local_window: Optional[int] = None
    # per-layer kinds, cycled/explicit: 'g' global attn, 'l' local attn,
    # 'r' RG-LRU recurrent, 'm' mamba2 SSD.  len divides or equals n_layers.
    layer_pattern: str = "g"
    causal: bool = True               # False => encoder (hubert)
    mlp_kind: str = "swiglu"          # swiglu | geglu | none
    post_norms: bool = False          # gemma2 sandwich norms
    emb_scale: bool = False           # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- families ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    lru_width: Optional[int] = None   # RG-LRU width (defaults d_model)
    # --- modality frontend stubs ---
    frontend: Optional[str] = None    # None | 'audio' | 'vlm'
    frontend_dim: int = 0
    num_patches: int = 0              # vlm: patch embeddings prepended
    # --- numerics / training ---
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # integration of the paper's engine into MoE dispatch
    moe_impl: str = "dense_onehot"    # dense_onehot | ring (see models/moe.py)
    # perf levers (EXPERIMENTS.md §Perf); defaults = optimized configuration
    moe_shard_capacity: bool = True   # shard dispatch capacity over data axes
    moe_dispatch_groups: int = 1      # per-group capacity; set = batch shards

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> str:
        """Explicit per-layer kind string of length n_layers."""
        pat = self.layer_pattern
        if len(pat) >= self.n_layers:
            return pat[: self.n_layers]
        reps = -(-self.n_layers // len(pat))
        return (pat * reps)[: self.n_layers]

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """True if no layer does full (global) attention — long_500k eligible."""
        return "g" not in self.pattern

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = (self.n_heads * hd + 2 * self.n_kv_heads * hd) * d \
            + self.n_heads * hd * d
        if self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        elif self.mlp_kind == "none":
            mlp = 0
        else:
            mlp = 2 * d * self.d_ff
        total = 0
        for kind in self.pattern:
            if kind in ("g", "l"):
                if self.moe:
                    experts = (3 * d * self.moe.d_ff_expert
                               * self.moe.n_experts + d * self.moe.n_experts)
                    total += attn + experts
                    if self.moe.dense_residual:
                        total += mlp
                else:
                    total += attn + mlp
            elif kind == "r":
                w = self.lru_width or d
                # in/out proj + conv + block-diag gates (approx) + MLP
                total += 2 * d * w + w * d + 4 * w + 2 * w * w // 8 + mlp
            elif kind == "m":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                nh = di // s.head_dim
                total += (d * (2 * di + 2 * s.d_state + nh)   # in_proj
                          + (di + 2 * s.d_state) * s.d_conv   # conv1d
                          + di * d                            # out_proj
                          + 2 * nh + di)                      # A, D, norm
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            emb += self.frontend_dim * d
        return total + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        expert = 3 * d * self.moe.d_ff_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * expert
        return full - inactive * self.n_layers
