"""Plan-based sparse hot path: MoE dispatch and attention scoring as
``DistBSR`` x ``DistDense`` products through ``matmul``.

Port of ``repro/serving/sparse.py``, the point where the paper's engine
meets the model stack:

* **MoE dispatch and combine**: token-choice routing is SpMM (see
  ``models/moe.py``).  The dispatch operator ``D`` is a {0,1}-sparse
  (expert-slots x tokens) matrix, ``dispatch = D @ X`` and ``combine =
  (D * probs)^T @ Y``, both on the stationary-A ``ring_a`` schedule, so on
  the card both run B1 (``kernels/csrc/bsr_spmm.cu``).
* **Attention scoring**: per (batch, head) panels stacked
  block-diagonally make ``S = Q_bd @ K_bd^T`` a block-sparse SpGEMM with a
  sparse output (``ring_c``, B2: only the diagonal blocks are computed or
  stored), and the masked probability matrix ``P`` (block-diagonal and
  block-causal) drives the combine ``O = P_bd @ V``, another ``ring_a``
  SpMM on B1.  Both structures are a function of the padded bucket only,
  so every request in a bucket shares the plans.

The routing is :func:`repro_torch.models.moe.route_tokens`, the dense
reference's own, so the two paths route identically.

Where the reference builds ``D`` and ``W`` in numpy on the host (in
bfloat16 at the published configs), the port builds them as tensors where
the activations are (``index_put_`` with ``accumulate=True``, as
``np.add.at`` adds), stacks the attention panels with ``torch.block_diag``,
and tiles every operator where it lies (``TiledBSR.from_dense`` of a
tensor copies only the block mask to the host).  ``D`` and ``W`` are tiled
at their structural capacity bound (:func:`routing_capacity`) rather than
at the bucket of their block count, so a routing change never changes a
plan's key: B1 multiplies only real blocks, so the padding costs storage,
not work.  The reference's per-segment jit trace counts
(``segment_trace_counts``) have no counterpart in eager torch.

With tracing on (``repro_torch.obs``), operator construction records
``serve.operator`` spans and tiling ``serve.tile`` spans, beside the plan
API's ``plan_build`` and ``multiply.*`` spans.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import obs as _obs
from ..core.api import DistBSR, DistDense, matmul
from ..core.grid import ceil_div, pad_to_multiple
from ..models import attention as attn_mod
from ..models import moe as moe_mod
from ..models.common import Params, apply_rope, rope, softcap
from ..models.config import ModelConfig
from ..runtime.device import resolve_device

__all__ = ["SparseOps", "SPMM_ALGORITHM", "SPGEMM_ALGORITHM",
           "sparse_moe_forward", "sparse_attn_forward", "routing_operators",
           "routing_capacity"]

# MoE dispatch is expert-stationary (the paper's stationary-A schedule);
# the scoring SpGEMM needs a sparse-output body, which ring_a does not
# have, so scores ride ring_c.
SPMM_ALGORITHM = "ring_a"
SPGEMM_ALGORITHM = "ring_c"


class SparseOps:
    """Shared grid, tiling and device for the engine's plan-based
    operators (the reference holds a device mesh here; the port's stacked
    executor keeps the g x g grid on one card)."""

    def __init__(self, g: int = 1, block_size: int = 8, device=None):
        self.g = g
        self.block_size = block_size
        self.device = resolve_device(device)

    def tile(self, a_dense: torch.Tensor, capacity="bucket") -> DistBSR:
        """A capacity-bucketed (or pinned) :class:`DistBSR` of a dense
        tensor, tiled on the card, in the tensor's type."""
        with _obs.span("serve.tile", rows=a_dense.shape[0],
                       cols=a_dense.shape[1]):
            return DistBSR.from_dense(
                a_dense, g=self.g, block_size=self.block_size,
                capacity=capacity, dtype=a_dense.dtype, device=self.device)

    # ------------------------------------------------------------------ SpMM
    def spmm(self, a_dense: torch.Tensor, x: torch.Tensor,
             algorithm: str = SPMM_ALGORITHM,
             capacity="bucket") -> torch.Tensor:
        """``a @ x`` with a materialised-sparse left operand; the plan is
        fetched from (or added to) the shared LRU cache keyed on the
        abstract shapes."""
        a = self.tile(a_dense, capacity)
        b = DistDense.for_rhs(x, a, allow_pad=True)
        return matmul(a, b, algorithm=algorithm)

    # ---------------------------------------------------------------- SpGEMM
    def spgemm_sparse(self, a_dense: torch.Tensor,
                      b_dense: torch.Tensor) -> DistBSR:
        """Sparse-output ``a @ b`` for two materialised-sparse operands."""
        return matmul(self.tile(a_dense), self.tile(b_dense),
                      algorithm=SPGEMM_ALGORITHM, output="sparse")


# ---------------------------------------------------------------------------
# MoE forward on the plan API
# ---------------------------------------------------------------------------
def routing_capacity(m: int, n: int, per_line: int, g: int,
                     bs: int) -> int:
    """Most real blocks a g x g tile of an ``m x n`` routing operator can
    hold when each of its lines (a column of D, a row of W: one token)
    holds at most ``per_line`` nonzeros (top-k): each line block of the
    tile meets at most ``min(bs * per_line, blocks across)`` blocks.  ``m``
    runs along the lines' blocks (D: its columns, W: its rows)."""
    along = pad_to_multiple(ceil_div(m, g), bs) // bs
    across = pad_to_multiple(ceil_div(n, g), bs) // bs
    return along * min(bs * per_line, across)


def routing_operators(r: Dict, n: int, cfg: ModelConfig,
                      dtype: torch.dtype) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The dispatch operator D ``[G*e*cap, n]`` (one unit entry per kept
    (token, expert) slot) and the combine operator W = (D * probs)^T
    ``[n, G*e*cap]``, as tensors of ``dtype`` on the routing's device.
    Dropped assignments go to an overflow line that is cut off, so no
    index is read back to the host."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    cap, G, ng = moe_mod.route_meta(n, cfg)
    top_e, slot, keep = r["top_e"], r["slot"], r["keep"]
    dev = top_e.device
    lines = G * e * cap
    gidx = (torch.arange(n, device=dev) // ng)[:, None]
    rows = torch.where(keep, (gidx * e + top_e) * cap + slot, lines)
    toks = torch.arange(n, device=dev)[:, None].expand(n, k)
    disp = torch.zeros((lines + 1, n), dtype=dtype, device=dev)
    disp.index_put_((rows, toks), keep.to(dtype), accumulate=True)
    comb = torch.zeros((n, lines + 1), dtype=dtype, device=dev)
    comb.index_put_((toks, rows), torch.where(keep, r["top_p"], 0.0).to(
        dtype), accumulate=True)
    return disp[:lines], comb[:, :lines]


def sparse_moe_forward(ops: SparseOps, p: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Drop-in for :func:`repro_torch.models.moe.moe_forward` with dispatch
    and combine through ``matmul``.  x: [B, T, d] -> (y, aux)."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = m.n_experts, m.top_k
    xf = x.reshape(n, d)

    cap, G, ng = moe_mod.route_meta(n, cfg)              # static ints
    r = moe_mod.route_tokens(p.router, xf, cfg)
    with _obs.span("serve.operator", op="moe", tokens=n):
        disp, comb = routing_operators(r, n, cfg, x.dtype)
    lines = G * e * cap
    bs = ops.block_size
    buf = ops.spmm(disp, xf, capacity=routing_capacity(
        n, lines, k, ops.g, bs))                         # [G*e*cap, d]
    xe = buf.reshape(G, e, cap, d).to(x.dtype)
    ye = moe_mod.expert_ffn(p, xe, cfg)                  # [G, e, cap, d]
    y = ops.spmm(comb, ye.reshape(lines, d), capacity=routing_capacity(
        n, lines, k, ops.g, bs))                         # [n, d]
    return y.to(x.dtype).reshape(b, t, d), moe_mod.router_aux(r, cfg)


# ---------------------------------------------------------------------------
# Block-sparse attention on the plan API
# ---------------------------------------------------------------------------
def _qkv_panels(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    """Projection + RoPE + kv-head repeat, laid out for block-diagonal
    stacking: (q_scaled [bh,t,hd], k_rep [bh,t,hd], v_flat [bh*t,hd],
    k_roped, v) in float32 (the last two, in x's type, feed the prefill
    cache write)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kh = cfg.n_heads, cfg.n_kv_heads
    grp = h // kh
    q, k, v = attn_mod._project_qkv(p, x, cfg)
    sin, cos = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    qh = q.transpose(1, 2).reshape(b * h, t, hd).float() * (hd ** -0.5)
    k_rep = k.transpose(1, 2).repeat_interleave(grp, dim=1)
    v_rep = v.transpose(1, 2).repeat_interleave(grp, dim=1)
    kh_f = k_rep.reshape(b * h, t, hd).float()
    v_f = v_rep.reshape(b * h * t, hd).float()
    return qh, kh_f, v_f, k, v


def _probs(s_full: torch.Tensor, mask: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Diagonal-block extraction + softcap + mask + softmax; returns the
    masked probability panels ``[bh, t, t]`` (exact zeros off the mask)."""
    t = mask.shape[-1]
    bh = s_full.shape[0] // t
    scores = s_full.reshape(bh, t, bh, t).diagonal(dim1=0, dim2=2)
    scores = softcap(scores.permute(2, 0, 1), cfg.attn_softcap)
    logits = torch.where(mask[None], scores, attn_mod.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return probs * mask[None].to(probs.dtype)


def _out_proj(o: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig, b: int,
              dtype: torch.dtype) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    h = cfg.n_heads
    t = o.shape[0] // (b * h)
    out = (o.reshape(b, h, t, hd).transpose(1, 2)
           .reshape(b, t, h * hd).to(dtype))
    return out @ wo.to(dtype)


def sparse_attn_forward(ops: SparseOps, p: Params, x: torch.Tensor,
                        cfg: ModelConfig, kind: str, positions: torch.Tensor,
                        cache: Optional[Dict] = None):
    """Drop-in for :func:`repro_torch.models.attention.attn_forward`
    (prefill) with scoring and combine on the plan API.

    Per-(batch, head) Q/K/V panels are stacked block-diagonally, so the
    whole batch's scoring is one sparse-output SpGEMM and the masked
    probability matrix drives one SpMM; the block structure depends only
    on the padded shape, so plans are shared across every request in a
    bucket.
    """
    b = x.shape[0]
    qh, kh_f, v_f, k, v = _qkv_panels(p, x, positions, cfg)
    with _obs.span("serve.operator", op="qk", panels=qh.shape[0]):
        q_bd = torch.block_diag(*qh)
        kt_bd = torch.block_diag(*kh_f.transpose(1, 2))
    # scoring: S_bd = Q_bd @ K_bd^T, sparse x sparse, sparse output
    s_full = ops.spgemm_sparse(q_bd, kt_bd).densify()
    del q_bd, kt_bd
    # softcap + mask + softmax (the dense _sdpa reference's math)
    mask = attn_mod._pair_mask(cfg, kind, positions, positions)
    pm = _probs(s_full, mask, cfg)
    del s_full
    # combine: O = P_bd @ V, the mask prunes whole blocks of P
    with _obs.span("serve.operator", op="pv", panels=pm.shape[0]):
        pv = torch.block_diag(*pm)
    o = ops.spmm(pv, v_f)                                     # [bh*t, hd]
    out = _out_proj(o, p.wo, cfg, b, x.dtype)
    if cache is None:
        return out, None
    return out, attn_mod._write_prefill(cache, k, v, positions, cfg, kind)
