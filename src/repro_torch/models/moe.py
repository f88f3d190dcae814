"""Token-choice Mixture-of-Experts: where the paper's SpMM engine meets the
LM stack.

Port of ``repro/models/moe.py``.  Token-choice routing *is* a sparse x
dense product: the dispatch operator D is a {0,1}-sparse (expert-slots x
tokens) matrix, and dispatch and combine are ``D @ X`` and
``(D * probs)^T @ Y``.  :func:`moe_forward` applies D as a capacity-padded
scatter and gather (the dense reference); the serving engine's
``repro_torch.serving.sparse`` runs the same two products through the plan
API's ``ring_a`` schedule, on the same routing (:func:`route_tokens`).

``ring_moe_forward`` (the reference's expert ring over a device mesh) and
the distributed selftests need a multi-card executor and are not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import Params, dense_init, gelu_tanh
from .config import ModelConfig

__all__ = ["init_moe", "moe_forward", "route_tokens", "route_meta",
           "expert_ffn", "router_aux"]


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    return Params(router=dense_init(gen, (d, e)),
                  w_gate=dense_init(gen, (e, d, f), in_axis=1),
                  w_up=dense_init(gen, (e, d, f), in_axis=1),
                  w_down=dense_init(gen, (e, f, d), in_axis=1))


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(c, m.top_k)


def route_meta(n_tokens: int, cfg: ModelConfig) -> Tuple[int, int, int]:
    """Static routing geometry ``(cap, G, ng)`` as plain python ints: a
    function of the (padded) token count and the config, shared by the
    router and the serving engine's operator construction."""
    m = cfg.moe
    G = max(1, cfg.moe_dispatch_groups)
    while n_tokens % G:
        G //= 2
    ng = n_tokens // G
    cap = max(_capacity(n_tokens, cfg) // G, m.top_k)
    return cap, G, ng


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row, largest first, the lower index
    first among equal values (``jax.lax.top_k``'s order, which the slot
    ranks depend on)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_tokens(router: torch.Tensor, xf: torch.Tensor,
                 cfg: ModelConfig) -> Dict:
    """Shared router math: softmax -> top-k -> per-group capacity slots.

    ``xf``: [n, d] flat tokens.  Returns a dict of routing tensors (and the
    static ints ``cap``, ``G``, ``ng``); both :func:`moe_forward` and the
    serving engine's sparse dispatch call this, so the two paths route
    identically.
    """
    m = cfg.moe
    n = xf.shape[0]
    e, k = m.n_experts, m.top_k
    cap, G, ng = route_meta(n, cfg)

    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                            # [n, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # per-group capacity assignment (slot = rank within group+expert)
    onehot = F.one_hot(top_e, e).to(torch.int32)               # [n, k, e]
    flat = onehot.reshape(G, ng * k, e)
    ranks = torch.cumsum(flat, dim=1) - flat                   # excl, per group
    slot = (ranks * flat).sum(-1).reshape(n, k)
    keep = slot < cap
    return {"logits": logits, "probs": probs, "top_p": top_p,
            "top_e": top_e, "slot": slot, "keep": keep, "onehot": onehot,
            "cap": cap, "G": G, "ng": ng,
            "dropped": 1.0 - keep.float().mean()}


def expert_ffn(p: Params, xe: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """Expert MLPs on dispatched slots.  xe: [..., e, cap, d] -> same."""
    act = F.silu if cfg.mlp_kind != "geglu" else gelu_tanh
    g = xe @ p.w_gate.to(xe.dtype)
    u = xe @ p.w_up.to(xe.dtype)
    return (act(g) * u) @ p.w_down.to(xe.dtype)


def router_aux(route: Dict, cfg: ModelConfig) -> Dict:
    """Switch-style aux losses + drop stats from :func:`route_tokens`."""
    m = cfg.moe
    me = route["probs"].mean(0)                                # [e]
    ce = route["onehot"].float().sum(1).mean(0)                # fraction routed
    return {
        "moe_aux": m.aux_loss * m.n_experts * torch.sum(me * ce),
        "moe_z": m.router_z_loss * torch.mean(
            torch.square(torch.logsumexp(route["logits"], dim=-1))),
        "moe_dropped": route["dropped"],
    }


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """x: [B, T, d] -> (y, aux) with load-balance/z losses in aux.

    Dispatch uses per-group capacity: tokens split into G groups, each
    ranks its own tokens and scatters into its own capacity slice (G = 1
    on one card unless the config asks for more).
    """
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = m.n_experts, m.top_k
    xf = x.reshape(n, d)

    r = route_tokens(p.router, xf, cfg)
    top_p, top_e = r["top_p"], r["top_e"]
    slot, keep, cap, G, ng = r["slot"], r["keep"], r["cap"], r["G"], r["ng"]

    # --- dispatch: per-group scatter, the sparse D applied ----------------
    idx_e = torch.where(keep, top_e, e).reshape(G, ng * k)
    idx_c = torch.where(keep, slot, 0).reshape(G, ng * k)
    idx_g = torch.arange(G, device=x.device)[:, None].expand(G, ng * k)
    x_rep = xf[:, None, :].expand(n, k, d).reshape(G, ng * k, d)
    buf = x.new_zeros((G, e + 1, cap, d))
    buf.index_put_((idx_g, idx_e, idx_c), x_rep, accumulate=True)
    xe = buf[:, :e]                                     # [G, e, cap, d]

    # --- expert FFN (stationary A: weights never move) ---------------------
    ye = expert_ffn(p, xe, cfg)

    # --- combine: (D * probs)^T @ Y, a gather ------------------------------
    ye_pad = torch.cat([ye, ye.new_zeros((G, 1, cap, d))], dim=1)
    gathered = ye_pad[idx_g, idx_e, idx_c]              # [G, ng*k, d]
    w = torch.where(keep, top_p, 0.0).to(x.dtype)
    y = torch.einsum("nkd,nk->nd", gathered.reshape(n, k, d), w)
    return y.reshape(b, t, d), router_aux(r, cfg)
