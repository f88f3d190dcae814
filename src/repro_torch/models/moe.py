"""Token-choice Mixture-of-Experts: where the paper's SpMM engine meets the
LM stack.

Port of ``repro/models/moe.py``.  Token-choice routing *is* a sparse x
dense product: the dispatch operator D is a {0,1}-sparse (expert-slots x
tokens) matrix, and dispatch and combine are ``D @ X`` and
``(D * probs)^T @ Y``.  :func:`moe_forward` applies D as a capacity-padded
scatter and gather (the dense reference); the serving engine's
``repro_torch.serving.sparse`` runs the same two products through the plan
API's ``ring_a`` schedule, on the same routing (:func:`route_tokens`).

On a mesh (``launch.mesh.set_mesh``) with a ``"model"`` axis the layer
runs as an explicit program on each rank, the counterpart of the
reference's ``shard_map`` and GSPMD partitioning.  A rank whose
parameters hold its shard of the experts (``moe_specs``: experts over
``"model"``) runs :func:`moe_forward` expert-parallel: every rank routes
and dispatches all of its tokens, applies its own experts to their slice
of the capacity buffer, and the outputs are all-gathered over the expert
axis.  ``cfg.moe_impl == "ring"`` selects :func:`ring_moe_forward`, the
paper's stationary-A ring on the expert axis: experts stay on their rank,
token shards and their partial outputs ride R hops of a
``batch_isend_irecv`` ring.  Both rank bodies compute forward values (the
serving and evaluation paths); a train step on a mesh gathers the
experts whole (``launch/train.py``), so no gradient crosses a ring hop.
:func:`selftest_distributed` and :func:`selftest_ring` hold them against
the single-process layer on ``n`` ranks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh, mesh_comm, mesh_sizes
from .common import BATCH_AXES, MODEL_AXIS, P, Params, dense_init, gelu_tanh
from .config import ModelConfig

__all__ = ["init_moe", "moe_specs", "moe_forward", "route_tokens",
           "route_meta", "expert_ffn", "router_aux", "ring_moe_forward",
           "ring_stats", "reset_ring_stats", "selftest_distributed",
           "selftest_ring"]

# the hops ring_moe_forward's rank bodies made (this process)
ring_stats = {"hops": 0}


def reset_ring_stats() -> None:
    ring_stats.update(hops=0)


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    return Params(router=dense_init(gen, (d, e)),
                  w_gate=dense_init(gen, (e, d, f), in_axis=1),
                  w_up=dense_init(gen, (e, d, f), in_axis=1),
                  w_down=dense_init(gen, (e, f, d), in_axis=1))


def moe_specs(cfg: ModelConfig) -> Dict:
    return {
        "router": P(None, None),
        "w_gate": P(MODEL_AXIS, "data", None),
        "w_up": P(MODEL_AXIS, "data", None),
        "w_down": P(MODEL_AXIS, None, "data"),
    }


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
    comm = _expert_shard(p, cfg)
    if comm is None:
        ye = expert_ffn(p, xe, cfg)
    else:                       # this rank's experts, then all of them
        el, ri = p.w_gate.shape[0], comm.index(MODEL_AXIS)
        ye = comm.all_gather(expert_ffn(p, xe[:, ri * el:(ri + 1) * el],
                                        cfg), MODEL_AXIS, dim=1)

    # --- combine: (D * probs)^T @ Y, a gather ------------------------------
    ye_pad = torch.cat([ye, ye.new_zeros((G, 1, cap, d))], dim=1)
    gathered = ye_pad[idx_g, idx_e, idx_c]              # [G, ng*k, d]
    w = torch.where(keep, top_p, 0.0).to(x.dtype)
    y = torch.einsum("nkd,nk->nd", gathered.reshape(n, k, d), w)
    return y.reshape(b, t, d), router_aux(r, cfg)


# ---------------------------------------------------------------------------
# On a mesh: expert parallelism and the expert ring
# ---------------------------------------------------------------------------
def _no_grad_through(*ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the MoE rank bodies compute forward values only (no gradient "
            "crosses their collectives); a train step on a mesh gathers the "
            "experts whole (repro_torch.launch.train)")


def _expert_shard(p: Params, cfg: ModelConfig):
    """The mesh's collectives when ``p`` holds this rank's shard of the
    experts (its leading dimension ``n_experts / R`` on a model axis of
    ``R >= 2``), else None (all the experts here)."""
    mesh = current_mesh()
    e, el = cfg.moe.n_experts, p.w_gate.shape[0]
    if mesh is None or el == e:
        return None
    r_size = mesh_sizes(mesh).get(MODEL_AXIS, 1)
    if r_size < 2 or el * r_size != e:
        raise ValueError(f"{el} local experts of {e} do not shard over a "
                         f"model axis of {r_size}")
    _no_grad_through(p.w_gate)
    return mesh_comm(mesh, p.w_gate.device)


def _local_experts(w: torch.Tensor, r: int, el: int) -> torch.Tensor:
    """Rank ``r``'s ``el`` experts of ``w``: ``w`` itself where it holds
    only those (its shard), else its slice."""
    return w if w.shape[0] == el else w[r * el:(r + 1) * el]


def ring_moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    """MoE with the paper's stationary-A schedule (``moe_impl="ring"``), as
    an explicit body on each rank of the ambient mesh.

    Experts stay on their ``"model"``-axis rank (stationary A).  The rank
    takes its shard of the sequence (``x``: the rank's batch shard, whole
    on the model axis), routes it, and the shard rides R hops around the
    expert ring (coordinate i receives from i + 1, the reference's perm
    ``[((i + 1) % R, i)]``): at each hop the rank starts sending the shard
    on (prefetch) before it applies its local experts to the shard it
    holds, and the updated partial outputs ride the same hop, so after R
    hops every shard is home and fully accumulated.  The capacity is the
    reference's, from ``nl = b * (t / R)`` tokens per rank, and the aux
    losses are averaged over every axis of the mesh (``pmean``);
    ``moe_dropped`` is 0, as there.  The shards are then all-gathered, so
    the layer returns the whole sequence as the rest of the rank's stack
    holds it.  ``ring_stats["hops"]`` counts the hops.

    Falls back to :func:`moe_forward` (the reference's semantics, not a
    device fallback) with no mesh or model axis, ``R < 2``, or
    ``n_experts`` or ``t`` not divisible by ``R``.  ``p``'s experts may be
    the rank's shard or all of them; forward values only.
    """
    mesh = current_mesh()
    m = cfg.moe
    b, t, d = x.shape
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    if MODEL_AXIS not in sizes:
        return moe_forward(p, x, cfg)
    R = sizes[MODEL_AXIS]
    if R < 2 or m.n_experts % R or t % R:
        return moe_forward(p, x, cfg)
    _no_grad_through(x, p.w_gate, p.router)
    comm = mesh_comm(mesh, x.device)
    el, k, tl = m.n_experts // R, m.top_k, t // R
    r = comm.index(MODEL_AXIS)
    all_axes = [a for a in BATCH_AXES if a in sizes] + [MODEL_AXIS]
    n_loc = b * tl                  # tokens per rank (for the capacity)
    cap = max(int(m.capacity_factor * n_loc * k * el / m.n_experts), k)
    wg, wu, wd = (_local_experts(w, r, el).to(x.dtype)
                  for w in (p.w_gate, p.w_up, p.w_down))
    act = F.silu if cfg.mlp_kind != "geglu" else gelu_tanh

    xf = x[:, r * tl:(r + 1) * tl].reshape(n_loc, d)
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
             ).to(x.dtype)
    xc, te, tp = xf, top_e, top_p
    acc = x.new_zeros((n_loc, d))
    for _ in range(R):
        # prefetch the next shard (paper SS3.3: overlap with compute)
        nxt = comm.shift([xc, te, tp], MODEL_AXIS, 1, wait=False)
        mine = (te // el) == r              # tokens routed to MY experts
        le = torch.where(mine, te - r * el, el)     # el = overflow slot
        flat = F.one_hot(le, el + 1).to(torch.int32).reshape(n_loc * k,
                                                             el + 1)
        slot = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1).reshape(
            n_loc, k)
        keep = mine & (slot < cap)
        ie = torch.where(keep, le, el)
        ic = torch.where(keep, slot, 0)
        buf = x.new_zeros((el + 1, cap, d))
        buf.index_put_((ie.reshape(-1), ic.reshape(-1)),
                       xc[:, None, :].expand(n_loc, k, d).reshape(-1, d),
                       accumulate=True)
        ye = (act(buf[:el] @ wg) * (buf[:el] @ wu)) @ wd
        ye = torch.cat([ye, ye.new_zeros((1, cap, d))])
        part = torch.einsum("nkd,nk->nd", ye[ie, ic],
                            torch.where(keep, tp, 0.0).to(x.dtype))
        # the updated partials ride the same hop as the shard
        (acc,) = comm.shift([acc + part], MODEL_AXIS, 1)
        xc, te, tp = nxt()
        ring_stats["hops"] += 1
    me = comm.all_reduce(probs.mean(0), all_axes, "mean")
    ce = comm.all_reduce(F.one_hot(top_e, m.n_experts).float().sum(1)
                         .mean(0), all_axes, "mean")
    z = comm.all_reduce(torch.square(torch.logsumexp(logits, -1)).mean(),
                        all_axes, "mean")
    aux = {"moe_aux": m.aux_loss * m.n_experts * torch.sum(me * ce),
           "moe_z": m.router_z_loss * z,
           "moe_dropped": torch.zeros((), device=x.device)}
    y = comm.all_gather(acc.reshape(b, tl, d), MODEL_AXIS, dim=1)
    return y, aux


# ---------------------------------------------------------------------------
# Distributed equivalence checks (launch/selftest.py)
# ---------------------------------------------------------------------------
def _selftest_cfg(n_devices: int, name: str, capacity_factor: float
                  ) -> ModelConfig:
    from .config import MoEConfig
    return ModelConfig(
        name=name, family="moe", n_layers=1, d_model=16, n_heads=2,
        n_kv_heads=1, d_ff=32, vocab_size=64, compute_dtype="float32",
        moe=MoEConfig(n_experts=n_devices * 2, top_k=2, d_ff_expert=32,
                      capacity_factor=capacity_factor))


def _selftest_rank(dev, n_devices: int, ring: bool) -> float:
    """One rank of :func:`selftest_distributed` / :func:`selftest_ring`:
    the largest difference between the layer on the ``(1, n)`` mesh, with
    this rank's experts only, and the single-process layer."""
    from ..launch.mesh import make_mesh, set_mesh
    cfg = _selftest_cfg(n_devices, "moe-ring-selftest" if ring
                        else "moe-selftest", 16.0 if ring else 8.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        p = init_moe(cfg, gen)
        shape = (2, n_devices * 4, 16) if ring else (4, 8, 16)
        x = torch.randn(shape, generator=gen, device=dev)
        y_ref, _ = moe_forward(p, x, cfg)
        mesh = make_mesh((1, n_devices), ("data", MODEL_AXIS),
                         device_type=dev.type)
        r = mesh.get_coordinate()[1]
        el = cfg.moe.n_experts // n_devices
        local = Params(router=p.router, **{
            k: getattr(p, k)[r * el:(r + 1) * el]
            for k in ("w_gate", "w_up", "w_down")})
        with set_mesh(mesh):
            y, _ = (ring_moe_forward if ring else moe_forward)(local, x, cfg)
    return float((y - y_ref).abs().max())


def _selftest(n_devices: int, ring: bool, device) -> bool:
    from ..launch.grid import run_ranks
    errs = run_ranks(n_devices, _selftest_rank, n_devices, ring,
                     device=device, timeout_s=300)
    return max(errs) < 1e-4


def selftest_distributed(n_devices: int, device=None) -> bool:
    """Expert-parallel MoE on ``n_devices`` ranks (a ``(1, n)`` mesh, each
    rank holding its experts) == the single-process MoE, on ``device``
    (the cards by default)."""
    return _selftest(n_devices, False, device)


def selftest_ring(n_devices: int, device=None) -> bool:
    """Ring dispatch on ``n_devices`` ranks == dense dispatch (no drops)."""
    return _selftest(n_devices, True, device)
