"""Token-choice Mixture-of-Experts: where the paper's SpMM engine meets the
LM stack.

Port of ``repro/models/moe.py``.  Token-choice routing *is* a sparse x
dense product: the dispatch operator D is a {0,1}-sparse (expert-slots x
tokens) matrix, and dispatch and combine are ``D @ X`` and
``(D * probs)^T @ Y``.  :func:`moe_forward` applies D as a capacity-padded
scatter and gather (the dense reference); the serving engine's
``repro_torch.serving.sparse`` runs the same two products through the plan
API's ``ring_a`` schedule, on the same routing (:func:`route_tokens`).

On a mesh the layer runs as an explicit program on each rank, the
counterpart of the reference's GSPMD partitioning (``moe_specs``: experts
over ``"model"``).  Inside the FSDP x tensor-parallel program
(``models/tensor_parallel.py``, the program a MoE model trains and serves
on a mesh, ``models/sharded.py``), or under ``launch.mesh.set_mesh`` with
this rank's shard of the experts, :func:`moe_forward` is expert-parallel:
every rank of ``model`` routes the same tokens (its batch shard), fills
the slots of its own experts only, ``[G_rank, e / m + 1, cap, d]`` with
the last row the overflow, and combines their outputs, the other experts'
slots read as zeros; the partial outputs are summed over ``model`` (the
``moe.out`` site), with gradients.  The routing is the reference's on the
whole batch, whatever the batch axes split: a token's slot is its rank
within its group over every shard (the shards before it counted through
one all-gather of a ``[G, e]`` count matrix), the capacity that of the
global token count, and the aux and z losses and ``moe_dropped`` those of
the global batch (``me`` and the z loss averaged over the batch axes
before the product, with gradients).  ``cfg.moe_impl == "ring"`` selects
:func:`ring_moe_forward` inside the program or under ``set_mesh``, the
paper's stationary-A ring on the expert axis: experts stay on their rank,
token shards and their partial outputs ride R hops of a
``batch_isend_irecv`` ring, whose gradients ride the hops back (a train
step on a mesh with ``moe_impl="ring"`` runs it; with no mesh the layer
runs :func:`moe_forward`).
:func:`selftest_distributed` and :func:`selftest_ring` hold both rank
bodies against the single-process layer on ``n`` ranks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh, mesh_comm, mesh_sizes
from . import tensor_parallel
from .common import BATCH_AXES, MODEL_AXIS, P, Params, dense_init, gelu_tanh
from .config import ModelConfig

__all__ = ["init_moe", "moe_specs", "moe_forward", "route_tokens",
           "route_meta", "expert_ffn", "router_aux", "ring_moe_forward",
           "ring_stats", "reset_ring_stats", "selftest_distributed",
           "selftest_ring"]

# the hops ring_moe_forward's rank bodies made (this process): forward
# (a recomputation's too) and backward, and the token-expert assignments
# its capacity dropped (a tensor once counted: no host sync a hop)
ring_stats = {"hops": 0, "backward_hops": 0, "dropped": 0}


def reset_ring_stats() -> None:
    ring_stats.update(hops=0, backward_hops=0, dropped=0)


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
                 cfg: ModelConfig, tp=None) -> Dict:
    """Shared router math: softmax -> top-k -> per-group capacity slots.

    ``xf``: [n, d] flat tokens.  Returns a dict of routing tensors (and the
    static ints ``cap``, ``G``, ``ng``, and ``groups``, the groups the
    tokens fall in, with ``group`` each token's among them); both
    :func:`moe_forward` and the serving engine's sparse dispatch call
    this, so the two paths route identically.

    Inside a program (``tp``, a ``TensorParallel``) ``xf`` is part
    ``tp.shard`` of ``tp.shards`` of the batch: the groups, the capacity
    and each token's slot are the whole batch's, the shards before this
    one counted through one all-gather of the ``[G, e]`` counts over the
    batch axes (collective).
    """
    m = cfg.moe
    n = xf.shape[0]
    e, k = m.n_experts, m.top_k
    shards, shard = (tp.shards, tp.shard) if tp is not None else (1, 0)
    cap, G, ng = route_meta(n * shards, cfg)

    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                            # [n, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # per-group capacity assignment (slot = rank within group+expert)
    onehot = F.one_hot(top_e, e).to(torch.int32)               # [n, k, e]
    first = shard * n                  # the first token's global index
    g0 = first // ng
    groups = (first + n - 1) // ng - g0 + 1
    group = (torch.arange(n, device=xf.device) + first) // ng - g0
    flat = onehot.reshape(n * k, e)
    gk = group.repeat_interleave(k)
    counts = flat.new_zeros((groups, e)).index_add_(0, gk, flat)
    # excl, per group: those of the earlier groups here taken off
    ranks = torch.cumsum(flat, dim=0) - flat \
        - (torch.cumsum(counts, dim=0) - counts)[gk]
    if shards > 1:                 # and those of the earlier shards added
        mine = counts.new_zeros((G, e))
        mine[g0:g0 + groups] = counts
        every = tp.comm.all_gather_over(mine[None], tp.batch_axes, 0)
        ranks = ranks + every[:shard, g0:g0 + groups].sum(0)[gk]
    slot = (ranks * flat).sum(-1).reshape(n, k)
    keep = slot < cap
    return {"logits": logits, "probs": probs, "top_p": top_p,
            "top_e": top_e, "slot": slot, "keep": keep, "onehot": onehot,
            "cap": cap, "G": G, "ng": ng, "groups": groups, "group": group,
            "dropped": 1.0 - keep.float().mean()}


def expert_ffn(p: Params, xe: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """Expert MLPs on dispatched slots.  xe: [..., e, cap, d] -> same."""
    return _ffn(p.w_gate, p.w_up, p.w_down, xe, cfg)


def _ffn(w_gate, w_up, w_down, xe, cfg: ModelConfig) -> torch.Tensor:
    act = F.silu if cfg.mlp_kind != "geglu" else gelu_tanh
    g = xe @ w_gate.to(xe.dtype)
    u = xe @ w_up.to(xe.dtype)
    return (act(g) * u) @ w_down.to(xe.dtype)


def router_aux(route: Dict, cfg: ModelConfig, tp=None) -> Dict:
    """Switch-style aux losses + drop stats from :func:`route_tokens`.
    Inside a program whose tokens are a part of the batch (``tp.shards >
    1``) they are the whole batch's: ``me`` and the z loss averaged over
    the batch axes before the product (with gradients), ``ce`` and the
    drops too (collective)."""
    m = cfg.moe
    me = route["probs"].mean(0)                                # [e]
    ce = route["onehot"].float().sum(1).mean(0)                # fraction routed
    z = torch.mean(torch.square(torch.logsumexp(route["logits"], dim=-1)))
    dropped = route["dropped"]
    if tp is not None and tp.shards > 1:
        c, axes = tp.comm, tp.batch_axes
        both = c.mean_over(torch.cat([me, z[None]]), axes)
        me, z = both[:-1], both[-1]
        rest = c.all_reduce(torch.cat([ce, dropped[None]]).detach(), axes,
                            "mean")
        ce, dropped = rest[:-1], rest[-1]
    return {
        "moe_aux": m.aux_loss * m.n_experts * torch.sum(me * ce),
        "moe_z": m.router_z_loss * z,
        "moe_dropped": dropped,
    }


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """x: [B, T, d] -> (y, aux) with load-balance/z losses in aux.

    Dispatch uses per-group capacity: tokens split into G groups, each
    ranks its own tokens and scatters into its own capacity slice (G = 1
    on one card unless the config asks for more).  On a mesh (module
    docstring) the rank fills, runs and combines its own experts' slots,
    and the partial outputs are summed over ``model``.
    """
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    k = m.top_k
    xf = x.reshape(n, d)
    tp = _program(p, cfg)

    r = route_tokens(p.router, xf, cfg, tp)
    top_p, top_e = r["top_p"], r["top_e"]
    slot, keep, cap = r["slot"], r["keep"], r["cap"]
    wg, wu, wd, e0 = tensor_parallel.moe_weights(p, tp)
    el = wg.shape[0]

    # --- dispatch: per-group scatter, the sparse D applied ----------------
    # this rank's experts' slots only; the rest go to the overflow row el
    mine = keep & (top_e >= e0) & (top_e < e0 + el)
    ie = torch.where(mine, top_e - e0, el)
    ic = torch.where(mine, slot, 0)
    ig = r["group"]
    site = tp.site if tp is not None else (lambda name, v: v)
    xin = site("moe.in", xf)
    buf = x.new_zeros((r["groups"], el + 1, cap, d))
    for j in range(k):
        buf.index_put_((ig, ie[:, j], ic[:, j]), xin, accumulate=True)

    # --- expert FFN (stationary A: weights never move) ---------------------
    ye = _ffn(wg, wu, wd, buf[:, :el], cfg)

    # --- combine: (D * probs)^T @ Y, a gather ------------------------------
    ye_pad = torch.cat([ye, ye.new_zeros((r["groups"], 1, cap, d))], dim=1)
    w = site("moe.in", torch.where(keep, top_p, 0.0).to(x.dtype))
    y = ye_pad[ig, ie[:, 0], ic[:, 0]] * w[:, :1]
    for j in range(1, k):
        y = y + ye_pad[ig, ie[:, j], ic[:, j]] * w[:, j:j + 1]
    y = site("moe.out", y)
    return y.reshape(b, t, d), router_aux(r, cfg, tp)


# ---------------------------------------------------------------------------
# On a mesh: expert parallelism and the expert ring
# ---------------------------------------------------------------------------
def _program(p: Params, cfg: ModelConfig):
    """The tensor-parallel program the layer runs in: the current one
    (``tensor_parallel.use``), else, under ``set_mesh`` with ``p`` holding
    this rank's shard of the experts (its leading dimension ``n_experts /
    R`` on a model axis of ``R >= 2``), one over the ambient mesh; None
    (all the experts here) outside both."""
    tp = tensor_parallel.current()
    if tp is not None:
        return tp
    mesh = current_mesh()
    e, el = cfg.moe.n_experts, p.w_gate.shape[0]
    if mesh is None or el == e:
        return None
    r_size = mesh_sizes(mesh).get(MODEL_AXIS, 1)
    if r_size < 2 or el * r_size != e:
        raise ValueError(f"{el} local experts of {e} do not shard over a "
                         f"model axis of {r_size}")
    return tensor_parallel.TensorParallel(cfg, mesh_comm(mesh,
                                                         p.w_gate.device))


def _local_experts(w: torch.Tensor, r: int, el: int) -> torch.Tensor:
    """Rank ``r``'s ``el`` experts of ``w``: ``w`` itself where it holds
    only those (its shard), else its slice."""
    return w if w.shape[0] == el else w[r * el:(r + 1) * el]


class _Hop(torch.autograd.Function):
    """The identity; its backward counts one hop of the ring's backward
    (``ring_stats["backward_hops"]``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ring_stats["backward_hops"] += 1
        return g


def ring_moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    """MoE with the paper's stationary-A schedule (``moe_impl="ring"``), as
    an explicit body on each rank: of the current tensor-parallel program
    (a train step, prefill or decode on a mesh, ``models/sharded.py``),
    else of the ambient mesh (``set_mesh``).

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
    holds it.

    Differentiable, as ``jax.grad`` differentiates the reference's
    ``ppermute`` hops: a hop's gradient rides the reverse hop
    (``MeshComm.shift_along``), the input and the router, which each rank
    reads a part of, sum their gradients over ``model`` (copy-to), the
    output's gather and the aux losses' mean over ``model`` slice theirs
    (every rank's consumer holds the same), the aux losses' mean over the
    batch axes averages them (``MeshComm.mean_over``); the routing
    (``top_e``, slots, ``keep``) carries none.  ``ring_stats["hops"]``
    counts the hops of every forward (a recomputation's too),
    ``["backward_hops"]`` those of the backward.

    Falls back to :func:`moe_forward` (the reference's semantics, not a
    device fallback) with no mesh or model axis, ``R < 2``, or
    ``n_experts`` or ``t`` not divisible by ``R``.  ``p``'s experts may be
    the rank's shard or all of them.
    """
    m = cfg.moe
    b, t, d = x.shape
    tp = tensor_parallel.current()
    mesh = current_mesh()
    comm = tp.comm if tp is not None else (
        mesh_comm(mesh, x.device) if mesh is not None else None)
    if comm is None or MODEL_AXIS not in comm.sizes:
        return moe_forward(p, x, cfg)
    R = comm.size(MODEL_AXIS)
    if R < 2 or m.n_experts % R or t % R:
        return moe_forward(p, x, cfg)
    el, k, tl = m.n_experts // R, m.top_k, t // R
    r = comm.index(MODEL_AXIS)
    batch_axes = [a for a in BATCH_AXES if a in comm.sizes]
    n_loc = b * tl                  # tokens per rank (for the capacity)
    cap = max(int(m.capacity_factor * n_loc * k * el / m.n_experts), k)
    wg, wu, wd = (_local_experts(w, r, el).to(x.dtype)
                  for w in (p.w_gate, p.w_up, p.w_down))
    act = F.silu if cfg.mlp_kind != "geglu" else gelu_tanh

    def mean_all(v):
        # the mean over model (a replicated consumer: slice back), then
        # over the batch axes (each rank's loss a share: average back)
        v = comm.gather_along(v[None], MODEL_AXIS, 0, grad="slice").mean(0)
        return comm.mean_over(v, batch_axes)

    xf = comm.copy_to(x, MODEL_AXIS)[:, r * tl:(r + 1) * tl].reshape(
        n_loc, d)
    router = comm.copy_to(p.router, MODEL_AXIS)
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
             ).to(x.dtype)
    xc, te, tp_ = xf, top_e, top_p
    acc = x.new_zeros((n_loc, d))
    for _ in range(R):
        # prefetch the next shard (paper SS3.3: overlap with compute)
        nxt = comm.shift_along([xc, te, tp_], MODEL_AXIS, 1, wait=False)
        mine = (te // el) == r              # tokens routed to MY experts
        le = torch.where(mine, te - r * el, el)     # el = overflow slot
        flat = F.one_hot(le, el + 1).to(torch.int32).reshape(n_loc * k,
                                                             el + 1)
        slot = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1).reshape(
            n_loc, k)
        keep = mine & (slot < cap)
        if type(mine) is torch.Tensor:      # a dry run's fakes count none
            ring_stats["dropped"] = ring_stats["dropped"] \
                + (mine & ~keep).sum()
        ie = torch.where(keep, le, el)
        ic = torch.where(keep, slot, 0)
        buf = x.new_zeros((el + 1, cap, d))
        buf.index_put_((ie.reshape(-1), ic.reshape(-1)),
                       xc[:, None, :].expand(n_loc, k, d).reshape(-1, d),
                       accumulate=True)
        ye = (act(buf[:el] @ wg) * (buf[:el] @ wu)) @ wd
        ye = torch.cat([ye, ye.new_zeros((1, cap, d))])
        part = torch.einsum("nkd,nk->nd", ye[ie, ic],
                            torch.where(keep, tp_, 0.0).to(x.dtype))
        # the updated partials ride the same hop as the shard
        (acc,) = comm.shift_along([_Hop.apply(acc + part)], MODEL_AXIS, 1)
        xc, te, tp_ = nxt()
        ring_stats["hops"] += 1
    me = mean_all(probs.mean(0))
    ce = comm.all_reduce(F.one_hot(top_e, m.n_experts).float().sum(1)
                         .mean(0), batch_axes + [MODEL_AXIS], "mean")
    z = mean_all(torch.square(torch.logsumexp(logits, -1)).mean())
    aux = {"moe_aux": m.aux_loss * m.n_experts * torch.sum(me * ce),
           "moe_z": m.router_z_loss * z,
           "moe_dropped": torch.zeros((), device=x.device)}
    y = comm.gather_along(acc.reshape(b, tl, d), MODEL_AXIS, 1,
                          grad="slice")
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
