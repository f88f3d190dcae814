"""FSDP a layer at a time (``models/sharded.py``'s ``ShardedModel.running``
through ``transformer._layer`` and ``MeshComm.gather_params``) and a train
step through the expert ring, on gloo ranks on the CPU.

One world of 4 ranks on a ``(2, 2)`` mesh (``torch_fsdp_ranks.fsdp_ranks``)
runs, under an ``OpRecorder`` whose stream marks each FSDP unit's gather,
its drop and each gradient sum: a train step of the dense (qwen2.5-3b)
and MoE (olmoe-1b-7b) smoke configs, with remat (the published configs')
and without (the smoke configs'), and a prefill and a decode step.  The
stream shows the JAX package's scanned FSDP: the top-level parameters
gathered once a step; each layer's gathered after the previous layer's
products, dropped before the next layer's gather, so that a rank never
holds more than its shards, the top level and one layer gathered; with
remat gathered again in the backward, where each layer's gradients are
summed onto the shards as its backward ends (one flat buffer a group).
The same world trains OLMoE with ``moe_impl="ring"`` for 2 steps: equal to
one process's ``dense_onehot`` steps where nothing drops (1e-4, as the
other tests of the program), with R hops a layer in each forward, the
recomputation's and the backward.
"""
import numpy as np
import pytest

from repro_torch.launch.grid import run_ranks

import torch_fsdp_ranks as ranks

DIMS = (2, 2)
DEADLINE_S = 300
TRAIN_TOL = 1e-4
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b")


@pytest.fixture(scope="module")
def world():
    return run_ranks(DIMS[0] * DIMS[1], ranks.fsdp_ranks, DIMS,
                     device="cpu", timeout_s=DEADLINE_S)


def _layers(n: int) -> list:
    return [f"layers.{i}." for i in range(n)]


def _gathers(stream) -> list:
    return [e[1] for e in stream if e[0] == "gather"]


def _windows(stream) -> list:
    """(unit, index of its "gathered" mark, of its "dropped" mark) in
    order, the top level's left out."""
    out, open_at = [], {}
    for i, e in enumerate(stream):
        if e[0] == "gathered" and e[1]:
            open_at[e[1]] = i
        elif e[0] == "dropped" and e[1]:
            out.append((e[1], open_at.pop(e[1]), i))
    return out


def _n_layers(arch):
    return ranks.config(arch, True).n_layers


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_gathers_each_layer_at_its_turn(arch, remat, world):
    """The top level is gathered once, first; then each layer in order,
    and, with remat, each again in reverse order in the backward (the
    recomputation); without, none again."""
    layers = _layers(_n_layers(arch))
    want = [""] + layers + (layers[::-1] if remat else [])
    for r in world:
        assert _gathers(r[f"train/{arch}/{remat}"]["stream"]) == want


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_gathered_after_the_previous_layers_products(arch, remat,
                                                           world):
    """Each layer's window (gathered .. dropped) holds its products, and
    the next layer's gather starts after it closes: the windows follow
    each other and never overlap."""
    for r in world:
        stream = r[f"train/{arch}/{remat}"]["stream"]
        wins = _windows(stream)
        assert len(wins) == len(_gathers(stream)) - 1
        for unit, a, b in wins:
            assert ("product",) in stream[a:b], unit
        for (_, _, b), (_, a, _) in zip(wins, wins[1:]):
            assert b < a


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_holds_one_layer_gathered(arch, world):
    """With remat no layer's gathered parameters outlive its forward
    window; the recomputation's live on through that layer's backward,
    which reads them, and are gone by the next layer's gather: at every
    gather no other layer's are alive, so a rank holds its shards, the
    top level and one layer gathered."""
    n = _n_layers(arch)
    for r in world:
        stream = r[f"train/{arch}/True"]["stream"]
        for e in stream:
            if e[0] == "gather" and e[1]:
                assert e[2] == 0, e
        drops = [e for e in stream if e[0] == "dropped" and e[1]]
        assert len(drops) == 2 * n
        assert [e[2] for e in drops[:n]] == [0] * n


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_unit_gradient_summed_once_a_group(arch, remat, world):
    """Each unit's gradients are summed onto the shards once a group (one
    flat buffer of the group's tensors); with remat each layer's right
    after its recomputed window, before the previous layer's gather, and
    the top level's last."""
    for r in world:
        res = r[f"train/{arch}/{remat}"]
        stream, units = res["stream"], res["units"]
        sums = [e[1] for e in stream if e[0] == "sum"]
        assert sorted(sums) == sorted(n for g in units.values() for n in g)
        if not remat:
            continue
        back = [i for i, e in enumerate(stream) if e[0] == "gather"][
            1 + _n_layers(arch):]
        for i, j in zip(back, back[1:] + [len(stream)]):
            unit = stream[i][1]
            want = units[unit] + (units[""] if j == len(stream) else [])
            got = [e[1] for e in stream[i:j] if e[0] == "sum"]
            assert sorted(got) == sorted(want), unit


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_gathers_each_layer_at_its_turn(arch, world):
    """A prefill and a decode step each gather the top level, then each
    layer at its turn, holding one layer gathered at a time."""
    layers = _layers(_n_layers(arch))
    for r in world:
        stream = r[f"serve/{arch}"]["stream"]
        assert _gathers(stream) == ([""] + layers) * 2
        for e in stream:
            if e[0] in ("gather", "dropped") and e[1]:
                assert e[2] == 0, e


@pytest.fixture(scope="module")
def ring_one_process():
    """One process's ``dense_onehot`` steps of the ring cases' config."""
    from repro_torch.launch.train import train
    out = {}
    for remat in (True, False):
        st = train(ranks.ring_config(remat, "dense_onehot"), device="cpu",
                   **ranks.RING_TRAIN)
        out[remat] = {"losses": st["losses"],
                      "grad_norms": st["grad_norms"],
                      "dropped": st["dropped"],
                      "params": {n: p.detach().numpy() for n, p in
                                 st["params"].named_parameters()}}
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_ring_train_step_equals_one_process(remat, world, ring_one_process):
    """2 steps with ``moe_impl="ring"`` on ``(2, 2)``: losses, gradient
    norms and every shard within 1e-4 of one process's dense steps, no
    token dropped on either path."""
    import torch_sharded_ranks as sharded_ranks
    one = ring_one_process[remat]
    assert max(one["dropped"]) == 0
    for r in world:
        got = r[f"ring/{remat}"]
        assert got["ring_dropped"] == 0 and max(got["dropped"]) == 0
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=TRAIN_TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=TRAIN_TOL)
        for n, (shard, splits) in got["params"].items():
            want = sharded_ranks.block_of(one["params"][n], splits,
                                          r["coord"], DIMS)
            np.testing.assert_allclose(shard, want, rtol=TRAIN_TOL,
                                       atol=TRAIN_TOL, err_msg=n)


@pytest.mark.parametrize("remat", [True, False])
def test_ring_hops_forward_recompute_and_backward(remat, world):
    """R hops a MoE layer in each forward (the recomputation's too, with
    remat) and in each backward."""
    steps, R = ranks.RING_TRAIN["steps"], DIMS[1]
    n_moe = _n_layers("olmoe-1b-7b")
    for r in world:
        got = r[f"ring/{remat}"]
        assert got["hops"] == steps * n_moe * R * (2 if remat else 1)
        assert got["backward_hops"] == steps * n_moe * R
