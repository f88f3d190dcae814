"""The FSDP x tensor-parallel program of the attention LMs, dense and MoE
(``models/tensor_parallel.py`` through ``models/sharded.py``) against the
JAX package and against one process.

gloo ranks on the CPU, one world a mesh: ``(1, 2)``, ``(2, 2)``, ``(1,
4)`` and ``(1, 8)`` (``torch_sharded_ranks.tp_ranks``).  The cases are the
smoke configs of the four dense families (qwen2.5-3b and llama3-8b and
qwen1.5-110b with one kv head, replicated over ``model``; gemma2-9b with
two, split on a model axis of 2 and not of 4), llama3-8b's with 16 kv
heads on ``(1, 2)``, whose cache is split by head (the others' by
sequence), and gemma2-9b's on ``(1, 8)``, where its 4 q heads stay whole
on every rank (the MLP and the vocabulary split); and the smoke configs
of the two MoE families (olmoe-1b-7b and arctic-480b: 8 experts, top-2,
arctic's dense residual beside them) with ``moe_dispatch_groups`` the
mesh's batch shards, plus OLMoE's at capacity factor 1 with one dispatch
group over both batch shards of ``(2, 2)``, where tokens drop.  On ``(1,
4)`` the ranks also run each autograd collective of ``MeshComm``.  The
JAX package's weights, batches and tokens are written here; its loss,
prefill, decode steps and cache specs come from one child process
(``torch_jax_sharded_child.py tp``), started first so that it runs while
the ranks do.  Tolerances: the loss 1e-4 relative to JAX's (the
distributed checks'), the train steps 1e-4 to one process's, prefill and
decode 1e-5 to JAX's (float32).  A MoE model's aux loss is the global
batch's, as JAX's is, not the mean of the batch shards' (an OLMoE case
with a large aux loss on ``(2, 2)``).  The last test holds the port's dry
run to JAX's own (``repro.launch.dryrun.run_cell``, XLA's compile-time
counts on a CPU for one device of a 16 x 16 mesh) on five production
cells: dense, MoE, SSM (mamba2-130m) and recurrent (recurrentgemma-2b).
The recurrent, SSM and frontend families' cases against JAX are
``test_torch_tp_families.py``'s.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.grid import run_ranks

import torch_jax_sharded_child as child
import torch_sharded_ranks as ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 300
LOSS_TOL = 1e-4
TRAIN_TOL = 1e-4
SERVE_TOL = 1e-5
CASES = [(a, m) for a, m in child.TP_CASES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]
MOE_CASES = list(child.TP_MOE_CASES)
MOE_IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in MOE_CASES]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    child.tp_write_inputs(str(tmp))
    return str(tmp)


@pytest.fixture(scope="module")
def jax_proc(inputs):
    """The JAX child, started at once so that it runs while the ranks do."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(child.__file__)), "tp", inputs],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(inputs, jax_proc):
    """Each mesh's ranks: {dims: [rank results]}."""
    return {dims: run_ranks(dims[0] * dims[1], ranks.tp_ranks, inputs,
                            dims, device="cpu", timeout_s=DEADLINE_S)
            for dims in child.TP_MESHES}


@pytest.fixture(scope="module")
def jax_ref(jax_proc, inputs, worlds):
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    return torch.load(os.path.join(inputs, "jax_tp.pt"), weights_only=False)


@pytest.fixture(scope="module")
def one_process():
    """The port's single-process training of each case (2 steps)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    out = {}
    for name in dict(CASES):
        st = train(child.tp_config(get_config, name), device="cpu",
                   **ranks.TP_TRAIN)
        out[name] = {"losses": st["losses"],
                     "grad_norms": st["grad_norms"],
                     "dropped": st["dropped"],
                     "params": {n: p.detach().numpy() for n, p in
                                st["params"].named_parameters()},
                     "mu": {n: t.numpy() for n, t in st["opt"]["mu"].items()},
                     "nu": {n: t.numpy() for n, t in st["opt"]["nu"].items()}}
    return out


def _results(worlds, name, dims):
    return [r[name] for r in worlds[dims]]


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_dense_families_run_the_tp_program(name, dims, worlds):
    """Every family of the cases, dense and MoE, runs ``"fsdp_tp"``."""
    for r in _results(worlds, name, dims):
        assert r["program"] == "fsdp_tp"


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_loss_equals_jax(name, dims, worlds, jax_ref):
    want = jax_ref[name]["loss"]
    for r in _results(worlds, name, dims):
        assert abs(r["loss"] - want) <= LOSS_TOL * abs(want)


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_train_losses_and_norms_equal_one_process(name, dims, worlds,
                                                  one_process):
    one = one_process[name]
    for r in _results(worlds, name, dims):
        np.testing.assert_allclose(r["train"]["losses"], one["losses"],
                                   rtol=TRAIN_TOL)
        np.testing.assert_allclose(r["train"]["grad_norms"],
                                   one["grad_norms"], rtol=TRAIN_TOL)


@pytest.mark.parametrize("what", ["params", "mu", "nu"])
@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_train_shards_equal_one_process(name, dims, what, worlds,
                                        one_process):
    """Each rank's shard of every parameter and moment after 2 steps is
    its block of the single process's."""
    whole = one_process[name][what]
    for r in _results(worlds, name, dims):
        got = r["train"][what]
        assert sorted(got) == sorted(whole)
        for n, (shard, splits) in got.items():
            want = ranks.block_of(whole[n], splits, r["coord"], dims)
            assert shard.shape == want.shape, n
            np.testing.assert_allclose(shard, want, rtol=TRAIN_TOL,
                                       atol=TRAIN_TOL, err_msg=n)


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_rank_holds_its_sanitized_shards_only(name, dims, worlds):
    for r in _results(worlds, name, dims):
        t = r["train"]
        assert t["param_bytes"] == t["want_bytes"]
        assert t["moment_bytes"] == 2 * t["param_bytes"]


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_prefill_and_decode_equal_jax(name, dims, worlds, jax_ref):
    """The last-token logits of the prefill and each decode step,
    gathered over the batch shards, are JAX's; each rank of a batch shard
    holds the same rows."""
    want = jax_ref[name]["serve"]
    for s, (logits, _) in enumerate(want):
        rows = {}
        for r in _results(worlds, name, dims):
            d = r["coord"][0]
            got = r["serve"][s][0]
            if d in rows:
                np.testing.assert_array_equal(got, rows[d])
            rows[d] = got
        assert sorted(rows) == list(range(dims[0]))
        np.testing.assert_allclose(
            np.concatenate([rows[d] for d in sorted(rows)]), logits,
            rtol=SERVE_TOL, atol=SERVE_TOL, err_msg=f"{name} step {s}")


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_cache_shards_are_jax_caches_under_cache_specs(name, dims, worlds,
                                                       jax_ref):
    """Each rank's cache shards, after the prefill and after every decode
    step, are its block of JAX's caches under JAX's ``cache_specs`` on the
    same mesh: the sequence split over ``model`` (the kv heads do not
    cover the reference's 16-way axis), or the heads for 16 kv heads."""
    specs = jax_ref[name]["specs"][dims]
    axes = ("data", "model")
    sizes = dict(zip(axes, dims))
    split = {sp["k"][1:3].index("model") for sp in specs
             if "model" in sp["k"]}
    assert split == ({1} if name == "kv16" else {0})
    for r in _results(worlds, name, dims):
        coord = dict(zip(axes, r["coord"]))
        for s, (_, layers) in enumerate(jax_ref[name]["serve"]):
            got = r["serve"][s][1]
            assert len(got) == len(layers) == len(specs)
            for i, (g, w, sp) in enumerate(zip(got, layers, specs)):
                for k in w:
                    block = ranks.shard_of(np.asarray(w[k]), sp[k], coord,
                                           sizes)
                    assert g[k].shape == block.shape, (name, s, i, k)
                    np.testing.assert_allclose(
                        g[k], block, rtol=SERVE_TOL, atol=SERVE_TOL,
                        err_msg=f"{name} step {s} layer {i} {k} {coord}")


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_step_moves_no_parameter_over_the_model_axis(name, dims, worlds):
    """A train step gathers each parameter over the batch axes only: the
    one parameter that crosses ``model`` is a tied embedding, exchanged
    all-to-all from its ``[V, d / m]`` shard into the head's ``[V / m,
    d]`` (a rank receives 1/m of what it holds); kv projections move as
    activations, and so does q where the q heads do not divide the axis
    (each rank projects its column shard of q and its rows of ``wo``)."""
    from repro_torch.configs import get_config
    cfg = child.tp_config(get_config, name)
    want = [("all-to-all", "model")] if cfg.tie_embeddings else []
    for r in _results(worlds, name, dims):
        assert [m for m in r["moved"] if m[1] == "model"] == want
        assert all(m[1] == "data" for m in r["moved"]
                   if m not in want), r["moved"]


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_decode_step_moves_no_parameter_over_the_model_axis(name, dims,
                                                            worlds):
    """A decode step reads a tied embedding as it lies, ``[V, d / m]``,
    and all-reduces one token's partial logits instead of exchanging it:
    no parameter crosses ``model``."""
    for r in _results(worlds, name, dims):
        assert all(m[1] == "data" for m in r["moved_decode"]), \
            r["moved_decode"]


@pytest.mark.parametrize("name,dims", MOE_CASES, ids=MOE_IDS)
def test_moe_drops_are_the_global_batchs(name, dims, worlds, jax_ref,
                                         one_process):
    """The share of dropped token-expert assignments is JAX's on the whole
    batch, on every rank, and the train steps' are one process's; the
    capacity-bound case, one dispatch group over both batch shards (a
    token's slot counts the other shard's tokens before it), drops."""
    want = jax_ref[name]["dropped"]
    for r in _results(worlds, name, dims):
        assert abs(r["dropped"] - want) <= 1e-6
        np.testing.assert_allclose(r["train"]["dropped"],
                                   one_process[name]["dropped"], atol=1e-6)
    assert (want > 0) == name.endswith("/cap1")


@pytest.mark.parametrize("name,dims", MOE_CASES, ids=MOE_IDS)
def test_dispatch_buffer_holds_the_ranks_experts_only(name, dims, worlds):
    """A rank's dispatch buffer is ``[groups, e / m + 1, cap, d]``: the
    slots of its own experts and the overflow row, for the groups its
    tokens fall in (one where a group spans several batch shards), one a
    layer, filled once for each of a token's top-k choices; no rank
    allocates another rank's experts' slots."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import route_meta
    cfg = child.tp_config(get_config, name)
    e, m = cfg.moe.n_experts, dims[1]
    n = child.TP_BATCH["batch"] * child.TP_BATCH["seq"]
    cap, groups, _ = route_meta(n, cfg)
    want = (max(groups // dims[0], 1), e // m + 1, cap, cfg.d_model)
    for r in _results(worlds, name, dims):
        assert r["scatters"] == [want] * (cfg.n_layers * cfg.moe.top_k)


AUX_CASE = child.TP_LOSS_CASES[0]


def test_moe_aux_loss_is_the_global_batchs(worlds, jax_ref, inputs):
    """OLMoE with an aux loss weight of 1 on ``(2, 2)``, two dispatch
    groups, whose batch shards route differently: the loss is JAX's (its
    ``router_aux`` takes ``me`` and ``ce`` over every token), and the mean
    of the batch shards' own aux losses (each shard's product of means)
    is not, by more than the tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import convert, lm
    name, dims = AUX_CASE
    want = jax_ref[name]["loss"]
    for r in _results(worlds, name, dims):
        assert abs(r["loss"] - want) <= LOSS_TOL * abs(want)
    cfg = child.tp_config(get_config, name)
    saved = torch.load(os.path.join(inputs, f"{child._file(name)}.pt"),
                       weights_only=False)
    model = convert.params_from_jax(saved["params"], cfg, "cpu")
    halves = [{k: torch.from_numpy(v).chunk(dims[0])[s]
               for k, v in saved["batch"].items()} for s in range(dims[0])]
    with torch.no_grad():
        per_shard = np.mean([float(lm.loss_fn(model, h, cfg)[0])
                             for h in halves])
    assert abs(per_shard - want) > LOSS_TOL * abs(want), (per_shard, want)


@pytest.mark.parametrize("op", ranks.COLLECTIVES)
def test_autograd_collective_and_its_adjoint(op, worlds):
    """Each of ``MeshComm``'s autograd collectives over a model axis of 4:
    the forward and the input's gradient against the same sums made on
    every rank's inputs here (float64)."""
    n = 4
    xs, gs = zip(*(ranks.collective_inputs(op, j) for j in range(n)))
    for r in worlds[(1, 4)]:
        j = r["collectives"]["j"]
        got_y, got_g = r["collectives"][op]
        if op == "copy_to":
            want_y, want_g = xs[j], sum(gs)
        elif op == "reduce_from":
            want_y, want_g = sum(xs), gs[j]
        elif op.startswith("gather"):
            want_y = torch.cat(xs, 1)
            want_g = (sum(gs) if op == "gather_sum" else gs[j]).chunk(
                n, 1)[j]
        else:       # exchange: dim 0 split to its owner, cat along dim 1
            want_y = torch.cat([x.chunk(n, 0)[j] for x in xs], 1)
            want_g = torch.cat([g.chunk(n, 1)[j] for g in gs], 0)
        np.testing.assert_allclose(got_y, want_y.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the dry run's product flops against JAX's, on production cells
# ---------------------------------------------------------------------------
FLOP_CELLS = (("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
              ("olmoe-1b-7b", "prefill_32k"), ("mamba2-130m", "train_4k"),
              ("recurrentgemma-2b", "prefill_32k"))
FLOP_TOL = 0.05


@pytest.fixture(scope="module")
def jax_flops(tmp_path_factory):
    """JAX's ``run_cell`` for one device of a 16 x 16 debug mesh (256 CPU
    devices, the production shape and axis names) in a child, started at
    once so that it runs while the port's dry run does."""
    tmp = tmp_path_factory.mktemp("jax_flops")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES="256",
               REPRO_DRYRUN_MESH="16,16")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    code = ("import json, sys\n"
            "from repro.launch.dryrun import run_cell\n"
            "out = {}\n"
            f"for arch, shape in {FLOP_CELLS!r}:\n"
            "    r = run_cell(arch, shape, 'single', verbose=False)\n"
            "    out[arch + shape] = (r['status'], r.get('hlo_stats', {})"
            ".get('dot_flops'))\n"
            "json.dump(out, open(sys.argv[1], 'w'))\n")
    path = tmp / "flops.json"
    proc = subprocess.Popen([sys.executable, "-c", code, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_dry_run_product_flops_are_jaxs(jax_flops):
    """A rank's product flops in the port's dry run are within 5 % of
    JAX's per device, a MoE model's, an SSM's and a recurrent hybrid's
    too (ZeRO-3 gave 16.0 times them for the dense cells, 15.8 for this
    MoE one: every rank of the model axis computed the whole of each
    product, every expert of it).  Mamba's ``in_proj`` columns and heads
    do not divide the axis: the ranks take ``ceil(n / 16)`` each, as
    GSPMD does."""
    import json

    from repro_torch.launch import dryrun
    got = {}
    for arch, shape in FLOP_CELLS:
        rec = dryrun.run_cell(arch, shape, "single", verbose=False)
        assert rec["status"] == "ok" and rec["program"] == "fsdp_tp", rec
        got[arch + shape] = rec["hlo_stats"]["dot_flops"]
    proc, path = jax_flops
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    want = json.load(open(path))
    for cell in (arch + shape for arch, shape in FLOP_CELLS):
        status, flops = want[cell]
        assert status == "ok"
        assert abs(got[cell] - flops) <= FLOP_TOL * flops, (cell, got[cell],
                                                            flops)
