"""``repro_torch.launch.dryrun`` against the JAX package's dry run.

Input specs, model flops and each rank's parameter and moment bytes equal
JAX's for every config of the registry (JAX's per-rank bytes from
``NamedSharding(AbstractMesh, spec).shard_shape``, no devices; the port's
from its dry run's own state under ``FakeTensorMode`` on a fake world of
256 / 512 ranks).  And the counterpart of ``test_dryrun_specs.py``'s
debug-mesh cell, fast: smoke cells on ``REPRO_DRYRUN_MESH=2,2`` (and one
dense cell on ``1,2``, the tensor-parallel program with the whole batch
on one data shard) come out ``ok`` with the flops, collective bytes and
argument bytes that a real gloo run of the same step on as many ranks
records.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

jax.devices()           # initialised before the JAX dry run is imported
with warnings.catch_warnings():
    warnings.simplefilter("ignore", RuntimeWarning)
    from repro.launch import dryrun as jdry     # noqa: E402

from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.configs import SHAPES as JSHAPES, get_config as jget  # noqa: E402
from repro.launch.mesh import sanitize_spec as jsanitize  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import SHAPES, Shape, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import use_comm  # noqa: E402
from repro_torch.launch.op_analysis import OpRecorder, RecordingComm  # noqa: E402
from torch_dryrun_ranks import SERVE, SERVE_ARCHS  # noqa: E402

ARCHS = list_archs()


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    """Every shape on a (1, 1) mesh: exact ``seq`` tokens at prefill,
    frames for audio, patches + text for a vlm, ``seq + 1`` at train."""
    mesh = jmake_mesh((1, 1), ("data", "model"))
    for name, shape in SHAPES.items():
        want = jdry.input_specs(jget(arch), JSHAPES[name], mesh)
        got = dryrun.input_specs(get_config(arch), shape,
                                 {"data": 1, "model": 1})
        assert set(got) == set(want), (arch, name)
        for k, w in want.items():
            assert got[k].shape == tuple(w.shape), (arch, name, k)
            assert _dtype_name(got[k].dtype) == str(w.dtype), (arch, name, k)
    if arch == "llama3-8b":
        pre = dryrun.input_specs(get_config(arch), SHAPES["prefill_32k"],
                                 {"data": 1, "model": 1})
        assert pre["tokens"].shape == (32, 32768)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    for name, shape in SHAPES.items():
        assert dryrun._model_flops(get_config(arch), shape) \
            == jdry._model_flops(jget(arch), JSHAPES[name])


def _jax_rank_bytes(cfg, dims, axes) -> tuple:
    """JAX's per-rank parameter and AdamW-state bytes: each leaf's
    ``NamedSharding(mesh, sanitized spec).shard_shape``."""
    mesh = AbstractMesh(dims, axes)
    params = jax.eval_shape(lambda k: jtf.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    opt = JAdamW(lr=1e-4)
    state = jax.eval_shape(opt.init, params)

    def total(tree, specs):
        leaves = jax.tree.leaves(jax.tree.map(
            lambda s, x: int(np.prod(NamedSharding(
                mesh, jsanitize(s, x.shape, mesh)).shard_shape(x.shape)))
            * x.dtype.itemsize, specs, tree,
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
        return sum(leaves)

    pspecs = jtf.param_specs(cfg)
    return total(params, pspecs), total(state, JAdamW.state_specs(pspecs))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_param_and_moment_bytes_equal_jax(arch, mesh_kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    dims = dryrun.PRODUCTION_MESH[mesh_kind]
    axes = ("pod", "data", "model")[-len(dims):]
    want = _jax_rank_bytes(jget(arch), dims, axes)
    with dryrun.fake_world(dims) as mesh:
        comm = RecordingComm(mesh, "cpu", OpRecorder(), transport=False)
        with use_comm(comm), FakeTensorMode():
            args, _ = dryrun.build_cell(get_config(arch),
                                        SHAPES["train_4k"], mesh, "cpu")
        got = (dryrun._storage_bytes(args["params"])[0],
               dryrun._storage_bytes(args["moments"])[0])
    assert got == want


# ---------------------------------------------------------------------------
# smoke cells on a 2x2 debug mesh against a real 4-rank gloo run
# ---------------------------------------------------------------------------
MESH_2x2 = (2, 2)
CELLS = (("mamba2-130m", "train", 32, 8), ("qwen2.5-3b", "decode", 32, 4),
         ("olmoe-1b-7b", "prefill", 16, 4))
#: a dense cell on a (1, 2) mesh: model > 1, one batch shard
CELLS_1x2 = (("llama3-8b", "train", 16, 4),)


@pytest.fixture(scope="module")
def serve_ref(tmp_path_factory):
    """For each serving arch: the JAX package's smoke weights and tokens,
    written for the ranks, and JAX's ``lm.prefill`` then
    ``make_decode_step`` on them (float32 caches; each decode step fed the
    next token of its row): the logits and the per-layer caches after the
    prefill and after each step."""
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro_torch.models.convert import unstack_layers
    tmp = tmp_path_factory.mktemp("dryrun_serve")
    n, p, max_len = SERVE["prompt"], SERVE["steps"], SERVE["max_len"]
    out = {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = jget(arch, smoke=True)
        params = jtf.init_params(cfg, jax.random.PRNGKey(i))
        toks = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (SERVE["batch"], n + p)).astype(np.int32)
        torch.save({"params": jax.tree.map(np.asarray, params),
                    "tokens": toks}, tmp / f"{arch}.pt")
        logits, caches, pos = jlm.prefill(
            params, {"tokens": jnp.asarray(toks[:, :n])}, cfg, max_len,
            jnp.float32)
        seen = [(logits, caches)]
        step = jlm.make_decode_step(cfg)
        for t in range(n, n + p):
            logits, caches = step(params, jnp.asarray(toks[:, t:t + 1]),
                                  caches, pos)
            pos = pos + 1
            seen.append((logits, caches))
        out[arch] = [(np.asarray(lg), unstack_layers(
            get_config(arch, smoke=True), jax.tree.map(np.asarray, c)))
            for lg, c in seen]
    return str(tmp), out


@pytest.fixture(scope="module")
def four(serve_ref):
    from repro_torch.launch.grid import run_ranks
    import torch_dryrun_ranks
    return run_ranks(4, torch_dryrun_ranks.ranks, CELLS, serve_ref[0],
                     device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def two():
    from repro_torch.launch.grid import run_ranks
    import torch_dryrun_ranks
    return run_ranks(2, torch_dryrun_ranks.cell_rank, CELLS_1x2, (1, 2),
                     device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def gloo(four, two):
    """Each cell's rank-0 record and its mesh, in ``CELLS + CELLS_1x2``
    order."""
    return [(r, MESH_2x2) for r in four[0]["cells"]] \
        + [(r, (1, 2)) for r in two[0]]


@pytest.mark.parametrize("cell", range(len(CELLS) + len(CELLS_1x2)))
def test_debug_mesh_cell_equals_a_gloo_run(gloo, cell, monkeypatch,
                                           tmp_path):
    import json
    want, mesh = gloo[cell]
    monkeypatch.setenv("REPRO_DRYRUN_MESH", ",".join(map(str, mesh)))
    arch, kind, seq, batch = (CELLS + CELLS_1x2)[cell]
    out = str(tmp_path / "cell.json")
    rec = dryrun.run_cell(arch, kind, "single", out, verbose=False,
                          cfg=get_config(arch, smoke=True),
                          shape=Shape(kind, kind, seq, batch))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec == json.load(open(out)) | {"time": rec["time"]}
    assert rec["n_chips"] == mesh[0] * mesh[1]
    assert rec["program"] == "fsdp_tp"
    stats = rec["hlo_stats"]
    assert stats["dot_flops"] == want["dot_flops"] > 0
    assert stats["collective_bytes"] == want["collective_bytes"]
    assert stats["collective_count"] == want["collective_count"]
    assert stats["collective_sent"] == want["collective_sent"]
    assert sum(stats["collective_sent"].values()) == want["sent"]
    assert rec["arguments"] == want["arguments"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] \
        == want["argument_size_in_bytes"]
    assert rec["roofline"]["bottleneck"] in (
        "compute_s", "memory_s", "collective_s")
    assert rec["fits"] is True


def test_record_has_every_key_of_jax_and_fits():
    """The record's keys are JAX's (``dryrun.py``'s ``rec.update``) plus
    ``fits``; an unsupported cell is skipped as in JAX."""
    rec = dryrun.run_cell("qwen2.5-3b", "train_small", "single",
                          verbose=False,
                          cfg=get_config("qwen2.5-3b", smoke=True),
                          shape=Shape("train_small", "train", 16, 2),
                          mesh_shape=(1, 1))
    for key in ("arch", "shape", "mesh", "time", "status", "n_chips",
                "compile_seconds", "memory_analysis", "cost_analysis",
                "hlo_stats", "roofline", "fits"):
        assert key in rec, key
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes"):
        assert rec["memory_analysis"][key] > 0
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck",
                "model_flops", "useful_flops_ratio"):
        assert key in rec["roofline"]
    assert rec["roofline"]["collective_s"] == 0      # one rank sends nothing
    skip = dryrun.run_cell("llama3-8b", "long_500k", "single", verbose=False)
    assert skip["status"] == "skipped" and "quadratic" in skip["reason"]


def test_a_failing_cell_is_reported(monkeypatch):
    """A cell whose step raises inside the fake world is its record (the
    error and its traceback), and the world is torn down."""
    from repro_torch.models import sharded

    def refused(cfg, optimizer):
        raise RuntimeError(f"{cfg.name}: this step is refused")

    monkeypatch.setattr(sharded, "make_sharded_train_step", refused)
    rec = dryrun.run_cell("olmoe-1b-7b", "train_small", "single",
                          verbose=False,
                          cfg=get_config("olmoe-1b-7b", smoke=True),
                          shape=Shape("train_small", "train", 16, 8),
                          mesh_shape=(1, 2))
    assert rec["status"] == "error"
    assert "this step is refused" in rec["error"] and rec["traceback"]
    assert not torch.distributed.is_initialized()


def test_the_ring_train_cell_runs(monkeypatch):
    """Under ``REPRO_MOE_IMPL=ring`` a MoE train cell runs the expert ring
    forward and backward (R hops a MoE layer each way) in the
    tensor-parallel program."""
    from repro_torch.models import moe
    monkeypatch.setenv("REPRO_MOE_IMPL", "ring")
    moe.reset_ring_stats()
    cfg = get_config("olmoe-1b-7b", smoke=True)
    rec = dryrun.run_cell("olmoe-1b-7b", "train_small", "single",
                          verbose=False, cfg=cfg,
                          shape=Shape("train_small", "train", 16, 8),
                          mesh_shape=(1, 2))
    assert rec["status"] == "ok" and rec["program"] == "fsdp_tp", rec
    assert rec["hlo_stats"]["dot_flops"] > 0
    n_moe = cfg.n_layers
    assert moe.ring_stats["hops"] == 2 * n_moe * (2 if cfg.remat else 1)
    assert moe.ring_stats["backward_hops"] == 2 * n_moe


# ---------------------------------------------------------------------------
# the sharded serving programs the prefill and decode cells describe
# ---------------------------------------------------------------------------
SERVE_TOL = 1e-5


def _jax_layer_specs(arch, caches, dims, axes) -> list:
    """JAX's ``cache_specs`` sanitized on a mesh of ``dims`` against the
    grouped cache shapes, one dict a layer (the stacking dimension
    dropped), in the order of ``convert.unstack_layers``."""
    from repro.models.transformer import layer_plan
    cfg = jget(arch, smoke=True)
    mesh = AbstractMesh(dims, axes)
    specs = jtf.cache_specs(cfg)
    out = []
    for gi, (unit, n_units) in enumerate(layer_plan(cfg)):
        group = [{k: tuple(jsanitize(s, caches[gi][li][k].shape, mesh))[1:]
                  for k, s in specs[gi][li].items()}
                 for li in range(len(unit))]
        out += [group[li] for _ in range(n_units) for li in range(len(unit))]
    return out


def _shard_of(x: np.ndarray, spec, coord: dict, sizes: dict) -> np.ndarray:
    """The block of ``x`` a mesh position holds under a JAX spec: each
    dimension cut into the product of its axes' sizes, the position's
    index in them row-major."""
    index = []
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        pos, parts = 0, 1
        for a in names:
            pos, parts = pos * sizes[a] + coord[a], parts * sizes[a]
        size = x.shape[d] // parts
        index.append(slice(pos * size, (pos + 1) * size))
    return x[tuple(index)]


@pytest.fixture(scope="module")
def grouped_caches(serve_ref):
    """JAX's grouped cache tree of each arch (for the shapes its specs are
    sanitized against)."""
    import jax.numpy as jnp
    return {arch: jax.eval_shape(lambda: jtf.init_cache(
        jget(arch, smoke=True), SERVE["batch"], SERVE["max_len"],
        jnp.float32)) for arch in SERVE_ARCHS}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_equal_jax(arch, four, serve_ref):
    """The last-token logits of ``sharded_prefill`` and of each
    ``make_sharded_decode_step``, gathered over the batch shards, are
    JAX's ``lm.prefill`` and decode step's on the same weights and
    tokens; each rank of a batch shard holds the same rows."""
    want = serve_ref[1][arch]
    sizes = dict(zip(("data", "model"), MESH_2x2))
    for s, (logits, _) in enumerate(want):
        rows = {}
        for r in four:
            d = r["serve"]["coord"][0]
            got = r["serve"][arch]["logits"][s]
            if d in rows:
                np.testing.assert_array_equal(got, rows[d])
            rows[d] = got
        assert sorted(rows) == list(range(sizes["data"]))
        np.testing.assert_allclose(
            np.concatenate([rows[d] for d in sorted(rows)]), logits,
            rtol=SERVE_TOL, atol=SERVE_TOL, err_msg=f"{arch} step {s}")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_cache_shards_are_jax_caches_under_cache_specs(
        arch, four, serve_ref, grouped_caches):
    """Each rank's cache shards, after the prefill and after every decode
    step, are its block of JAX's cache under JAX's ``cache_specs`` on the
    same 2x2 mesh (the kv sequence, the Mamba heads and the RG-LRU width
    cut over ``model``, the batch over ``data``)."""
    axes = ("data", "model")
    sizes = dict(zip(axes, MESH_2x2))
    specs = _jax_layer_specs(arch, grouped_caches[arch], MESH_2x2, axes)
    assert any(any(e is not None for e in sp[1:])
               for layer in specs for sp in layer.values())
    want = serve_ref[1][arch]
    assert len(want) == 1 + SERVE["steps"]
    for r in four:
        coord = dict(zip(axes, r["serve"]["coord"]))
        for s, (_, layers) in enumerate(want):
            got = r["serve"][arch]["caches"][s]
            assert len(got) == len(layers) == len(specs)
            for i, (g, w, sp) in enumerate(zip(got, layers, specs)):
                assert set(g) == set(w), (arch, i)
                for k in w:
                    block = _shard_of(np.asarray(w[k]), sp[k], coord, sizes)
                    assert g[k].shape == block.shape, (arch, s, i, k)
                    np.testing.assert_allclose(
                        g[k], block, rtol=SERVE_TOL, atol=SERVE_TOL,
                        err_msg=f"{arch} step {s} layer {i} {k} {coord}")
