"""The FSDP x tensor-parallel program of the recurrent, SSM and frontend
families (``models/rglru.py``, ``models/ssm.py``, ``models/frontend.py``
through ``models/tensor_parallel.py`` and ``models/sharded.py``) against
the JAX package and against one process.

gloo ranks on the CPU, one world a mesh: ``(1, 2)``, ``(2, 2)``, ``(1,
4)``, ``(1, 8)`` and ``(1, 3)`` (``torch_sharded_ranks.fam_ranks``).  The
cases (``torch_jax_sharded_child.FAM_CASES``) are the smoke configs of
mamba2-130m, recurrentgemma-2b, hubert-xlarge and llava-next-mistral-7b
on the first three meshes; recurrentgemma-2b's on ``(1, 8)``, where its 4
q heads do not divide the axis; a Mamba shaped like mamba2-130m on a
model axis of 16 (``/d48``: neither ``in_proj``'s 230 columns, the 6
heads nor the vocabulary divide 4, the conv's channels and ``out_proj``'s
rows do) on ``(1, 4)``; and an RG-LRU 48 wide on ``(1, 3)`` (``/w48``: a
rank's 16 channels end inside a gate block of 6, as 160 channels a rank
do in blocks of 320 at 16; no other layer divides 3).  The JAX package's
weights, batches, tokens and patches are written here; its loss, prefill
(an encoder's forward), decode steps and cache specs come from one child
process (``torch_jax_sharded_child.py fam``), started first so that it
runs while the ranks do.  Tolerances as ``test_torch_tp.py``'s: the loss
1e-4 relative to JAX's, the train steps 1e-4 to one process's, prefill
and decode 1e-5 to JAX's (float32).
"""
import dataclasses
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
CASES = list(child.FAM_CASES)
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]
#: the cases with a decode cache (hubert is an encoder)
CACHE_CASES = [(a, m) for a, m in CASES if not a.startswith("hubert")]
CACHE_IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CACHE_CASES]


def _cfg(name):
    from repro_torch.configs import get_config
    return child.tp_config(get_config, name)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fam")
    child.tp_write_inputs(str(tmp), child.FAM_ARCHS)
    return str(tmp)


@pytest.fixture(scope="module")
def jax_proc(inputs):
    """The JAX child, started at once so that it runs while the ranks do."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(child.__file__)), "fam", inputs],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(inputs, jax_proc):
    """Each mesh's ranks: {dims: [rank results]}."""
    return {dims: run_ranks(dims[0] * dims[1], ranks.fam_ranks, inputs,
                            dims, device="cpu", timeout_s=DEADLINE_S)
            for dims in child.FAM_MESHES}


@pytest.fixture(scope="module")
def jax_ref(jax_proc, inputs, worlds):
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    return torch.load(os.path.join(inputs, "jax_fam.pt"), weights_only=False)


@pytest.fixture(scope="module")
def one_process():
    """The port's single-process training of each config (2 steps)."""
    from repro_torch.launch.train import train
    out = {}
    for name in dict(CASES):
        st = train(_cfg(name), device="cpu", **ranks.TP_TRAIN)
        out[name] = {"losses": st["losses"],
                     "grad_norms": st["grad_norms"],
                     "params": {n: p.detach().numpy() for n, p in
                                st["params"].named_parameters()},
                     "mu": {n: t.numpy() for n, t in st["opt"]["mu"].items()},
                     "nu": {n: t.numpy() for n, t in st["opt"]["nu"].items()}}
    return out


def _results(worlds, name, dims):
    return [r[name] for r in worlds[dims]]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3-8b", "gemma2-9b",
                                  "qwen1.5-110b", "olmoe-1b-7b",
                                  "arctic-480b", "mamba2-130m",
                                  "recurrentgemma-2b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_every_config_runs_the_tp_program(arch):
    """Every config of the registry, full and smoke, runs ``"fsdp_tp"``;
    a layer kind or frontend without a program on a mesh raises rather
    than run another program."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import sharded
    assert arch in list_archs()
    for smoke in (False, True):
        assert sharded.program(get_config(arch, smoke=smoke)) == "fsdp_tp"
    cfg = get_config(arch, smoke=True)
    for bad in (dict(layer_pattern="x"), dict(frontend="video")):
        with pytest.raises(ValueError, match="no tensor-parallel program"):
            sharded.program(dataclasses.replace(cfg, **bad))


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_loss_equals_jax(name, dims, worlds, jax_ref):
    want = jax_ref[name]["loss"]
    for r in _results(worlds, name, dims):
        assert r["program"] == "fsdp_tp"
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
    """The last-token logits of the prefill and each decode step (an
    encoder's logits at every frame), gathered over the batch shards, are
    JAX's; each rank of a batch shard holds the same rows."""
    want = jax_ref[name]["serve"]
    assert len(want) == (1 if name.startswith("hubert")
                         else 1 + child.TP_SERVE["steps"])
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


@pytest.mark.parametrize("name,dims", CACHE_CASES, ids=CACHE_IDS)
def test_cache_shards_are_jax_caches_under_cache_specs(name, dims, worlds,
                                                       jax_ref):
    """Each rank's cache shards, after the prefill and after every decode
    step, are its block of JAX's caches under JAX's ``cache_specs`` on the
    same mesh: a recurrent state by channel, an SSM state by head and its
    conv state by channel where the axis divides them (whole where it does
    not: the ``/d48`` Mamba's 6 heads on 4), an attention cache by
    sequence."""
    specs = jax_ref[name]["specs"][dims]
    axes = ("data", "model")
    sizes = dict(zip(axes, dims))
    cfg = _cfg(name)
    split = {k for sp in specs for k, v in sp.items() if "model" in v}
    if name.startswith("mamba"):
        assert split == ({"conv"} if "d48" in name else {"conv", "ssm"})
    for r in _results(worlds, name, dims):
        coord = dict(zip(axes, r["coord"]))
        for s, (_, layers) in enumerate(jax_ref[name]["serve"]):
            got = r["serve"][s][1]
            assert len(got) == len(layers) == len(specs) == cfg.n_layers
            for i, (g, w, sp) in enumerate(zip(got, layers, specs)):
                assert sorted(g) == sorted(w)
                for k in w:
                    block = ranks.shard_of(np.asarray(w[k]), sp[k], coord,
                                           sizes)
                    assert g[k].shape == block.shape, (name, s, i, k)
                    np.testing.assert_allclose(
                        g[k], block, rtol=SERVE_TOL, atol=SERVE_TOL,
                        err_msg=f"{name} step {s} layer {i} {k} {coord}")


#: the parameters a step moves over ``model``, as GSPMD does: a tied
#: embedding whose vocabulary divides the axis is exchanged all-to-all
#: into the head's layout (a train step); the RG-LRU's block-diagonal gates
#: come to a rank by blocks, all-to-all where its channels are whole
#: blocks, all-gathered where they end inside one (a train or decode
#: step).  Nothing else crosses the axis.
MOVED = {("mamba2-130m", "train"): [("all-to-all", "model")],
         ("recurrentgemma-2b", "train"): [("all-to-all", "model")],
         ("recurrentgemma-2b", "decode"): [("all-to-all", "model")],
         ("recurrentgemma-2b/w48", "train"): [("all-gather", "model")],
         ("recurrentgemma-2b/w48", "decode"): [("all-gather", "model")]}


@pytest.mark.parametrize("name,dims", CASES, ids=IDS)
def test_step_moves_parameters_over_model_as_gspmd_does(name, dims, worlds):
    """A train step gathers each parameter over the batch axes only, but
    for :data:`MOVED`'s; so does a decode step.  Mamba's ``in_proj``,
    heads and vocabulary that the axis does not divide move no parameter:
    the rank takes its columns of the whole weight and its products
    move."""
    for step, key in (("train", "moved"), ("decode", "moved_decode")):
        want = MOVED.get((name, step), [])
        for r in _results(worlds, name, dims):
            assert [m for m in r[key] if m[1] == "model"] == want, (step,
                                                                    r[key])
            assert all(m[1] == "data" for m in r[key] if m not in want)


#: the cases on a mesh whose batch axis one row leaves idle
ROW_CASES = [(a, m) for a, m in CACHE_CASES if m[0] > 1]
ROW_IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in ROW_CASES]


@pytest.mark.parametrize("name,dims", ROW_CASES, ids=ROW_IDS)
def test_one_row_decode_keeps_parameters_split_over_data(name, dims, worlds,
                                                         jax_ref):
    """One row, which the batch axes do not split (long_500k's batch of
    1): the prefill and decode logits are JAX's first row's, and a decode
    step moves no parameter over 'data' (a step of 4 rows gathers them
    there): each product is partitioned over 'data' as the parameter
    lies, as GSPMD partitions the reference's."""
    want = jax_ref[name]["serve"]
    for r in _results(worlds, name, dims):
        assert len(r["serve_row"]) == len(want)
        for s, (got, (logits, _)) in enumerate(zip(r["serve_row"], want)):
            np.testing.assert_allclose(
                got[0], logits[:1], rtol=SERVE_TOL, atol=SERVE_TOL,
                err_msg=f"{name} step {s}")
        assert ("all-gather", "data") in r["moved_decode"]
        assert [m for m in r["moved_row_decode"] if m[1] == "data"] == []
        assert [m for m in r["moved_row_decode"] if m[1] == "model"] \
            == MOVED.get((name, "decode"), [])
