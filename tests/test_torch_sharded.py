"""The LM stack on ranks, recovery on ranks and the verifier on rank plans.

gloo ranks on the CPU (``repro_torch.launch.grid``), each world spawned
once for the module: 2 ranks (the expert ring and expert parallelism on a
``(1, 2)`` mesh, ``compressed_psum`` over a data axis of 2), 4 ranks (the
same at ``(1, 4)``, the sharded loss and ``train(mesh=)`` on a ``(2, 2)``
mesh, the verifier on the plans of a 2x2 grid) and 9 ranks (a 3x3 grid
that loses 5 and recovers onto its survivors' 2x2).  The JAX package's
``ring_moe_forward`` and ``compressed_psum`` come from one child process
with 4 host devices (``torch_jax_sharded_child.py``), started first so it
runs while the ranks do; the single-device references (JAX's loss, the
port's one-device training, the stacked executor's recovery and plans)
are computed here.

Tolerances: the reference's float32 1e-5 for the ring and the one-device
comparisons, 1e-6 for ``compressed_psum``, 1e-4 for the sharded loss
against JAX's (the distributed checks' tolerance).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.runtime.platform import subprocess_env
from repro_torch.launch.grid import run_grid, run_ranks

import torch_jax_child as grid_child
import torch_jax_sharded_child as child
import torch_sharded_ranks as ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 240
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX child, started at once so that it runs while the ranks do."""
    out = tmp_path_factory.mktemp("jax_sharded") / "sharded.npz"
    env = subprocess_env(4, overlap=False)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(child.__file__)), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, out = jax_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def llama(jax_proc, tmp_path_factory):
    """The JAX package's llama3-8b smoke weights and a batch, written for
    the ranks, and JAX's single-device loss on them."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import lm, transformer as jtf
    cfg = get_config("llama3-8b", smoke=True)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: np.asarray(v)
             for k, v in SyntheticLM(cfg, 4, 16, seed=1)(0).items()}
    loss, _ = lm.loss_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, cfg)
    tmp = tmp_path_factory.mktemp("sharded_ranks")
    torch.save({"params": jax.tree.map(np.asarray, params), "batch": batch},
               tmp / "llama.pt")
    return str(tmp), float(loss)


@pytest.fixture(scope="module")
def two(jax_proc):
    return run_ranks(2, ranks.two_ranks, device="cpu", timeout_s=DEADLINE_S)


@pytest.fixture(scope="module")
def four(llama):
    return run_ranks(4, ranks.four_ranks, llama[0], device="cpu",
                     timeout_s=DEADLINE_S)


@pytest.fixture(scope="module")
def nine(jax_proc):
    return run_grid(3, ranks.recovery, device="cpu", timeout_s=DEADLINE_S)


def _moe(two, four, n):
    return [r["moe"] for r in (two if n == 2 else four)]


# ---------------------------------------------------------------------------
# the expert ring and expert parallelism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", child.RING_SIZES)
def test_ring_equals_the_jax_ring(n, two, four, jax_ref):
    for r in _moe(two, four, n):
        np.testing.assert_allclose(r["ring"], jax_ref[f"ring{n}/y"],
                                   rtol=TOL, atol=TOL)
        for k in ("moe_aux", "moe_z", "moe_dropped"):
            np.testing.assert_allclose(r[f"ring_{k}"],
                                       jax_ref[f"ring{n}/{k}"], rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("n", child.RING_SIZES)
def test_ring_equals_the_ports_dense_layer(n, two, four, jax_ref):
    """No token drops at capacity 16, so the ring is the dense layer."""
    for r in _moe(two, four, n):
        np.testing.assert_allclose(r["ring"], r["one"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["one"], jax_ref[f"ring{n}/y_dense"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["ring"], r["ring_whole_experts"])


@pytest.mark.parametrize("n", child.RING_SIZES)
def test_ring_makes_one_hop_per_rank(n, two, four):
    assert [r["ring_hops"] for r in _moe(two, four, n)] == [n] * n
    assert [r["ring_backward_hops"] for r in _moe(two, four, n)] == [n] * n


def _rank_part(k: str, g: np.ndarray, rank: int, n: int) -> np.ndarray:
    """What rank ``rank`` of ``n`` holds of the gradient of ``k`` taken
    whole: its experts' rows of an expert weight, all of the rest."""
    return np.split(g, n)[rank] if k.startswith("w_") else g


@pytest.mark.parametrize("n", child.RING_SIZES)
def test_ring_gradients_equal_the_dense_layers(n, two, four, jax_ref):
    """The gradients of ``sum(y**2) + moe_aux + moe_z`` through the ring's
    hops, with respect to the router, the rank's experts and ``x``, are the
    single-process dense layer's (no token drops at capacity 16), which
    are JAX's dense layer's."""
    for rank, r in enumerate(_moe(two, four, n)):
        assert sorted(r["ring_grad"]) == sorted(r["one_grad"])
        for k, g in r["ring_grad"].items():
            np.testing.assert_allclose(
                g, _rank_part(k, r["one_grad"][k], rank, n), rtol=TOL,
                atol=TOL, err_msg=k)
            np.testing.assert_allclose(
                r["one_grad"][k], jax_ref[f"ring{n}/dense_grad/{k}"],
                rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("n", child.RING_SIZES)
def test_ring_gradients_equal_jaxs(n, two, four, jax_ref):
    """The same gradients equal ``jax.grad`` through the JAX package's
    ring (its ``ppermute`` hops) on the same mesh (float32, 1e-5)."""
    for rank, r in enumerate(_moe(two, four, n)):
        for k, g in r["ring_grad"].items():
            np.testing.assert_allclose(
                g, _rank_part(k, jax_ref[f"ring{n}/grad/{k}"], rank, n),
                rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("n", child.RING_SIZES)
def test_expert_parallel_equals_one_process(n, two, four):
    """``selftest_distributed``'s check: experts sharded over the model
    axis, the rest whole; the aux losses are the dense layer's."""
    for r in _moe(two, four, n):
        np.testing.assert_allclose(r["ep"], r["one"], rtol=TOL, atol=TOL)
        for k in ("moe_aux", "moe_z", "moe_dropped"):
            assert r[f"ep_{k}"] == r[f"one_{k}"]


@pytest.mark.parametrize("step", range(child.PSUM_STEPS))
@pytest.mark.parametrize("name", sorted(child.PSUM_SHAPES))
def test_compressed_psum_equals_jax(name, step, two, jax_ref):
    for r, res in enumerate(two):
        got = res["psum"]
        np.testing.assert_allclose(got[f"{name}/{step}/sum"],
                                   jax_ref[f"psum/{name}/{step}/{r}/sum"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[f"{name}/{step}/resid"],
                                   jax_ref[f"psum/{name}/{step}/{r}/resid"],
                                   rtol=1e-6, atol=1e-6)


def test_compressed_psum_is_within_one_int8_step_of_the_float_sum(two):
    grads = child.psum_inputs()
    for name in child.PSUM_SHAPES:
        exact = sum(grads[f"{name}/0/{r}"] for r in range(child.PSUM_RANKS))
        step = sum(np.abs(grads[f"{name}/0/{r}"]).max() / 127
                   for r in range(child.PSUM_RANKS))
        assert np.abs(two[0]["psum"][f"{name}/0/sum"] - exact).max() <= step


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
def test_sharded_loss_equals_the_jax_loss(four, llama):
    for r in four:
        assert abs(r["train"]["loss"] - llama[1]) <= 1e-4 * abs(llama[1])


@pytest.fixture(scope="module")
def one_device():
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    st = train(get_config(ranks.TRAIN_ARCH, smoke=True), device="cpu",
               **ranks.TRAIN)
    return st["losses"], st["grad_norms"], {
        n: p.detach().numpy() for n, p in st["params"].named_parameters()}


def test_train_on_the_mesh_equals_one_device(four, one_device):
    losses, gnorms, params = one_device
    for r in four:
        t = r["train"]
        np.testing.assert_allclose(t["losses"], losses, rtol=TOL)
        np.testing.assert_allclose(t["grad_norms"], gnorms, rtol=TOL)
        assert sorted(t["params"]) == sorted(params)
        for n, p in params.items():
            np.testing.assert_allclose(t["params"][n], p, rtol=TOL,
                                       atol=TOL, err_msg=n)


def test_resume_on_the_mesh_equals_the_straight_run(four):
    for r in four:
        t = r["train"]
        assert t["resumed_losses"] == t["losses"][1:]
        for n, p in t["params"].items():
            np.testing.assert_array_equal(t["resumed_params"][n], p)


def test_each_rank_holds_its_sanitized_shards_only(four):
    for r in four:
        b = r["train"]["bytes"]
        assert b["params"] == b["want"] < b["whole"]
        assert b["moments"] == 2 * b["params"]


# ---------------------------------------------------------------------------
# the verifier on rank plans
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stacked_findings():
    from repro_torch import analysis
    from repro_torch.core import api
    handles = ranks.verifier_handles(grid_child.inputs(), 2)
    return ranks.verifier_findings(analysis.check_plan, analysis.lint_plan,
                                   api.plan_matmul, handles)


CASES = [c[0] for c in ranks.verifier_combos()] + ["corrupt-ring-perm"]


@pytest.mark.parametrize("case", CASES)
def test_rank_plans_give_the_stacked_findings(case, four, stacked_findings):
    want = stacked_findings[case]
    for r in four:
        assert tuple(r["verifier"]["findings"][case]) == tuple(want)
    if case == "corrupt-ring-perm":
        assert want[0] and all("schedule.ppermute-bijection" in f
                               for f in want[0])
    else:
        assert want == ([], [])


def test_validate_passes_on_rank_plans(four):
    for r in four:
        for key, modes in r["verifier"]["validated"].items():
            want = ["fast", "full"] if key.endswith("full") else ["fast"]
            assert modes == want, key


def test_a_rank_list_that_is_not_its_slice_is_caught(four):
    for r in four:
        assert r["verifier"]["moved_list"] == ["schedule.rank-slice"]


# ---------------------------------------------------------------------------
# recovery on ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stacked_recovery():
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.runtime.replan import ElasticReplanner
    a, b = ranks.recovery_operands()
    a3 = DistBSR.from_dense(a, g=3, block_size=ranks.RECOVERY["block_size"],
                            device="cpu")
    b3 = DistDense.for_rhs(b, a3, device="cpu")
    rec = ElasticReplanner().recover_from_loss(a3, b3, ranks.survivors())
    return rec, rec.plan(rec.a, rec.b).numpy(), a.astype(np.float64) @ b


def test_recovery_on_ranks_gives_the_stacked_tiles(nine, stacked_recovery):
    rec, want, _ = stacked_recovery
    new = ranks.survivors()[:rec.g ** 2]
    tm, tn = rec.a.tile_shape[0], rec.b.tile_shape[1]
    for r in nine:
        assert r["g"] == rec.g == 2
        if r["rank"] not in new:
            assert r["tile"] is None
            continue
        i, j = divmod(r["position"], rec.g)
        assert r["position"] == new.index(r["rank"]) and r["on_grid"]
        np.testing.assert_allclose(
            r["tile"],
            _padded(want, rec)[i * tm:(i + 1) * tm, j * tn:(j + 1) * tn],
            rtol=TOL, atol=TOL)


def _padded(c, rec):
    m, n = rec.a.shape[0], rec.b.shape[1]
    out = np.zeros((m, n), np.float32)
    out[:c.shape[0], :c.shape[1]] = c
    return out


def test_recovery_on_ranks_gives_the_product(nine, stacked_recovery):
    _, want, exact = stacked_recovery
    whole = [r["whole"] for r in nine if r["tile"] is not None]
    assert len(whole) == 4
    for w in whole:
        np.testing.assert_allclose(w, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(w, exact, rtol=1e-4, atol=1e-4)


def test_recovery_moves_blocks_by_exchange_and_validates(nine):
    assert sum(r["reshard_bytes"] for r in nine) > 0
    # the lost ranks send their tiles too
    lost = [r for r in nine if r["rank"] not in ranks.survivors()]
    assert lost and all(r["reshard_bytes"] > 0 for r in lost)
    for r in nine:
        if r["tile"] is not None:
            assert r["validated"] == ["fast", "full"]


# ---------------------------------------------------------------------------
# the selftest's --mesh checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("check", ["moe", "train_parallel", "analysis",
                                   "elastic"])
def test_selftest_mesh_check(check, four):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--mesh",
         "--device", "cpu", "--check", check], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "SELFTEST PASSED" in p.stdout
