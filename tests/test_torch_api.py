"""The port's plan API (``repro_torch.core.api``) against the JAX package's.

Parity: ``matmul`` through every schedule (``summa_bcast``, ``summa_ag``,
``ring_c``, ``ring_a``, ``ring_c_bidir``, ``steal3d``) on SpMM,
dense-output SpGEMM and dense x dense, with overlap on and off and with
balanced left operands; the packed-wire dense-output bodies; sparse-output
SpGEMM through ``ring_c`` (wire padded and packed, overlap on and off,
``output="auto"`` on both sides of its threshold, the chained cube) and
both SUMMAs; all against ``repro.core.api.matmul(algorithm=...,
impl="ref")`` on the same numpy inputs.  The host metadata (the wire
planners' consume maps and the scheduled pair lists) is bit-identical.  g = 1 runs in this process; g = 2 and 3 need one JAX device per
tile, so their JAX results come from one child process
(``torch_jax_child.py``) started with 9 host devices.  Float32 sums of a
few dozen products taken in other orders: tolerance 1e-5.  A sparse
result's structure (``rows``, ``cols``, ``counts``, capacities) must be
bit-identical.

Besides: the algorithm registry, plan-cache and placement reuse, the
operand validation of ``_coerce_pair`` and the sparse-output and structure
guards (same messages as the JAX package), the refusals of what the port
does not have, and the default device.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import dist as jdist
from repro.core import wire as jwire  # analysis: allow(source.import.repro.core.wire)
from repro.kernels import ops as jops
from repro.runtime.platform import subprocess_env
from repro_torch.core import api as tapi
from repro_torch.core import dist as tdist
from repro_torch.core.api import DistBSR, DistDense, matmul, plan_matmul
from repro_torch.core.bsr import TiledBSR, random_sparse
from repro_torch.core.grid import ProcessGrid
from repro_torch.core.interop import tiled_from_arrays

import torch_jax_child as child

CPU = torch.device("cpu")
TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {name: (alg, kind, balance, overlap)
         for name, alg, kind, balance, overlap in child.CASES}
SPARSE_CASES = {name: (alg, kind, kw)
                for name, alg, kind, kw in child.SPARSE_CASES}
RING_C = [c for c, v in CASES.items() if v[0] == "ring_c"]
OTHER = [c for c, v in CASES.items() if v[0] not in ("ring_c", "steal3d")]
STEAL = [c for c, v in CASES.items() if v[0] == "steal3d"]
SPARSE_RING_C = [c for c, v in SPARSE_CASES.items() if v[0] == "ring_c"]
SPARSE_OTHER = [c for c, v in SPARSE_CASES.items()
                if v[0] not in ("ring_c", "steal3d")]
SPARSE_STEAL = [c for c, v in SPARSE_CASES.items() if v[0] == "steal3d"]


def port_result(algorithm: str, kind: str, balance: str, overlap: str,
                g: int, ops: dict) -> np.ndarray:
    kw = dict(algorithm=algorithm, overlap=overlap)
    if kind == "dense":
        return matmul(ops["x"], ops["y"], g=g, device=CPU, **kw).numpy()
    a_h = DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK,
                             balance=balance, device=CPU)
    if kind == "spmm":
        b_h = DistDense.for_rhs(ops["b"], a_h)
    else:
        b_h = DistBSR.from_dense(ops["s"], g=g, block_size=child.BLOCK,
                                 device=CPU)
    return matmul(a_h, b_h, **kw).numpy()


def port_sparse_result(algorithm: str, kind: str, kw: dict, g: int,
                       ops: dict) -> dict:
    return child.result_fields(child.run_sparse_case(
        tapi, algorithm, kind, kw,
        lambda name: DistBSR.from_dense(ops[name], g=g,
                                        block_size=child.BLOCK, device=CPU),
        lambda name, a_h: DistDense.for_rhs(ops[name], a_h)))


def assert_same_result(got: dict, want: dict, oracle: np.ndarray) -> None:
    """Dense results within TOL; sparse ones with bit-identical structure,
    blocks within TOL, and their value against the float64 oracle."""
    assert set(got) == set(want)
    if "dense" in want:
        value = got["dense"]
        np.testing.assert_allclose(value, want["dense"], rtol=TOL, atol=TOL)
    else:
        for field in ("rows", "cols", "counts", "meta"):
            assert got[field].dtype == want[field].dtype, field
            np.testing.assert_array_equal(got[field], want[field],
                                          err_msg=field)
        assert got["blocks"].shape == want["blocks"].shape
        np.testing.assert_allclose(got["blocks"], want["blocks"], rtol=TOL,
                                   atol=TOL)
        value = got["dense_value"]
    assert value.shape == oracle.shape
    np.testing.assert_allclose(value, oracle, rtol=10 * TOL, atol=10 * TOL)


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """JAX results at g = 2 and 3, from one child process."""
    out = tmp_path_factory.mktemp("jax_child") / "ring_c.npz"
    env = subprocess_env(9, overlap=False)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(child.__file__)), str(out), "2",
         "3"], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ops():
    return child.inputs()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def _dense_parity_g1(case, ops):
    alg, kind, balance, overlap = CASES[case]
    got = port_result(alg, kind, balance, overlap, 1, ops)
    want = child.jax_result(alg, kind, balance, overlap, 1, ops)
    assert got.shape == want.shape == child.oracle(kind, ops).shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, child.oracle(kind, ops), rtol=TOL,
                               atol=TOL)


def _dense_parity_multi(case, g, ops, jax_multi):
    alg, kind, balance, overlap = CASES[case]
    got = port_result(alg, kind, balance, overlap, g, ops)
    want = jax_multi[f"{case}/g{g}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, child.oracle(kind, ops), rtol=TOL,
                               atol=TOL)


def _sparse_parity_g1(case, ops):
    alg, kind, kw = SPARSE_CASES[case]
    got = port_sparse_result(alg, kind, kw, 1, ops)
    want = child.jax_sparse_result(alg, kind, kw, 1, ops)
    assert_same_result(got, want, child.sparse_oracle(kind, ops))


def _jax_multi_fields(jax_multi, case, g) -> dict:
    prefix = f"{case}/g{g}/"
    return {k[len(prefix):]: v for k, v in jax_multi.items()
            if k.startswith(prefix)}


def _sparse_parity_multi(case, g, ops, jax_multi):
    alg, kind, kw = SPARSE_CASES[case]
    got = port_sparse_result(alg, kind, kw, g, ops)
    assert_same_result(got, _jax_multi_fields(jax_multi, case, g),
                       child.sparse_oracle(kind, ops))


@pytest.mark.parametrize("case", RING_C)
def test_ring_c_parity_g1_in_process(case, ops):
    _dense_parity_g1(case, ops)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", RING_C)
def test_ring_c_parity_multi_tile(case, g, ops, jax_multi):
    _dense_parity_multi(case, g, ops, jax_multi)


@pytest.mark.parametrize("case", SPARSE_RING_C)
def test_sparse_and_packed_parity_g1_in_process(case, ops):
    _sparse_parity_g1(case, ops)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", SPARSE_RING_C)
def test_sparse_and_packed_parity_multi_tile(case, g, ops, jax_multi):
    _sparse_parity_multi(case, g, ops, jax_multi)


@pytest.mark.parametrize("case", OTHER)
def test_schedule_parity_g1_in_process(case, ops):
    """summa_bcast, summa_ag, ring_a and ring_c_bidir: SpMM, dense-output
    SpGEMM and dense x dense, overlap on and off, balanced rows and cols."""
    _dense_parity_g1(case, ops)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", OTHER)
def test_schedule_parity_multi_tile(case, g, ops, jax_multi):
    _dense_parity_multi(case, g, ops, jax_multi)


@pytest.mark.parametrize("case", SPARSE_OTHER)
def test_schedule_sparse_and_packed_parity_g1_in_process(case, ops):
    """The other schedules' packed-wire bodies, and both SUMMAs' sparse
    outputs (structure bit-identical)."""
    _sparse_parity_g1(case, ops)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", SPARSE_OTHER)
def test_schedule_sparse_and_packed_parity_multi_tile(case, g, ops,
                                                      jax_multi):
    _sparse_parity_multi(case, g, ops, jax_multi)


@pytest.mark.parametrize("case", STEAL + SPARSE_STEAL)
def test_steal3d_parity_g1_in_process(case, ops):
    """steal3d: SpMM (overlap on and off, balanced rows), dense-output
    SpGEMM, dense x dense, and the packed wire (A packed)."""
    if case in CASES:
        _dense_parity_g1(case, ops)
    else:
        _sparse_parity_g1(case, ops)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", STEAL + SPARSE_STEAL)
def test_steal3d_parity_multi_tile(case, g, ops, jax_multi):
    if case in CASES:
        _dense_parity_multi(case, g, ops, jax_multi)
    else:
        _sparse_parity_multi(case, g, ops, jax_multi)


NONFINITE = {name: (alg, kw) for name, alg, kw in child.NONFINITE_CASES}


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("case", list(NONFINITE))
def test_nonfinite_b_gives_the_jax_nan_mask_end_to_end(case, g, ops,
                                                        jax_multi):
    """SpMM on a B holding an inf, a NaN and a -inf through ring_c (padded
    and packed wire) and summa_bcast: C's NaN mask (where a listed block,
    padding and coverage zeros included, meets a non-finite B chunk) and
    its infinities equal the JAX package's, its finite values within
    TOL (g = 1 in process, g = 2 and 3 from the child)."""
    alg, kw = NONFINITE[case]
    a_h = DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK,
                             device=CPU)
    b_h = DistDense.for_rhs(child.nonfinite_b(ops), a_h)
    got = matmul(a_h, b_h, algorithm=alg, **kw).numpy()
    want = child.jax_nonfinite_result(alg, kw, 1, ops) if g == 1 \
        else jax_multi[f"{case}/g{g}"]
    nan = np.isnan(want)
    assert 0 < nan.sum() < nan.size
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("algorithm", ["summa_bcast", "summa_ag", "ring_a",
                                       "ring_c_bidir"])
def test_bf16_schedule_parity_g1(algorithm, ops):
    """bf16 SpMM through each other schedule against the JAX package's,
    within the reference's bf16 tolerance."""
    a_j = japi.DistBSR.from_dense(ops["a"], g=1, block_size=4,
                                  dtype=jnp.bfloat16)
    want = japi.matmul(a_j, jnp.asarray(ops["b"], jnp.bfloat16),
                       algorithm=algorithm, impl="ref")
    a_t = DistBSR.from_dense(ops["a"], g=1, block_size=4,
                             dtype=torch.bfloat16, device=CPU)
    got = matmul(a_t, torch.from_numpy(ops["b"]).bfloat16(),
                 algorithm=algorithm)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", [c for c, (_, kind, _) in
                                  SPARSE_CASES.items() if kind != "chain"])
def test_sparse_and_packed_plans_resolve_as_jax(case, ops):
    """output, wire and the packed operands resolve as the JAX package's
    plans do (g = 1: the JAX plan needs one device per tile; the chain's
    plans are those of the sparse cases)."""
    alg, kind, kw = SPARSE_CASES[case]
    kw = dict(kw, algorithm=alg)
    output = {"sparse": "sparse", "auto": "auto"}.get(kind, "dense")
    rhs = "b" if kind == "packed-spmm" else "s"
    a_t = DistBSR.from_dense(ops["a"], g=1, block_size=4, device=CPU)
    a_j = japi.DistBSR.from_dense(ops["a"], g=1, block_size=4)
    if rhs == "b":
        b_t, b_j = DistDense.for_rhs(ops["b"], a_t), \
            japi.DistDense.for_rhs(jnp.asarray(ops["b"]), a_j)
    else:
        b_t = DistBSR.from_dense(ops["s"], g=1, block_size=4, device=CPU)
        b_j = japi.DistBSR.from_dense(ops["s"], g=1, block_size=4)
    p_t = plan_matmul(a_t, b_t, output=output, **kw)
    p_j = japi.plan_matmul(a_j, b_j, output=output, impl="ref", **kw)
    assert (p_t.output, p_t.wire, p_t._packs) == (p_j.output, p_j.wire,
                                                  p_j._packs)
    assert p_t.geom.c_store == p_j.geom.c_store


def test_sparse_plans_cache_by_structure(ops):
    tapi.clear_plan_cache()
    tapi.cache_stats(reset=True)
    a_h = DistBSR.from_dense(ops["a"], g=2, block_size=4, device=CPU)
    s_h = DistBSR.from_dense(ops["s"], g=2, block_size=4, device=CPU)
    p1 = plan_matmul(a_h, s_h, output="sparse")
    assert p1.output == "sparse" and p1.wire == "packed"
    assert plan_matmul(a_h, s_h, output="sparse") is p1
    assert plan_matmul(a_h, s_h, output="sparse", wire="padded") is not p1
    stats = tapi.cache_stats()
    assert stats["symbolic"]["size"] == 1 and stats["symbolic"]["hits"] >= 1
    # the same abstract shapes with another structure is another plan
    a2 = ops["a"].copy()
    a2[20:, 20:] = 0
    a2_h = DistBSR.from_dense(a2, g=2, block_size=4, capacity=a_h.capacity,
                              device=CPU)
    assert a2_h.abstract_key() == a_h.abstract_key()
    assert a2_h.structure_key() != a_h.structure_key()
    assert plan_matmul(a2_h, s_h, output="sparse") is not p1
    # output="auto" consults the density cache, not the pair lists
    tapi.clear_plan_cache()
    plan_matmul(a_h, s_h, output="auto", sparse_threshold=0.0)
    stats = tapi.cache_stats()
    assert stats["density"]["size"] == 1 and stats["symbolic"]["size"] == 0
    out = matmul(a_h, s_h, output="sparse")
    assert isinstance(out, DistBSR)
    assert torch.equal(out.tiled.rows, p1._c_rows)
    np.testing.assert_allclose(out.densify().numpy(),
                               ops["a"] @ ops["s"], rtol=TOL, atol=TOL)
    assert tapi.symbolic_spgemm(a_h.tiled, s_h.tiled).density() == \
        tapi.predicted_density(a_h.tiled, s_h.tiled)


def test_sparse_steps_launch_one_pair_kernel_call_per_step(ops, monkeypatch):
    """One batched call per ring step, over all g² tiles, with the
    step's [g*g, P] pair lists (g = 3)."""
    calls = []
    acc = tapi.kops.bsr_pair_accumulate
    monkeypatch.setattr(tapi.kops, "bsr_pair_accumulate",
                        lambda *args, **kw: calls.append(args[2].shape)
                        or acc(*args, **kw))
    a_h = DistBSR.from_dense(ops["a"], g=3, block_size=4, device=CPU)
    s_h = DistBSR.from_dense(ops["s"], g=3, block_size=4, device=CPU)
    plan = plan_matmul(a_h, s_h, output="sparse")
    plan(a_h, s_h)
    p = plan.symbolic.pair_capacity
    assert calls == [(9, p)] * 3
    assert plan.workspace_bytes() == 0           # no kernel on the CPU


@pytest.mark.parametrize("case", ["sparse-padded-off", "sparse-packed-off",
                                  "summa_bcast:sparse-packed-off",
                                  "summa_ag:sparse-padded-on"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_sparse_body_writes_step_0_fresh_then_adds_in_place(g, case, ops,
                                                             jax_multi,
                                                             monkeypatch):
    """Step 0 writes a fresh float32 carry (the store is not zero-filled
    first), each later step adds into that same tensor in place, and the
    result is the JAX package's TiledBSR."""
    calls = []
    pair_acc = tapi.kops.bsr_pair_accumulate

    def spy(*args, acc=None, **kw):
        out = pair_acc(*args, acc=acc, **kw)
        calls.append((acc, out))
        return out

    monkeypatch.setattr(tapi.kops, "bsr_pair_accumulate", spy)
    alg, kind, kw = SPARSE_CASES[case]
    got = port_sparse_result(alg, kind, kw, g, ops)
    assert len(calls) == g
    assert calls[0][0] is None and calls[0][1].dtype == torch.float32
    for acc, out in calls[1:]:
        assert acc is calls[0][1] and out is acc
    if g == 1:
        want = child.jax_sparse_result(alg, kind, kw, 1, ops)
    else:
        want = _jax_multi_fields(jax_multi, case, g)
    assert_same_result(got, want, child.sparse_oracle(kind, ops))


@pytest.mark.parametrize("g", [1, 2])
def test_sparse_and_wire_guards_match_jax(g, ops):
    """Eligibility and structure guards raise with the JAX messages.

    The structure guards run on a built plan, which the JAX package builds
    only with one device per tile (g = 1 here); the balance guard needs a
    permutation, which only g > 1 keeps.
    """
    jt = lambda d, **kw: japi.DistBSR.from_dense(d, g=g, block_size=4, **kw)
    tt = lambda d, **kw: DistBSR.from_dense(d, g=g, block_size=4,
                                            device=CPU, **kw)
    a, s = ops["a"], ops["s"]
    a2 = a.copy()
    a2[20:, 20:] = 0
    cap = jt(a).capacity
    eight = lambda mod, x: mod.DistBSR.from_dense(
        x, g=g, block_size=8, **({} if mod is japi else {"device": CPU}))
    cases = [
        # dense right operand
        (lambda: matmul(tt(a), DistDense.for_rhs(ops["b"], tt(a)),
                        output="sparse"),
         lambda: japi.matmul(jt(a), japi.DistDense.for_rhs(
             jnp.asarray(ops["b"]), jt(a)), output="sparse", impl="ref")),
        # block sizes differ
        (lambda: matmul(tt(s), eight(tapi, s), output="sparse"),
         lambda: japi.matmul(jt(s), eight(japi, s), output="sparse",
                             impl="ref")),
        # packed wire with two dense operands
        (lambda: matmul(np.ones((8, 8), np.float32),
                        np.ones((8, 8), np.float32), g=g, wire="packed",
                        device=CPU),
         lambda: japi.matmul(jnp.ones((8, 8)), jnp.ones((8, 8)), g=g,
                             wire="packed", impl="ref")),
    ]
    structure = [
        # the structure changed under a sparse-output plan
        (lambda: plan_matmul(tt(a), tt(s), output="sparse")(
            tt(a2, capacity=cap), tt(s)),
         lambda: japi.plan_matmul(jt(a), jt(s), output="sparse",
                                  impl="ref")(jt(a2, capacity=cap), jt(s))),
        # ... and under a packed-wire dense-output plan
        (lambda: plan_matmul(tt(a), tt(s), wire="packed")(
            tt(a2, capacity=cap), tt(s)),
         lambda: japi.plan_matmul(jt(a), jt(s), wire="packed", impl="ref")(
             jt(a2, capacity=cap), jt(s))),
    ]
    if g == 1:
        cases += structure
    else:
        cases.append((
            lambda: matmul(tt(a, balance="rows"), tt(s), output="sparse"),
            lambda: japi.matmul(jt(a, balance="rows"), jt(s),
                                output="sparse", impl="ref")))
    for fn_port, fn_jax in cases:
        _both(fn_port, fn_jax)


@pytest.mark.parametrize("g", [2, 3])
def test_balanced_cases_carry_permutations(g, ops):
    """The balanced parity cases do run the un-balance epilogue and the
    right-operand compensation, not the identity layout."""
    rows = DistBSR.from_dense(ops["a"], g=g, block_size=4, balance="rows",
                              device=CPU)
    cols = DistBSR.from_dense(ops["a"], g=g, block_size=4, balance="cols",
                              device=CPU)
    assert rows.row_block_perm is not None
    assert cols.col_block_perm is not None
    s = DistBSR.from_dense(ops["s"], g=g, block_size=4, device=CPU)
    _, b_c = tapi._coerce_pair(cols, s)
    assert b_c is not s and b_c._compensated_for == cols.col_block_perm
    # re-coercion reuses the compensated handle
    assert tapi._coerce_pair(cols, s)[1] is b_c
    assert tapi._coerce_pair(cols, b_c)[1] is b_c


@pytest.mark.parametrize("g", [2, 3])
def test_interop_tiled_feeds_the_port(g, ops, jax_multi):
    """The JAX TiledBSR, handed over as numpy arrays, multiplies to the JAX
    result in the port."""
    meta = jax_multi[f"tiled-meta/g{g}"].tolist()
    tiled = tiled_from_arrays(
        *(jax_multi[f"tiled-{f}/g{g}"] for f in ("blocks", "rows", "cols",
                                                  "counts")),
        shape=tuple(meta[:2]), block_size=child.BLOCK, grid_shape=(g, g),
        capacity=meta[4], logical_shape=tuple(meta[2:4]), device=CPU)
    got = matmul(tiled, ops["b"], overlap="off").numpy()
    np.testing.assert_allclose(got, jax_multi[f"spmm-none-off/g{g}"],
                               rtol=TOL, atol=TOL)


def test_bf16_spmm_parity_g1(ops):
    a_j = japi.DistBSR.from_dense(ops["a"], g=1, block_size=4,
                                  dtype=jnp.bfloat16)
    want = japi.matmul(a_j, jnp.asarray(ops["b"], jnp.bfloat16),
                       algorithm="ring_c", impl="ref")
    a_t = DistBSR.from_dense(ops["a"], g=1, block_size=4,
                             dtype=torch.bfloat16, device=CPU)
    got = matmul(a_t, torch.from_numpy(ops["b"]).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_densify_and_from_tiled_rebalance_match(ops):
    a_j = japi.DistBSR.from_tiled(
        japi.DistBSR.from_dense(ops["a"], g=2, block_size=4).tiled,
        balance="rows", capacity=None)
    a_t = DistBSR.from_tiled(
        DistBSR.from_dense(ops["a"], g=2, block_size=4, device=CPU).tiled,
        balance="rows", capacity=None)
    assert a_t.row_block_perm == a_j.row_block_perm is not None
    assert a_t.capacity == a_j.capacity
    np.testing.assert_array_equal(a_t.tiled.rows.numpy(),
                                  np.asarray(a_j.tiled.rows))
    np.testing.assert_array_equal(a_t.densify().numpy(), ops["a"])
    with pytest.raises(ValueError, match="capacity can only be changed"):
        DistBSR.from_tiled(a_t.tiled, capacity=None)
    with pytest.raises(ValueError, match="unknown balance"):
        DistBSR.from_tiled(a_t.tiled, balance="diag")


# ---------------------------------------------------------------------------
# host metadata of the other schedules: bit-identical to the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("algorithm", ["summa_bcast", "summa_ag", "ring_c",
                                       "ring_a", "ring_c_bidir"])
def test_wire_planners_match_jax(algorithm, g, ops):
    """Each schedule's consume maps for its packable operands equal the JAX
    planner's; summa_ag's with JAX's all-gather bases (``k *
    wire_capacity``) taken off, since the port reads the placed packed
    stack through tile maps instead of a flat gathered pool."""
    a_t = DistBSR.from_dense(ops["a"], g=g, block_size=4, device=CPU)
    s_t = DistBSR.from_dense(ops["s"], g=g, block_size=4, device=CPU)
    a_j = japi.DistBSR.from_dense(ops["a"], g=g, block_size=4)
    s_j = japi.DistBSR.from_dense(ops["s"], g=g, block_size=4)
    alg_t, alg_j = tapi.REGISTRY.get(algorithm), japi.REGISTRY.get(algorithm)
    assert alg_t.packable == alg_j.packable
    po = lambda h, who: h.packed_operand() if who in alg_t.packable \
        else None
    geom_t = tapi._geometry(a_t, s_t, impl=None)
    geom_j = japi._geometry(a_j, s_j, impl=None, axis_row="row",
                            axis_col="col")
    got = alg_t.wire_planner(po(a_t, "a"), po(s_t, "b"), geom_t)
    want = alg_j.wire_planner(po(a_j, "a"), po(s_j, "b"), geom_j)
    assert set(got) == set(want) and got
    for k, v in want.items():
        if algorithm == "summa_ag" and k in ("a_gidx", "b_dmap"):
            wc = (a_j if k == "a_gidx" else s_j).packed_operand() \
                .wire_capacity
            v = (v - japi._summa_bases(g, wc)[..., None]).astype(v.dtype)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
@pytest.mark.parametrize("algorithm", ["summa_bcast", "summa_ag", "ring_c"])
def test_scheduled_pair_lists_match_jax(algorithm, wire, g, ops):
    """A sparse-output plan's per-step pair lists are the JAX package's,
    scheduled by the schedule's own k_order (and remapped to the packed
    layout on the packed wire)."""
    a_t = DistBSR.from_dense(ops["a"], g=g, block_size=4, device=CPU)
    s_t = DistBSR.from_dense(ops["s"], g=g, block_size=4, device=CPU)
    a_j = japi.DistBSR.from_dense(ops["a"], g=g, block_size=4)
    s_j = japi.DistBSR.from_dense(ops["s"], g=g, block_size=4)
    plan = plan_matmul(a_t, s_t, algorithm=algorithm, output="sparse",
                       wire=wire)
    sym = japi._symbolic_for(a_j, s_j)
    kw = {}
    if wire == "packed":
        kw = dict(pair_a=jwire.remap_pairs_packed(
            sym.pair_a, a_j.packed_operand(), "a"),
            pair_b=jwire.remap_pairs_packed(
                sym.pair_b, s_j.packed_operand(), "b"))
    want = sym.scheduled_pairs(japi.REGISTRY.get(algorithm).k_order, **kw)
    for t, step in enumerate(plan._pairs):
        for k in ("pa", "pb", "ps"):
            np.testing.assert_array_equal(
                step[k].numpy(),
                np.asarray(want[k])[:, :, t].reshape(g * g, -1), err_msg=k)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
@pytest.mark.parametrize("algorithm", ["summa_bcast", "summa_ag", "ring_a",
                                       "ring_c_bidir"])
def test_other_schedules_read_the_placed_stacks_in_place(algorithm, wire, g,
                                                         monkeypatch):
    """Every launch of the dense-output SpMM hands B1 the natural A stack
    (padded) or packed A buffers (packed) themselves, with the tile maps
    that ``plan.launch_maps()`` lists (``plan.step_maps()`` composed with
    the placements), in order, and B's natural stack (its two contiguous
    column halves for ring_c_bidir): nothing rolls.  Each accumulator is
    written fresh by its first launch and added into after that."""
    calls = _count_shifts(monkeypatch)
    seen = []
    raw = tapi.kops.bsr_spmm_raw

    def spy(blocks, rows, cols, dense, **kw):
        out = raw(blocks, rows, cols, dense, **kw)
        seen.append((blocks, dense, kw, out))
        return out

    monkeypatch.setattr(tapi.kops, "bsr_spmm_raw", spy)
    a_d = random_sparse(24, 24, 0.3, seed=g)
    a_d[:8] = 0
    b = np.random.default_rng(g).standard_normal((24, 5)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    plan = plan_matmul(a_h, b_h, algorithm=algorithm, wire=wire)
    got = plan(a_h, b_h).numpy()
    np.testing.assert_allclose(got, a_d @ b, rtol=TOL, atol=TOL)
    assert calls["torch.roll"] == [] and calls["shifts"] == []
    alg = plan.algorithm
    packed = "a" in plan._packs
    assert packed == (wire == "packed" and algorithm != "ring_a")
    a_pool = (a_h.packed_wire if packed else a_h.placed)(
        tapi.NATURAL)["blocks"]
    b_pool = b_h.placed(tapi.NATURAL)["dense"]
    per_step = 2 if algorithm == "ring_c_bidir" else 1
    tn = plan.geom.tn
    launches = [m for step in plan.launch_maps() for m in step]
    pa, pb = (tdist.placement_index(pl, g)
              for pl in (alg.a_placement, alg.b_placement))
    np.testing.assert_array_equal(
        [(pa[a], pb[b]) for step in plan.step_maps() for a, b in step],
        launches)
    assert len(seen) == len(launches) == g * per_step
    distinct = g if algorithm.startswith("summa") else g * g
    for n, ((blocks, dense, kw, _), (a_map, b_map)) in enumerate(
            zip(seen, launches)):
        assert blocks.data_ptr() == a_pool.data_ptr()
        np.testing.assert_array_equal(kw["a_map"], a_map)
        np.testing.assert_array_equal(kw["b_map"], b_map)
        assert len(set(np.asarray(a_map).tolist())) == distinct
        if per_step == 2:
            assert dense.is_contiguous()
            assert dense.shape[-1] == (tn // 2, tn - tn // 2)[n % 2]
        else:
            assert dense.data_ptr() == b_pool.data_ptr()
        # accumulator n % per_step: fresh at its first launch, then in place
        if n < per_step:
            assert kw["out"] is None
        else:
            assert kw["out"] is seen[n % per_step][3]


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_bidir_with_unit_width_tiles(impl):
    """tn == 1 leaves ring_c_bidir's left half-panel zero wide: the body
    and the wrapper go through with a zero-width C half."""
    a_d = random_sparse(16, 16, 0.3, seed=0)
    a_h = DistBSR.from_dense(a_d, g=1, block_size=4, device=CPU)
    b_thin = np.random.default_rng(11).standard_normal(
        (16, 1)).astype(np.float32)
    got = matmul(a_h, b_thin, algorithm="ring_c_bidir", impl=impl).numpy()
    np.testing.assert_allclose(got, a_d @ b_thin, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the algorithm registry
# ---------------------------------------------------------------------------
def test_registry_unknown_algorithm(handles):
    _, _, a_h, b_h = handles
    with pytest.raises(ValueError, match="unknown algorithm"):
        matmul(a_h, b_h, algorithm="cannon")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tapi.recommended_balance("cannon")
    assert tapi.recommended_balance("ring_a") == "cols"
    assert tapi.recommended_balance("ring_c") == "rows"
    assert tapi.recommended_balance("summa_bcast") == "rows"


def test_registry_rejects_duplicates():
    alg = tapi.REGISTRY.get("ring_c")
    with pytest.raises(ValueError, match="already registered"):
        tapi.REGISTRY.register(tapi.Algorithm(name="ring_c", body=alg.body))
    with pytest.raises(ValueError, match="unknown a_placement"):
        tapi.REGISTRY.register(tapi.Algorithm(name="diag", body=alg.body,
                                              a_placement="diagonal"))


def test_registry_extension_dispatches(handles):
    """A newly registered algorithm is reachable through matmul at once."""
    a_d, b, a_h, b_h = handles
    ring_c = tapi.REGISTRY.get("ring_c")
    tapi.REGISTRY.register(tapi.Algorithm(
        name="ring_c_clone", body=ring_c.body,
        a_placement=ring_c.a_placement, b_placement=ring_c.b_placement,
        unskew_out=ring_c.unskew_out, wire=ring_c.wire,
        step_maps=ring_c.step_maps))
    try:
        got = matmul(a_h, b_h, algorithm="ring_c_clone").numpy()
        np.testing.assert_allclose(got, a_d @ b, rtol=TOL, atol=TOL)
        assert "ring_c_clone" in tapi.algorithms()
    finally:
        tapi.REGISTRY.unregister("ring_c_clone")
    assert "ring_c_clone" not in tapi.REGISTRY


def test_reregistering_algorithm_evicts_stale_plans(handles):
    a_d, b, a_h, b_h = handles
    ring_c = tapi.REGISTRY.get("ring_c")
    bcast = tapi.REGISTRY.get("summa_bcast")
    name = "evict_probe"
    tapi.REGISTRY.register(tapi.Algorithm(
        name=name, body=ring_c.body, a_placement=ring_c.a_placement,
        b_placement=ring_c.b_placement, unskew_out=ring_c.unskew_out,
        wire=ring_c.wire, step_maps=ring_c.step_maps))
    try:
        p1 = plan_matmul(a_h, b_h, algorithm=name)
        other = plan_matmul(a_h, b_h, algorithm="ring_c")
        tapi.REGISTRY.register(tapi.Algorithm(
            name=name, body=bcast.body, step_maps=bcast.step_maps),
            overwrite=True)
        p2 = plan_matmul(a_h, b_h, algorithm=name)
        assert p2 is not p1                      # stale plan evicted
        assert plan_matmul(a_h, b_h, algorithm="ring_c") is other
        assert p2.algorithm.a_placement == "natural"
        np.testing.assert_allclose(p2(a_h, b_h).numpy(), a_d @ b, rtol=TOL,
                                   atol=TOL)
    finally:
        tapi.REGISTRY.unregister(name)


# ---------------------------------------------------------------------------
# plan cache and placement reuse
# ---------------------------------------------------------------------------
@pytest.fixture
def handles():
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=2, block_size=4, device=CPU)
    return a_d, b, a_h, DistDense.for_rhs(b, a_h)


def test_plan_cache_reuses_plans(handles):
    a_d, b, a_h, b_h = handles
    tapi.clear_plan_cache()
    tapi.cache_stats(reset=True)
    p1 = plan_matmul(a_h, b_h)
    p2 = plan_matmul(a_h, b_h)
    assert p1 is p2 and tapi.plan_cache_size() == 1
    assert p1.kind == "spmm" and p1.output == "dense" and p1.wire == "padded"
    stats = tapi.cache_stats(reset=True)["plans"]
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 1, 1)
    assert tapi.cache_stats()["plans"]["hits"] == 0
    # another overlap mode or impl is another plan
    assert plan_matmul(a_h, b_h, overlap="off") is not p1
    assert plan_matmul(a_h, b_h, impl="ref") is not p1
    assert plan_matmul(a_h, b_h, overlap="off").geom.overlap is False
    # auto resolves to the bulk body on the single-stream executor
    assert p1.geom.overlap is False and p1.overlap == "auto"
    assert p1.geom == plan_matmul(a_h, b_h, overlap="off").geom
    assert plan_matmul(a_h, b_h, overlap="on").geom.overlap is True
    assert tapi.plan_cache_size() == 4
    # an uncached plan is fresh and not stored
    assert plan_matmul(a_h, b_h, cache=False) is not p1
    assert tapi.plan_cache_size() == 4
    # matmul goes through the cache and a plan is reusable on new values
    matmul(a_h, b_h)
    assert tapi.plan_cache_size() == 4
    b2 = DistDense.for_rhs(2 * b, a_h)
    np.testing.assert_allclose(p1(a_h, b2).numpy(), 2 * (a_d @ b),
                               rtol=TOL, atol=TOL)
    tapi.clear_plan_cache()
    assert tapi.plan_cache_size() == 0


def test_plan_cache_is_bounded(handles, monkeypatch):
    _, _, a_h, b_h = handles
    monkeypatch.setattr(tapi, "_PLAN_CACHE", tapi._LRUCache(2))
    for overlap in ("auto", "on", "off"):
        plan_matmul(a_h, b_h, overlap=overlap)
    stats = tapi.cache_stats()["plans"]
    assert (stats["size"], stats["maxsize"], stats["evictions"]) == (2, 2, 1)


def test_placements_are_materialised_once(handles):
    """A multiply places neither operand (its launch maps read the natural
    tiles); ``placed`` gathers a placement once and keeps it."""
    _, _, a_h, b_h = handles
    assert a_h.placements() == ()
    matmul(a_h, b_h)
    assert a_h.placements() == () and b_h.placements() == ()
    tree = a_h.placed(tapi.SKEW_ROWS)
    matmul(a_h, b_h, overlap="off")
    assert a_h.placed(tapi.SKEW_ROWS) is tree
    assert a_h.placements() == (tapi.SKEW_ROWS,)


@pytest.mark.parametrize("placement", tapi.PLACEMENTS)
def test_placements_match_jax(placement, ops):
    a_j = japi.DistBSR.from_dense(ops["a"], g=3, block_size=4)
    a_t = DistBSR.from_dense(ops["a"], g=3, block_size=4, device=CPU)
    for name in ("blocks", "rows", "cols"):
        np.testing.assert_array_equal(
            a_t.placed(placement)[name].numpy(),
            np.asarray(a_j.placed(placement)[name]))
    d_j = japi.DistDense.from_global(jnp.asarray(ops["b"][:39]), 3)
    d_t = DistDense.from_global(ops["b"][:39], 3, device=CPU)
    # the JAX handle keeps the placed global matrix, the port its tile grid
    np.testing.assert_array_equal(
        d_t.placed(placement)["dense"].numpy(),
        np.asarray(jdist.tileize(d_j.placed(placement)["dense"], 3)))
    with pytest.raises(ValueError, match="unknown placement"):
        a_t.placed("diagonal")


def _count_shifts(monkeypatch):
    """Record the executor's tile-map compositions, its tile rolls and
    every ``torch.roll``, by axis."""
    calls = {"maps": [], "shifts": [], "torch.roll": []}
    shift_map = tapi.StackedExecutor.shift_map
    monkeypatch.setattr(tapi.StackedExecutor, "shift_map",
                        lambda self, m, axis, sign=1:
                        calls["maps"].append(axis)
                        or shift_map(self, m, axis, sign))
    shift = tapi.StackedExecutor.shift
    monkeypatch.setattr(tapi.StackedExecutor, "shift",
                        lambda self, tree, axis, sign=1:
                        calls["shifts"].append(axis)
                        or shift(self, tree, axis, sign))
    roll = torch.roll
    monkeypatch.setattr(torch, "roll", lambda *args, **kw:
                        calls["torch.roll"].append(1) or roll(*args, **kw))
    return calls


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_ring_shifts_each_operand_g_minus_1_times(g, overlap, monkeypatch):
    """No shift is made whose tiles no step consumes: g - 1 per operand and
    one local multiply per step, in either body.  The shifts are
    compositions of tile maps and roll nothing, in the dense-output body
    and in the sparse-output one, which gathers each step's tiles."""
    calls = _count_shifts(monkeypatch)
    local_mm = tapi._local_mm
    steps = []
    monkeypatch.setattr(tapi, "_local_mm", lambda *args: steps.append(1)
                        or local_mm(*args))
    a_d = random_sparse(24, 24, 0.3, seed=g)
    b = np.random.default_rng(g).standard_normal((24, 5)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    got = matmul(a_h, b, overlap=overlap).numpy()
    once = ["col"] * (g - 1) + ["row"] * (g - 1)
    assert sorted(calls["maps"]) == once
    assert calls["shifts"] == [] and calls["torch.roll"] == []
    assert len(steps) == g
    np.testing.assert_allclose(got, a_d @ b, rtol=TOL, atol=TOL)
    calls["maps"].clear()
    c_h = matmul(a_h, a_h, output="sparse", overlap=overlap)
    assert sorted(calls["maps"]) == once
    assert calls["shifts"] == [] and calls["torch.roll"] == []
    np.testing.assert_allclose(c_h.densify().numpy(), a_d @ a_d, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_dense_bodies_read_the_placed_stacks_in_place(g, wire, monkeypatch):
    """Every step of the dense-output SpMM hands the local multiply the
    natural A stack (padded) or packed A buffers (packed) and the natural B
    stack themselves, with that step's tile maps composed with the skewed
    placements: no roll and no gather copy of A or of B precede the
    multiply."""
    calls = _count_shifts(monkeypatch)
    seen = []
    raw = tapi.kops.bsr_spmm_raw
    monkeypatch.setattr(tapi.kops, "bsr_spmm_raw",
                        lambda blocks, rows, cols, dense, **kw:
                        seen.append((blocks, dense, kw)) or
                        raw(blocks, rows, cols, dense, **kw))
    a_d = random_sparse(24, 24, 0.3, seed=g)
    a_d[:8] = 0
    b = np.random.default_rng(g).standard_normal((24, 5)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    got = matmul(a_h, b_h, wire=wire).numpy()
    np.testing.assert_allclose(got, a_d @ b, rtol=TOL, atol=TOL)
    assert calls["torch.roll"] == [] and calls["shifts"] == []
    a_pool = (a_h.packed_wire if wire == "packed" else a_h.placed)(
        tapi.NATURAL)["blocks"]
    b_pool = b_h.placed(tapi.NATURAL)["dense"]
    pa, pb = (tdist.placement_index(pl, g)
              for pl in (tapi.SKEW_ROWS, tapi.SKEW_COLS))
    ex = tapi.StackedExecutor(g, CPU)
    a_map = b_map = ex.identity_map()
    assert len(seen) == g
    for t, (blocks, dense, kw) in enumerate(seen):
        if t:
            a_map = ex.shift_map(a_map, "col")
            b_map = ex.shift_map(b_map, "row")
        assert blocks.data_ptr() == a_pool.data_ptr()
        assert tuple(blocks.shape) == (g * g, *a_pool.shape[2:])
        assert dense.data_ptr() == b_pool.data_ptr()
        np.testing.assert_array_equal(kw["a_map"], pa[a_map])
        np.testing.assert_array_equal(kw["b_map"], pb[b_map])
        assert (kw["out"] is None) == (t == 0)
        assert kw["out"] is None or kw["out"] is seen[1][2]["out"]


def test_a_multiply_copies_neither_operand(monkeypatch):
    """A stacked ``ring_c`` ``matmul(A_h, B)`` on a fresh tensor B, recorded
    whole (coercion, placement, body, epilogue), copies or rolls neither
    operand's storage: B is tileized once (a ``clone``, no gather) and A is
    read where it lies, through the launch maps, so A_h keeps no placed
    copy.  The local multiply is a stand-in that reads no operand, so the
    plain version's own gathers do not count."""
    from repro_torch.analysis.op_lint import copy_ops
    g = 2
    a_h = DistBSR.from_dense(random_sparse(24, 24, 0.3, seed=1), g=g,
                             block_size=4, device=CPU)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (24, 5)).astype(np.float32))
    seen = []

    def stand_in(blocks, rows, cols, dense, *, n_block_rows, a_map, out=None,
                 **kw):
        seen.append((blocks, dense))
        return out if out is not None else torch.zeros(
            (len(a_map), n_block_rows * blocks.shape[-1], dense.shape[-1]))

    monkeypatch.setattr(tapi.kops, "bsr_spmm_raw", stand_in)
    hits, rolls = copy_ops(lambda: matmul(a_h, b), [a_h.tiled.blocks, b])
    assert hits == [] and rolls == []
    assert a_h.placements() == ()
    assert len(seen) == g
    for blocks, dense in seen:
        assert blocks.data_ptr() == a_h.tiled.blocks.data_ptr()
        assert dense.data_ptr() == seen[0][1].data_ptr() != b.data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_step_0_fresh_then_in_place_equals_c_plus_local(dtype, wire):
    """The dense-output ring on the port's ops (step 0 fresh, later steps
    added into C in place) against the JAX package's ``c + local`` at g = 3:
    float32 within 1e-5; bf16 within 2e-2, each step rounded to bf16 and
    added in bf16 on both sides."""
    g, bs = 3, 4
    a_d = random_sparse(36, 36, 0.3, seed=4)
    b = np.random.default_rng(4).standard_normal((36, 7)).astype(np.float32)
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=bs, dtype=t_dtype,
                             device=CPU)
    b_h = DistDense.for_rhs(torch.from_numpy(b).to(t_dtype), a_h)
    plan = plan_matmul(a_h, b_h, wire=wire)
    assert plan.wire == wire
    body, operands = plan._operands(a_h, b_h)
    c = body(*operands, plan.geom, plan.executor)
    assert c.dtype == t_dtype
    # the reference, step by step on the natural tiles: A[i, k] @ B[k, j]
    # with k = (i + j + step) % g, c + local in the output dtype
    pa, pb = a_h.placed(tapi.NATURAL), b_h.placed(tapi.NATURAL)
    ii, jj = np.arange(g)[:, None], np.arange(g)[None, :]
    want = None
    for step in range(g):
        k = (ii + jj + step) % g
        local = []
        for i in range(g):
            for j in range(g):
                src = (pa["blocks"][i, k[i, j]], pa["rows"][i, k[i, j]],
                       pa["cols"][i, k[i, j]])
                src = [jnp.asarray(x.float().numpy()).astype(j_dtype)
                       if x.is_floating_point() else jnp.asarray(x.numpy())
                       for x in src]
                dense = jnp.asarray(pb["dense"][k[i, j], j].float().numpy()
                                    ).astype(j_dtype)
                local.append(jops.bsr_spmm_raw(
                    *src, dense, n_block_rows=a_h.tile_shape[0] // bs,
                    impl="ref", augment=False))
        local = jnp.stack(local).reshape(g, g, *local[0].shape)
        want = local if want is None else want + local
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(c.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_plan_refuses_other_shapes(handles):
    _, b, a_h, b_h = handles
    plan = plan_matmul(a_h, b_h)
    other = DistBSR.from_dense(random_sparse(24, 16, 0.3, seed=1), g=2,
                               block_size=4, device=CPU)
    with pytest.raises(ValueError, match="do not match this plan"):
        plan(other, DistDense.for_rhs(b, other))


# ---------------------------------------------------------------------------
# validation: the same messages as the JAX package
# ---------------------------------------------------------------------------
def _both(fn_port, fn_jax):
    with pytest.raises(Exception) as got:
        fn_port()
    with pytest.raises(Exception) as want:
        fn_jax()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    return got.value


def test_coerce_pair_errors_match_jax():
    a_d = random_sparse(16, 14, 0.3, seed=0)
    b = np.ones((14, 8), np.float32)
    x = np.ones((10, 7), np.float32)
    jt = lambda d, g, **kw: japi.DistBSR.from_dense(d, g=g, block_size=4,
                                                    **kw)
    tt = lambda d, g, **kw: DistBSR.from_dense(d, g=g, block_size=4,
                                               device=CPU, **kw)
    skew = child.inputs()["a"]
    cases = [
        # dense left operand without g
        (lambda: tapi._coerce_pair(x, x.T),
         lambda: japi._coerce_pair(x, x.T)),
        # handle on another grid than g
        (lambda: tapi._coerce_pair(tt(a_d, 2), b, g=1),
         lambda: japi._coerce_pair(jt(a_d, 2), b, g=1)),
        # right operand carrying a row balance
        (lambda: tapi._coerce_pair(tt(skew, 2), tt(skew.T.copy(), 2,
                                                   balance="rows")),
         lambda: japi._coerce_pair(jt(skew, 2), jt(skew.T.copy(), 2,
                                                   balance="rows"))),
        # dense x sparse
        (lambda: tapi._coerce_pair(
            DistDense.from_global(np.ones((16, 16), np.float32), 2,
                                  device=CPU), tt(a_d, 2)),
         lambda: japi._coerce_pair(
             japi.DistDense.from_global(np.ones((16, 16), np.float32), 2),
             jt(a_d, 2))),
        # operands on different grids
        (lambda: tapi._coerce_pair(tt(a_d, 1), tt(b, 2)),
         lambda: japi._coerce_pair(jt(a_d, 1), jt(b, 2))),
        # padded inner dimensions disagree
        (lambda: tapi._coerce_pair(
            tt(a_d, 2), DistDense.from_global(np.ones((12, 8), np.float32),
                                              2, device=CPU)),
         lambda: japi._coerce_pair(
             jt(a_d, 2), japi.DistDense.from_global(
                 np.ones((12, 8), np.float32), 2))),
        # right operand too tall / neither logical nor padded K
        (lambda: tapi._coerce_pair(tt(a_d, 2), np.ones((20, 3), np.float32)),
         lambda: japi._coerce_pair(jt(a_d, 2), np.ones((20, 3), np.float32))),
        (lambda: tapi._coerce_pair(tt(a_d, 2), np.ones((13, 3), np.float32)),
         lambda: japi._coerce_pair(jt(a_d, 2), np.ones((13, 3), np.float32))),
        # bad padding request
        (lambda: DistDense.from_global(x, 2, rows_pad=9, device=CPU),
         lambda: japi.DistDense.from_global(x, 2, rows_pad=9)),
    ]
    for fn_port, fn_jax in cases:
        _both(fn_port, fn_jax)
    # allow_pad pads the short right operand instead
    a_h, b_h = tapi._coerce_pair(tt(a_d, 2), np.ones((13, 3), np.float32),
                                 allow_pad=True)
    assert b_h.shape == (16, 4) and b_h.logical_shape == (13, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="ring_a", output="sparse", operands="sparse"),
     "algorithm 'ring_a' has no sparse-output body"),
    (dict(algorithm="ring_c_bidir", output="sparse", operands="sparse"),
     "algorithm 'ring_c_bidir' has no sparse-output body"),
    (dict(algorithm="steal3d", output="sparse", operands="sparse"),
     "algorithm 'steal3d' has no sparse-output body"),
    (dict(algorithm="bogus"), "unknown algorithm 'bogus'"),
    (dict(output="sparse"), "sparse output needs two block-sparse"),
    (dict(algorithm="auto", wire="packed", operands="dense"),
     "wire='packed' needs at least one block-sparse"),
    (dict(output="csr"), "unknown output 'csr'"),
    (dict(output="sparse", operands="balanced"),
     "sparse output does not support balanced operands"),
    (dict(wire="wide"), "unknown wire 'wide'"),
    (dict(overlap="maybe"), "unknown overlap 'maybe'"),
    (dict(impl="pallas"), "unknown impl 'pallas'"),
])
def test_refuses_what_the_slice_lacks(handles, kw, match):
    """What the port refuses, with the JAX package's refusals where it has
    them (``_both`` holds the messages equal for the schedules' sparse
    outputs, steal3d's among them, and the packed wire's dense
    operands)."""
    _, _, a_h, b_h = handles
    operands = kw.pop("operands", None)
    if operands == "balanced":
        skew = child.inputs()
        a_h = DistBSR.from_dense(skew["a"], g=2, block_size=4,
                                 balance="rows", device=CPU)
        b_h = DistBSR.from_dense(skew["s"], g=2, block_size=4, device=CPU)
    elif operands == "sparse":
        b_h = a_h
    elif operands == "dense":
        a_h = DistDense.from_global(np.ones((8, 8), np.float32), 2,
                                    device=CPU)
        b_h = DistDense.for_rhs(np.ones((8, 4), np.float32), a_h)
    for fn in (matmul, plan_matmul):
        with pytest.raises(ValueError, match=match):
            fn(a_h, b_h, **kw)
    if operands in ("sparse", "dense"):
        to_jax = lambda h: japi.DistBSR.from_dense(
            h.densify().numpy(), g=h.g, block_size=h.block_size) \
            if isinstance(h, DistBSR) else japi.DistDense.from_global(
                jnp.asarray(h.data.numpy()), h.g)
        _both(lambda: matmul(a_h, b_h, **kw),
              lambda: japi.matmul(to_jax(a_h), to_jax(b_h), impl="ref",
                                  **kw))


def test_padded_wire_and_algorithms():
    assert tapi.algorithms() == ("summa_bcast", "summa_ag", "ring_c",
                                 "ring_a", "ring_c_bidir", "steal3d")
    assert tapi.algorithms() == japi.algorithms()
    assert tapi.sparse_algorithms() == ("summa_bcast", "summa_ag", "ring_c")
    a_d = random_sparse(16, 16, 0.3, seed=0)
    a_h = DistBSR.from_dense(a_d, g=1, block_size=4, device=CPU)
    b = np.ones((16, 2), np.float32)
    np.testing.assert_allclose(matmul(a_h, b, wire="padded").numpy(),
                               a_d @ b, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="square process grid"):
        DistBSR(TiledBSR.from_dense(a_d, ProcessGrid(1, 2), 4, device=CPU))


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    a_d = random_sparse(16, 16, 0.3, seed=0)
    x = np.ones((8, 8), np.float32)
    if torch.cuda.is_available():
        assert DistBSR.from_dense(a_d, g=2, block_size=4).device.type == \
            "cuda"
        assert DistDense.from_global(x, 2).device.type == "cuda"
        return
    for build in (lambda: DistBSR.from_dense(a_d, g=2, block_size=4),
                  lambda: DistDense.from_global(x, 2),
                  lambda: matmul(x, x, g=2),
                  lambda: plan_matmul(x, x, g=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistDense.from_global(x, 2, device="cuda")


# ---------------------------------------------------------------------------
# a multiply under tracing (repro_torch.obs)
# ---------------------------------------------------------------------------
def _traced_case():
    a = random_sparse(32, 32, 0.25, seed=41)
    b = np.random.default_rng(41).standard_normal((32, 8)).astype(np.float32)
    return a, torch.as_tensor(b), DistBSR.from_dense(a, g=2, block_size=4,
                                                     device=CPU)


def test_traced_matmul_records_each_phase_under_one_call_id():
    """One traced ``matmul``: the coercion, the plan lookup, the multiply
    span and its three phases, and B1's two ``ring_c`` launches (the
    plain version here) all carry one call id, the launches numbered in
    it; the next call takes the next id.  No device time off the card."""
    from repro_torch import obs
    a, b, a_h = _traced_case()
    obs.enable(clear=True)
    try:
        out = matmul(a_h, b, algorithm="ring_c", device=CPU)
        matmul(a_h, b, algorithm="ring_c", device=CPU)
        evs = obs.events()
    finally:
        obs.disable()
        obs.clear_trace()
        obs.reset_drift()
    np.testing.assert_allclose(out.numpy(), a @ b.numpy(), rtol=0, atol=TOL)
    calls = sorted({e["args"]["call"] for e in evs})
    assert len(calls) == 2 and calls[1] == calls[0] + 1
    for call in calls:
        mine = [e for e in evs if e["args"]["call"] == call]
        names = [e["name"] for e in mine]
        assert {"matmul.coerce", "plan_build", "multiply.ring_c",
                "multiply.place", "multiply.body",
                "multiply.epilogue"} <= set(names)
        assert [e["args"]["launch"] for e in mine
                if e["name"] == "kernel.bsr_spmm"] == [0, 1]
        (body,) = [e for e in mine if e["name"] == "multiply.body"]
        for k in (e for e in mine if e["name"] == "kernel.bsr_spmm"):
            assert body["ts"] <= k["ts"] <= body["ts"] + body["dur"]
    assert not any("device_ms" in e["args"] for e in evs)


def test_untraced_matmul_records_nothing_and_makes_no_cuda_event(
        monkeypatch):
    from repro_torch import obs

    def forbidden(*args, **kw):
        raise AssertionError("an untraced multiply made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    a, b, a_h = _traced_case()
    assert not obs.enabled()
    out = matmul(a_h, b, algorithm="ring_c", device=CPU)
    np.testing.assert_allclose(out.numpy(), a @ b.numpy(), rtol=0, atol=TOL)
    assert obs.events() == [] and obs.drift_records() == []


def test_traced_plan_computes_its_cost_model_once(monkeypatch):
    """Five traced calls of one plan: five drift records, one cost model."""
    from repro_torch import obs
    _, b, a_h = _traced_case()
    b_h = DistDense.for_rhs(b, a_h)
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    models = []
    cost_model = plan.cost_model
    monkeypatch.setattr(plan, "cost_model",
                        lambda *a, **kw: models.append(1) or cost_model(
                            *a, **kw))
    obs.enable(clear=True)
    obs.reset_drift()
    try:
        for _ in range(5):
            plan(a_h, b_h)
        recs = obs.drift_records()
    finally:
        obs.disable()
        obs.clear_trace()
        obs.reset_drift()
    assert len(models) == 1 and len(recs) == 5
    assert all(r["measured_s"] > 0 and r["cm"] == recs[0]["cm"]
               for r in recs)
