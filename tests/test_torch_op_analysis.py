"""``repro_torch.launch.op_analysis`` against the JAX package's
``repro.launch.hlo_analysis`` (the counterparts of
``tests/test_hlo_analysis.py``'s cases), its scopes, and its transfer
bytes against ``MeshComm.sent`` on gloo ranks."""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import analyze_hlo, analyze_overlap as \
    jax_overlap
from repro_torch.launch import op_analysis as oa
from repro_torch.launch.mesh import make_mesh


def _compile_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def test_single_dot_flops_exact():
    got = oa.analyze_ops(lambda x, y: x @ y, torch.zeros(128, 64),
                         torch.zeros(64, 32))
    assert got.dot_flops == 2 * 128 * 64 * 32
    want = analyze_hlo(_compile_text(lambda x, y: x @ y,
                                     jnp.zeros((128, 64)),
                                     jnp.zeros((64, 32))))
    assert got.dot_flops == want.dot_flops


def test_layer_loop_flops_match_jax_scan():
    """A Python loop of 8 layers is recorded 8 times: 8 x one layer's
    flops, within 5 % of the JAX package's scanned twin."""
    w, x = torch.zeros(8, 64, 64), torch.zeros(4, 64)

    def loop(w, x):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x

    got = oa.analyze_ops(loop, w, x)
    one = oa.analyze_ops(lambda w, x: torch.tanh(x @ w[0]), w, x)
    assert got.dot_flops == 8 * one.dot_flops == 8 * 2 * 4 * 64 * 64

    def scanned(w, x):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0]

    want = analyze_hlo(_compile_text(scanned, jnp.zeros((8, 64, 64)),
                                     jnp.zeros((4, 64))))
    assert got.dot_flops == pytest.approx(want.dot_flops, rel=0.05)


def test_grad_flops_scale():
    """Backward of y = x @ w costs at least the forward's dot."""
    w = torch.zeros(64, 64, requires_grad=True)
    x = torch.zeros(16, 64)
    fwd = oa.analyze_ops(lambda: (x @ w).sum())
    bwd = oa.analyze_ops(lambda: (x @ w).sum().backward())
    assert bwd.dot_flops >= fwd.dot_flops
    # and against torch's own formulas for the same backward
    from torch.utils.flop_counter import FlopCounterMode
    w.grad = None
    with FlopCounterMode(display=False) as fc:
        (x @ w).sum().backward()
    assert bwd.dot_flops == fc.get_total_flops()


def test_no_collectives_on_single_device():
    stats = oa.analyze_ops(lambda x: x * 2, torch.zeros(8, 8))
    assert stats.total_collective_bytes == 0
    assert stats.total_collective_sent == 0
    # views and plumbing move nothing; x * 2 reads and writes 8 x 8 floats
    assert stats.hbm_bytes == 2 * 8 * 8 * 4
    assert stats.hbm_bytes_fused == 0


# ---------------------------------------------------------------------------
# overlap classification, on streams recorded through a RecordingComm
# ---------------------------------------------------------------------------
_OVERLAPPED_HLO = """
HloModule overlap_fixture

ENTRY %main (p0: f32[8,8], p1: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8] parameter(0)
  %p1 = f32[8,8] parameter(1)
  %cp-start = f32[8,8] collective-permute-start(%p0), source_target_pairs={{0,1},{1,0}}
  %dot.0 = f32[8,8] dot(%p1, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %cp-done = f32[8,8] collective-permute-done(%cp-start)
  ROOT %add = f32[8,8] add(%cp-done, %dot.0)
}
"""

_SERIALIZED_HLO = """
HloModule serial_fixture

ENTRY %main (p0: f32[8,8], p1: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8] parameter(0)
  %p1 = f32[8,8] parameter(1)
  %cp-start = f32[8,8] collective-permute-start(%p0), source_target_pairs={{0,1},{1,0}}
  %cp-done = f32[8,8] collective-permute-done(%cp-start)
  %dot.0 = f32[8,8] dot(%p1, %cp-done), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %out = f32[8,8] add(%dot.0, %dot.0)
}
"""

_SYNC_HLO = """
HloModule sync_fixture

ENTRY %main (p0: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8] parameter(0)
  %cp = f32[8,8] collective-permute(%p0), source_target_pairs={{0,1},{1,0}}
  ROOT %dot.0 = f32[8,8] dot(%cp, %cp), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""


@pytest.fixture
def two_ranks():
    """A fake world of two ranks, mesh (1, 2); the comm records a shift
    along "model" without sending (the fake backend moves nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
    rec = oa.OpRecorder()
    yield rec, oa.RecordingComm(mesh, "cpu", rec, transport=False)
    dist.destroy_process_group()


def _stream(rec, comm, order):
    p0, p1 = torch.zeros(8, 8), torch.zeros(8, 8)
    with rec:
        if order == "overlapped":
            pending = comm.shift([p0], "model", wait=False)
            d = p1 @ p1
            got = pending()[0] + d
        elif order == "serialized":
            got = comm.shift([p0], "model", wait=False)()[0]
            d = p1 @ got
            got = d + d
        else:
            got = comm.shift([p0], "model")[0]
            got = got @ got
    return rec.events


@pytest.mark.parametrize("order,fixture", [
    ("overlapped", _OVERLAPPED_HLO), ("serialized", _SERIALIZED_HLO),
    ("sync", _SYNC_HLO)])
def test_overlap_classification_matches_jax_fixture(two_ranks, order,
                                                    fixture):
    rep = oa.analyze_overlap(_stream(*two_ranks, order))
    want = jax_overlap(fixture)
    assert (rep.overlapped, rep.serialized, rep.sync) \
        == (want.overlapped, want.serialized, want.sync)
    assert rep.async_total == want.async_total
    assert rep.eligible_fraction == want.eligible_fraction
    assert [(k, n) for k, _, n in rep.pairs] \
        == [(k, n) for k, _, n in want.pairs]


def test_overlap_report_on_a_plain_run():
    """No transfers on one rank: nothing to classify (JAX's real-module
    case)."""
    rec = oa.OpRecorder()
    x = torch.zeros(8, 8)
    with rec:
        (x @ x) * 2
    rep = oa.analyze_overlap(rec.events)
    assert rep.overlapped == rep.serialized == rep.sync == 0


def test_recorded_shift_bytes(two_ranks):
    rec, comm = two_ranks
    events = _stream(rec, comm, "sync")
    st = oa.stats_of(events)
    assert st.collective_count["collective-permute"] == 1
    assert st.collective_bytes["collective-permute"] == 8 * 8 * 4
    assert st.collective_sent["collective-permute"] == comm.sent


def test_scope_op_counts_by_record_function_label():
    rec = oa.OpRecorder()
    x = torch.zeros(16, 16)
    with rec:
        with torch.profiler.record_function("plan.ring_c.padded"):
            y = x @ x
            with torch.profiler.record_function("step.0"):
                y = torch.tanh(y @ x)
        y.sum()
    counts = oa.scope_op_counts(rec.events)
    assert counts == {"plan.ring_c.padded": 3, "step.0": 2}
    assert oa.scope_op_counts(rec.events, scope="step") == {"step.0": 2}


def test_peak_follows_live_storages():
    """The recorder's peak is the largest sum of live storages the run
    made: two 4 KB temporaries alive at once, then one, then the scalar
    it returns."""
    x = torch.zeros(32, 32)
    rec = oa.OpRecorder()
    rec.hold([x])

    def run():
        a = x * 2
        b = a + 1
        del a
        return b.sum()

    with rec:
        out = run()
    assert rec.peak_bytes == 2 * 32 * 32 * 4
    assert rec.live_bytes == out.untyped_storage().nbytes() == 4


# ---------------------------------------------------------------------------
# transfers on gloo ranks: the recorder against MeshComm.sent
# ---------------------------------------------------------------------------
CELLS = (("qwen2.5-3b", "train", 16, 4), ("olmoe-1b-7b", "prefill", 16, 4))


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.grid import run_ranks
    import torch_dryrun_ranks
    return run_ranks(4, torch_dryrun_ranks.cell_rank, CELLS, device="cpu",
                     timeout_s=240)


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_collective_bytes_equal_meshcomm_sent(ranks, cell):
    for r in ranks:
        got = r[cell]
        assert sum(got["collective_sent"].values()) == got["sent"] > 0
        # operand bytes: an all-reduce sends its operand, an all-gather
        # sends it to each other member of its axis (here one: axes of 2)
        assert got["collective_sent"]["all-reduce"] \
            == got["collective_bytes"]["all-reduce"]
        assert got["collective_sent"]["all-gather"] \
            == got["collective_bytes"]["all-gather"] * (2 - 1)
    # every rank runs the same program at the same shapes
    assert len({repr(r[cell]) for r in ranks}) == 1
    assert ranks[0][cell]["dot_flops"] > 0
