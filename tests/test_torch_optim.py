"""The port's optimizer, data pipeline and fault runtime
(``repro_torch.optim``, ``repro_torch.data``, ``repro_torch.runtime.fault``)
against the JAX package's.

``cosine_schedule`` must give JAX's learning rate at every step of a run
(float32 on both sides, which may round ``cos`` to neighbouring values: a
few ulp, rtol 1e-6); AdamW JAX's parameters and moments on a quadratic,
with clipping and a bfloat16 ``nu``; ``compress_int8`` JAX's bits.  The
data pipeline is a numpy copy: batches and batch specs bit-equal to JAX's
for every family, and the same memmap reads.  The fault runtime is a copy
of plain Python, run through the JAX package's own cases.
"""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro.optim import compression as jcomp
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import (AdamW, ErrorFeedbackState, compress_int8,
                               cosine_schedule, decompress_int8)
from repro_torch.runtime import (PreemptionSignal, RestartableLoop,
                                 StragglerDetector)

ARCHS = jconfigs.list_archs()


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-4, 5, 100, 0.1), (3e-3, 1, 3, 0.1), (1.0, 10, 100, 0.1),
    (2e-4, 0, 50, 0.0), (1e-3, 40, 40, 0.5)])
def test_cosine_schedule_matches_jax_at_every_step(peak, warmup, total,
                                                   floor):
    lt = cosine_schedule(peak, warmup, total, floor)
    lj = jcosine(peak, warmup, total, floor)
    steps = np.arange(total + 10)
    got = np.array([float(lt(s)) for s in steps])
    want = np.array([float(lj(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert lt(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, 10, 100, floor=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0, abs=0.02)
    assert float(lr(100)) == pytest.approx(0.1, abs=0.02)


def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(100):
        grads = {"x": 2 * params["x"]}
        updates, state = opt.update(grads, state, params)
        params = {"x": params["x"] + updates["x"]}
    assert float(params["x"].abs().max()) < 0.1


def test_adamw_clip_norm_records_the_raw_norm():
    opt = AdamW(lr=0.1, clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    _, state = opt.update({"x": torch.tensor([1e6, 0.0, 0.0])}, state,
                          params)
    assert float(AdamW.last_grad_norm(state)) > 1e5


@pytest.mark.parametrize("nu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_on_a_quadratic(nu_dtype):
    """20 steps on 0.5 * |A x - b|^2 with clipping (the gradient norm
    starts far above ``clip_norm``), a schedule and weight decay: the
    parameters, ``mu``, ``nu`` (in ``nu_dtype``) and the norm against
    JAX's, float32, within 1e-5 (on this smooth problem no gradient nears
    zero, so Adam's amplification of rounding stays small)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) * 20
    x0 = rng.standard_normal(6).astype(np.float32)
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, clip_norm=1.0,
              nu_dtype=nu_dtype)
    jopt = JAdamW(lr=jcosine(0.05, 3, 20), **kw)
    topt = AdamW(lr=cosine_schedule(0.05, 3, 20), **kw)
    jp, tp = {"x": jnp.asarray(x0)}, {"x": torch.from_numpy(x0.copy())}
    js, ts = jopt.init(jp), topt.init(tp)
    ja, tb = jnp.asarray(a), torch.from_numpy(a)
    for _ in range(20):
        jg = {"x": ja.T @ (ja @ jp["x"] - jnp.asarray(b))}
        tg = {"x": tb.T @ (tb @ tp["x"] - torch.from_numpy(b))}
        ju, js = jopt.update(jg, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = topt.update(tg, ts, tp)
        tp = {"x": tp["x"] + tu["x"]}
        np.testing.assert_allclose(float(ts["gnorm"]), float(js["gnorm"]),
                                   rtol=1e-5)
    assert ts["nu"]["x"].dtype == getattr(torch, nu_dtype)
    assert float(js["gnorm"]) > 1.0          # clipping took part throughout
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts["mu"]["x"].numpy(),
                               np.asarray(js["mu"]["x"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts["nu"]["x"].float().numpy(),
                               np.asarray(js["nu"]["x"], np.float32),
                               rtol=1e-5, atol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 20


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------
def test_compress_int8_is_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    for i in range(20):
        g = (rng.standard_normal(777) * 10.0 ** rng.uniform(-4, 4)
             ).astype(np.float32)
        if i == 0:
            g[:] = 0.0                       # the 1e-12 floor of the scale
        qj, sj = jcomp.compress_int8(jnp.asarray(g))
        qt, scale = compress_int8(torch.from_numpy(g))
        assert qt.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert scale.item() == float(sj)
        np.testing.assert_array_equal(
            decompress_int8(qt, scale).numpy(),
            np.asarray(jcomp.decompress_int8(qj, sj)))


@given(st.lists(st.floats(-100, 100), min_size=1, max_size=64))
@settings(max_examples=30, deadline=None)
def test_int8_compression_bounded_error(vals):
    g = torch.tensor(vals, dtype=torch.float32)
    q, s = compress_int8(g)
    back = decompress_int8(q, s)
    max_abs = max(abs(v) for v in vals) or 1.0
    assert float((back - g).abs().max()) <= max_abs / 127.0 + 1e-6


def test_error_feedback_preserves_sum():
    """With error feedback, quantization error does not accumulate: the sum
    of the applied updates stays within one step of the true sum."""
    rng = np.random.default_rng(0)
    true = rng.standard_normal((50, 16)).astype(np.float32)
    ef = ErrorFeedbackState.init({"g": torch.zeros(16)})
    assert ef.residual["g"].dtype == torch.float32
    applied = torch.zeros(16)
    for t in range(50):
        g = torch.from_numpy(true[t]) + ef.residual["g"]
        q, s = compress_int8(g)
        deq = decompress_int8(q, s)
        ef.residual["g"] = g - deq
        applied = applied + deq
    drift = float((applied - torch.from_numpy(true.sum(0))).abs().max())
    assert drift <= float(np.abs(true).max()) / 127.0 + 1e-5


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "hubert-xlarge", "llava-next-mistral-7b"])
def test_adamw_decays_every_leaf(arch):
    """With zero gradients a step is the decay alone, on every parameter
    (the reference decays every leaf: the SSD's ``a_log`` and ``dt_bias``,
    the RG-LRU's ``lam``, norms and frontends too), JAX's update on the
    same tree."""
    from repro.models import transformer as jtf
    from repro_torch.models.convert import params_from_jax
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = JAdamW(lr=0.1)
    jupd, _ = jopt.update(jax.tree.map(jnp.zeros_like, jp), jopt.init(jp), jp)
    want = {n: p.detach().numpy() for n, p in params_from_jax(
        jax.tree.map(np.asarray, jupd), tcfg, device="cpu")
        .named_parameters()}
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    opt = AdamW(lr=0.1)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    opt.apply(named, {n: torch.zeros_like(p) for n, p in named.items()},
              opt.init(model))
    assert set(want) == set(named)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   before[n].numpy() + want[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        nonzero = before[n] != 0
        assert bool((p.detach()[nonzero].abs()
                     < before[n][nonzero].abs()).all()), n


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_are_bit_equal_to_jax(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    seq = 16 if not jcfg.num_patches else 12
    assert tpipe.make_batch_specs(tcfg, 3, seq) \
        == jpipe.make_batch_specs(jcfg, 3, seq)
    for host in (0, 1):
        js = jpipe.SyntheticLM(jcfg, 3, seq, seed=5, host_index=host,
                               num_hosts=2)
        ts = tpipe.SyntheticLM(tcfg, 3, seq, seed=5, host_index=host,
                               num_hosts=2)
        for step in (0, 7):
            want, got = js(step), ts(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_deterministic_per_step():
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    src = tpipe.SyntheticLM(cfg, 4, 16, seed=3)
    a, b = src(10), src(10)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], src(11)["tokens"])


def test_memmap_tokens_read_what_jax_reads(tmp_path):
    path = tmp_path / "toks.bin"
    data = np.arange(1000, dtype=np.int32)
    data.tofile(path)
    src = tpipe.MemmapTokens(str(path), batch=2, seq=9, host_index=1,
                             num_hosts=2)
    ref = jpipe.MemmapTokens(str(path), batch=2, seq=9, host_index=1,
                             num_hosts=2)
    for step in (0, 3, 60):
        np.testing.assert_array_equal(src(step)["tokens"],
                                      ref(step)["tokens"])
    b0 = tpipe.MemmapTokens(str(path), batch=2, seq=9)(0)
    assert b0["tokens"].shape == (2, 10)
    np.testing.assert_array_equal(b0["tokens"][0], data[:10])
    with pytest.raises(ValueError, match="too small"):
        tpipe.MemmapTokens(str(path), batch=60, seq=9, num_hosts=2)


def test_prefetcher_resume():
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    src = tpipe.SyntheticLM(cfg, 2, 8, seed=0)
    pf = tpipe.Prefetcher(src, depth=2, start_step=4)
    try:
        np.testing.assert_array_equal(pf.get(4)["tokens"], src(4)["tokens"])
        np.testing.assert_array_equal(pf.get(5)["tokens"], src(5)["tokens"])
        # skipping ahead drains the stale batches
        np.testing.assert_array_equal(pf.get(8)["tokens"], src(8)["tokens"])
    finally:
        pf.close()


def test_prefetcher_goes_back_to_a_restored_step():
    """A restarted loop asks again for a step before the last one it took
    (its checkpoint's): the producer restarts there."""
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    src = tpipe.SyntheticLM(cfg, 2, 8, seed=0)
    pf = tpipe.Prefetcher(src, depth=2)
    try:
        for step in (0, 1, 2, 3, 1, 2, 3, 4):
            np.testing.assert_array_equal(pf.get(step)["tokens"],
                                          src(step)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# the fault runtime
# ---------------------------------------------------------------------------
def test_restartable_loop_recovers():
    calls = {"n": 0, "recovered": 0}

    def body(step):
        calls["n"] += 1
        if step == 3 and calls["recovered"] == 0:
            raise RuntimeError("injected node failure")

    def recover():
        calls["recovered"] += 1
        return 2  # checkpoint was at step 2

    loop = RestartableLoop(6, recover, max_restarts=2)
    assert loop.run(body, 0) == 6
    assert calls["recovered"] == 1
    assert loop.total_restarts == 1 and loop.restarts == 0


def test_restartable_loop_bounded_restarts():
    def body(step):
        raise RuntimeError("always fails")

    seen = []
    loop = RestartableLoop(4, lambda: 0, max_restarts=2,
                           on_restart=lambda s, e: seen.append(s))
    with pytest.raises(RuntimeError, match="always fails"):
        loop.run(body, 0)
    assert seen == [0, 0] and loop.total_restarts == 3


def test_straggler_detector_flags_outlier():
    det = StragglerDetector(alpha=0.3, threshold=3.0, warmup=3)
    flagged = []
    for step in range(20):
        dt = 1.0 + 0.01 * (step % 3)
        if step == 15:
            dt = 10.0
        if det.observe(step, dt):
            flagged.append(step)
    assert flagged == [15]
    assert det.events[0]["step"] == 15


def test_preemption_signal_chains_and_restores():
    seen = {"outer": 0}

    def outer_handler(signum, frame):
        seen["outer"] += 1

    orig = signal.signal(signal.SIGTERM, outer_handler)
    try:
        with PreemptionSignal() as ps:
            assert not ps.requested
            signal.raise_signal(signal.SIGTERM)
            assert ps.requested
            assert seen["outer"] == 1         # chained, not clobbered
        assert signal.getsignal(signal.SIGTERM) is outer_handler
        quiet = PreemptionSignal(install=False)
        signal.raise_signal(signal.SIGTERM)
        assert not quiet.requested and seen["outer"] == 2
    finally:
        signal.signal(signal.SIGTERM, orig)
