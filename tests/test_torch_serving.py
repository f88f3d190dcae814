"""The port's serving layer (``repro_torch.serving``) against the JAX
package's ``repro.serving``: the counterparts of ``tests/test_serving.py``.

* the batcher's bucket and padding rules and the metrics math are the
  reference's;
* continuous batching is invisible: the dense engine with fewer slots than
  requests decodes JAX's ``lm.greedy_decode`` tokens, and so does the
  sparse engine (MoE dispatch and combine, prefill attention scoring
  through the plan API) on olmoe smoke, with no dropped token;
* ``sparse_moe_forward`` and ``sparse_attn_forward`` give JAX's outputs
  within 1e-5, and the routing operators D and W are JAX's exactly;
* plans are shared across tenants of a bucket (no new plan and no miss
  for the second tenant, ``add_trace_hook`` sees nothing), also across
  routings of the MoE operators; eviction churn at ``maxsize=1`` rebuilds
  and never corrupts; a replanner that trips drains without corrupting;
* a recurrent model (recurrentgemma-2b smoke: RG-LRU layers and a local
  attention layer of window 16) serves at exact prompt lengths, dense and
  sparse, with JAX's tokens: the sparse engine runs B1 and B2 (their plain
  versions here) in the local-attention layer only, once a prefill each,
  and a second request of the same length builds no plan; a padded
  prefill leaves the recurrent states as the reference does and masks
  the attention slots.

The JAX references are computed once per module (``jax_refs``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import sparse as jsparse
from repro_torch import configs as tconfigs
from repro_torch.core import api
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (ServeEngine, ServingMetrics, bucket_for,
                                 effective_bucket, percentile)
from repro_torch.serving import sparse as tsparse
from repro_torch.serving.batcher import pad_prompt
from repro_torch.launch import serve as tserve

MAX_LEN = 48
TOL = 1e-5
CPU = torch.device("cpu")

DENSE_LENS = (12, 9, 8)          # 12 and 9 pad to bucket 16, 8 is exact
SPARSE_LENS = (12, 9)
TENANT_LENS = (12, 9)            # both pad to 16
CHURN_LENS = (6, 20, 7)          # buckets 8, 32, 8
RECURRENT_LENS = (11, 7)         # exact lengths: recurrent state sees pads
LOCAL_LENS = (27, 20, 27)        # past the smoke local window of 16


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _model(arch, seed=0):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _greedy(jp, jcfg, toks, steps):
    out = jlm.greedy_decode(jp, {"tokens": jnp.asarray(toks[None])}, jcfg,
                            steps=steps, max_len=MAX_LEN)
    return np.asarray(out)[0]


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's models and reference decodes, computed once for the file."""
    llama = _model("llama3-8b")
    olmoe = _model("olmoe-1b-7b")
    jcfg, _, jp, _ = llama
    refs = {
        "dense": [_greedy(jp, jcfg, t, 4)
                  for t in _prompts(jcfg, DENSE_LENS)],
        "tenant": [_greedy(jp, jcfg, t, 3)
                   for t in _prompts(jcfg, TENANT_LENS)],
        "churn": [_greedy(jp, jcfg, t, 2)
                  for t in _prompts(jcfg, CHURN_LENS)],
    }
    jcfg, _, jp, _ = olmoe
    refs["sparse"] = [_greedy(jp, jcfg, t, 3)
                      for t in _prompts(jcfg, SPARSE_LENS)]
    rgemma = _model("recurrentgemma-2b")
    jcfg, _, jp, _ = rgemma
    refs["recurrent"] = [_greedy(jp, jcfg, t, 3)
                         for t in _prompts(jcfg, RECURRENT_LENS)]
    refs["local"] = [_greedy(jp, jcfg, t, 3)
                     for t in _prompts(jcfg, LOCAL_LENS, seed=1)]
    return {"llama": llama, "olmoe": olmoe, "rgemma": rgemma, **refs}


# ---------------------------------------------------------------------------
# batcher: bucketing + padding soundness
# ---------------------------------------------------------------------------
def test_bucket_for_rounds_up():
    assert bucket_for(1) == 8
    assert bucket_for(8) == 8
    assert bucket_for(9) == 16
    assert bucket_for(512) == 512
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        bucket_for(513)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_padding_rules_equal_jax(arch):
    """Global attention pads to the bucket; recurrent layers ('r'/'m') and
    local rings shorter than the bucket degrade to the exact length."""
    from repro.serving import effective_bucket as jeff
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    for max_len in (16, 48, 600):
        for length in (1, 7, 8, 12, 20, 33, 100):
            if length > max_len:
                continue
            assert effective_bucket(tcfg, length, max_len) \
                == jeff(jcfg, length, max_len), (length, max_len)


def test_batcher_rejects_overflowing_request():
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    eng = ServeEngine(cfg, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.zeros(12, np.int32), max_new_tokens=8)


def test_engine_and_serve_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = tconfigs.get_config("olmoe-1b-7b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, sparse=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(cfg, requests=1, prompt_len=4, gen_len=2, sparse=True)


# ---------------------------------------------------------------------------
# metrics math
# ---------------------------------------------------------------------------
def test_percentile_linear_interpolation():
    assert np.isnan(percentile([], 50))
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert percentile([1.0, 2.0, 3.0, 4.0], 0) == 1.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 100) == 4.0


def test_metrics_lifecycle_aggregates():
    m = ServingMetrics()
    t0 = m.start()
    m.submitted(0, t0, prompt_len=4)
    m.admitted(0, bucket_len=8)
    m.prefill_done(0, 0.5)
    m.decode_step_done(0.1, [0], dropped=0.0)
    m.decode_step_done(0.3, [0], dropped=0.0)
    m.finished(0)
    m.stop()
    s = m.summary()
    assert s["completed"] == 1
    assert s["tokens"] == 3                       # 1 prefill + 2 decode
    assert s["decode_steps"] == 2
    assert s["prefill_s"] == pytest.approx(0.5)
    assert s["decode_s"] == pytest.approx(0.4)
    assert s["tpot_p50_s"] == pytest.approx(0.2)  # mean of the 2 steps
    assert s["ttft_p50_s"] >= 0.0
    assert s["dropped_mean"] == 0.0 and s["dropped_max"] == 0.0


# ---------------------------------------------------------------------------
# continuous batching == JAX's unbatched greedy decode
# ---------------------------------------------------------------------------
def test_dense_engine_matches_jax(jax_refs):
    """3 requests through 2 slots: slot recycling mid-run, mixed prompt
    lengths, per-request positions."""
    jcfg, tcfg, _, tp = jax_refs["llama"]
    eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    for toks in _prompts(tcfg, DENSE_LENS):
        eng.submit(toks, max_new_tokens=4)
    results = eng.run()
    for rid, want in enumerate(jax_refs["dense"]):
        np.testing.assert_array_equal(results[rid], want,
                                      err_msg=f"request {rid}")
    s = eng.summary()
    assert s["completed"] == 3 and s["tokens"] == 12
    assert s["ttft_p50_s"] > 0 and s["tpot_p50_s"] > 0


def test_engine_replan_drains_without_corrupting_streams(jax_refs):
    """A replanner tripping mid-run drains in-flight requests, refits
    once, and every decoded stream still matches the reference."""
    from repro_torch import obs

    class StubReplanner:
        def __init__(self):
            self.checks = 0
            self.refits = 0

        def should_replan(self):
            self.checks += 1
            return ({"ring_c/padded/False": "ratio=4.00"}
                    if self.checks == 3 else {})

        def refit(self, trips):
            self.refits += 1
            return None, {}, 0

    _, tcfg, _, tp = jax_refs["llama"]
    rp = StubReplanner()
    obs.reset_all()
    obs.enable(clear=True)
    try:
        eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                          replanner=rp, device="cpu")
        for toks in _prompts(tcfg, DENSE_LENS):
            eng.submit(toks, max_new_tokens=4)
        results = eng.run()
        snap = obs.registry().snapshot()
        names = {e["name"] for e in obs.events()}
    finally:
        obs.disable()
    assert rp.refits == 1 and eng.replans == 1
    assert snap["serve.replans"] == 1.0
    assert snap["serve.replan_s"]["count"] == 1
    assert {"serve.admit", "serve.prefill", "serve.decode_step",
            "serve.replan"} <= names
    for rid, want in enumerate(jax_refs["dense"]):
        np.testing.assert_array_equal(results[rid], want,
                                      err_msg=f"request {rid}")


def test_sparse_engine_matches_jax_and_drops_nothing(jax_refs):
    """MoE dispatch and combine and prefill attention scoring on the
    plan API: JAX's tokens, and the dropped-token stat reads zero."""
    jcfg, tcfg, jp, tp = jax_refs["olmoe"]
    api.clear_plan_cache()
    eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                      sparse=True, device="cpu", keep_first_logits=True)
    prompts = _prompts(tcfg, SPARSE_LENS)
    for toks in prompts:
        eng.submit(toks, max_new_tokens=3)
    results = eng.run()
    for rid, want in enumerate(jax_refs["sparse"]):
        np.testing.assert_array_equal(results[rid], want,
                                      err_msg=f"request {rid}")
    # the kept first-token logits: JAX's prefill of the bucket-padded prompt
    for rid, toks in enumerate(prompts):
        padded = pad_prompt(toks, bucket_for(len(toks)))[None]
        want, _, _ = jlm.prefill(jp, {"tokens": jnp.asarray(padded)}, jcfg,
                                 MAX_LEN, jnp.float32,
                                 jnp.asarray([len(toks)], jnp.int32))
        got = eng.first_logits[rid]
        assert got.dtype == torch.float32 and got.shape == (tcfg.vocab_size,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0],
                                   rtol=1e-4, atol=1e-4)
    s = eng.summary()
    assert s["decode_steps"] > 0
    assert s["dropped_mean"] == 0.0 and s["dropped_max"] == 0.0
    assert s["plan_lookups"] > 0


# ---------------------------------------------------------------------------
# a recurrent model: exact-length prefill, the sparse local attention
# ---------------------------------------------------------------------------
def test_dense_engine_no_padding_family(jax_refs):
    """Recurrent models serve at exact lengths (padding unsound) and still
    give JAX's tokens (``test_serving.py``'s counterpart)."""
    jcfg, tcfg, _, tp = jax_refs["rgemma"]
    prompts = _prompts(tcfg, RECURRENT_LENS)
    for toks in prompts:
        assert effective_bucket(tcfg, len(toks), MAX_LEN) == len(toks)
    eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                      device="cpu")
    for toks in prompts:
        eng.submit(toks, max_new_tokens=3)
    results = eng.run()
    for rid, want in enumerate(jax_refs["recurrent"]):
        np.testing.assert_array_equal(results[rid], want,
                                      err_msg=f"request {rid}")


def _plain_calls():
    """A call hook counting the kernels' wrapper calls by name (here on the
    CPU each runs the kernel's plain version)."""
    from repro_torch.kernels import ops
    calls = {"bsr_spmm": 0, "bsr_pair_accumulate": 0}

    def hook(name, when):
        if when == "begin" and name in calls:
            calls[name] += 1
    return calls, ops.add_call_hook(hook)


def test_sparse_engine_on_a_recurrent_model_matches_jax(jax_refs):
    """recurrentgemma-2b smoke through ``ServeEngine(sparse=True)`` with
    prompts past its local window of 16 (so the window's mask prunes
    blocks of P): JAX's tokens; B2 (the scores) and B1 (P @ V) once a
    prefill in its one local-attention layer and never in a decode step
    or an RG-LRU layer; the third request, of the first's length, builds
    no plan."""
    from repro_torch.kernels import ops
    jcfg, tcfg, _, tp = jax_refs["rgemma"]
    n_local = tcfg.pattern.count("l")
    assert n_local == 1 and tcfg.local_window == 16
    prompts = _prompts(tcfg, LOCAL_LENS, seed=1)
    api.clear_plan_cache()
    eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                      sparse=True, device="cpu")
    for toks in prompts:
        eng.submit(toks, max_new_tokens=3)
    calls, hook = _plain_calls()
    built = []
    trace = api.add_trace_hook(lambda plan: built.append(plan))
    admitted = []
    orig = eng._admit

    def admit(req):
        admitted.append((req.rid, len(built)))
        orig(req)
    eng._admit = admit
    try:
        results = eng.run()
    finally:
        ops.remove_call_hook(hook)
        api.remove_trace_hook(trace)
    for rid, want in enumerate(jax_refs["local"]):
        np.testing.assert_array_equal(results[rid], want,
                                      err_msg=f"request {rid}")
    assert calls == {"bsr_spmm": n_local * len(prompts),
                     "bsr_pair_accumulate": n_local * len(prompts)}
    # the third request (rid 2) repeats rid 0's exact length: no new plan
    # between its admission and the end of the run
    start = dict(admitted)[2]
    assert len(built) == start > 0


def test_mask_pad_slots_on_a_mixed_recurrent_cache(jax_refs):
    """A padded prefill (per-row lengths) of the ``"rrlr"`` model: the
    RG-LRU states pass through untouched (no ``pos``), the local layer's
    slots at or past each row's length read -1; every cache equals JAX's
    ``prefill(lengths=...)``."""
    from repro.models import lm as jlm_
    from repro_torch.models import lm as tlm
    from repro_torch.models.convert import unstack_layers
    jcfg, tcfg, jp, tp = jax_refs["rgemma"]
    toks = np.stack(_prompts(tcfg, (20, 20), seed=3))
    lengths = np.array([20, 13], np.int32)
    _, cj, _ = jlm_.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, MAX_LEN,
                            jnp.float32, jnp.asarray(lengths))
    _, ct, pt = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            MAX_LEN, torch.float32, torch.from_numpy(lengths))
    np.testing.assert_array_equal(pt.numpy(), lengths)
    kinds = []
    for kind, layer_j, layer_t in zip(tcfg.pattern,
                                      unstack_layers(jcfg, cj), ct):
        kinds.append(kind)
        assert set(layer_t) == set(layer_j)
        if kind == "l":
            pos = layer_t["pos"].numpy()
            np.testing.assert_array_equal(pos, layer_j["pos"])
            assert (pos[1] < 13).all() and (pos[1] == -1).any()
        for key in layer_j:
            if key != "pos":
                np.testing.assert_allclose(layer_t[key].numpy(),
                                           layer_j[key], rtol=TOL, atol=TOL,
                                           err_msg=f"{kind}/{key}")
    assert kinds == list("rrlr")
    # the repair itself, on its own: a state cache passes through as is
    h = {"h": torch.ones(2, 3), "conv": torch.zeros(2, 3, 3)}
    attn = {"pos": torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32)}
    out = tlm._mask_pad_slots([h, attn], torch.tensor([3, 2]))
    assert out[0] is h and set(h) == {"h", "conv"}
    assert out[1]["pos"].tolist() == [[0, 1, 2], [0, 1, -1]]


# ---------------------------------------------------------------------------
# the sparse layers against JAX's
# ---------------------------------------------------------------------------
def _layer(jax_refs, name, part, li=0):
    jcfg, tcfg, jp, tp = jax_refs[name]
    pj = jtf.unstack_groups(jcfg, jp["groups"])[li][part]
    return jcfg, tcfg, pj, getattr(tp.layers[li], part)


@pytest.mark.parametrize("shape", [(1, 16), (2, 8), (1, 3)])
def test_sparse_moe_forward_matches_jax(jax_refs, shape):
    jcfg, tcfg, pj, pt = _layer(jax_refs, "olmoe", "moe")
    x = np.random.default_rng(1).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    yj, aux_j = jsparse.sparse_moe_forward(jsparse.SparseOps(), pj,
                                           jnp.asarray(x), jcfg)
    yt, aux_t = tsparse.sparse_moe_forward(tsparse.SparseOps(device="cpu"),
                                           pt, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    for key in aux_j:
        np.testing.assert_allclose(aux_t[key].numpy(), np.asarray(aux_j[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    # and the dense reference's output, as JAX's test holds its own
    yd, _ = tmoe.moe_forward(pt, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), yd.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_operators_equal_jax(jax_refs, dtype):
    """D and W as tensors are the reference's numpy ``np.add.at``
    operators on JAX's routing, bit for bit, in the activations' type (bf16 at the published
    configs); a capacity that drops tokens leaves their lines empty."""
    jcfg, tcfg, pj, pt = _layer(jax_refs, "olmoe", "moe")
    for cf in (8.0, 0.5):
        jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tc = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
        n = 24
        x = np.random.default_rng(2).standard_normal((n, jcfg.d_model))
        x = x.astype(np.float32)
        r = tmoe.route_tokens(pt.router, torch.as_tensor(x), tc)
        disp, comb = tsparse.routing_operators(r, n, tc, getattr(torch,
                                                                 dtype))
        jr = jmoe.route_tokens(pj["router"], jnp.asarray(x), jc)
        cap, G, ng = jmoe.route_meta(n, jc)
        e, k = jc.moe.n_experts, jc.moe.top_k
        top_e, slot, keep = (np.asarray(jr[key])
                             for key in ("top_e", "slot", "keep"))
        rows = ((np.arange(n) // ng)[:, None] * e + top_e) * cap + slot
        toks = np.broadcast_to(np.arange(n)[:, None], (n, k))
        wd = np.zeros((G * e * cap, n), np.float32)
        np.add.at(wd, (rows[keep], toks[keep]), 1.0)
        wc = np.zeros((n, G * e * cap), np.float32)
        # JAX's slots, the port's probabilities (equal to JAX's within
        # 1e-5, test_torch_models.py): the construction is held exactly
        np.add.at(wc, (toks[keep], rows[keep]), r["top_p"].numpy()[keep])
        wc = np.asarray(jnp.asarray(wc).astype(jnp.dtype(dtype)).astype(
            jnp.float32))
        assert disp.dtype == comb.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(disp.float().numpy(), wd)
        np.testing.assert_array_equal(comb.float().numpy(), wc)
        bound = tsparse.routing_capacity(n, G * e * cap, k, 1, 8)
        nnzb = int((disp.reshape(-1, 8, 3, 8) != 0).any(3).any(1).sum())
        assert nnzb <= bound


@pytest.mark.parametrize("arch,kind,t", [("olmoe-1b-7b", "g", 16),
                                         ("llama3-8b", "g", 11)])
def test_sparse_attn_forward_matches_jax(jax_refs, arch, kind, t):
    name = "olmoe" if arch == "olmoe-1b-7b" else "llama"
    jcfg, tcfg, pj, pt = _layer(jax_refs, name, "attn")
    x = np.random.default_rng(3).standard_normal(
        (1, t, jcfg.d_model)).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    cj = jattn.init_attn_cache(jcfg, kind, 1, 24, jnp.float32)
    ct = tattn.init_attn_cache(tcfg, kind, 1, 24, torch.float32, CPU)
    yj, cj = jsparse.sparse_attn_forward(jsparse.SparseOps(), pj,
                                         jnp.asarray(x), jcfg, kind,
                                         jnp.asarray(pos), cj)
    yt, ct = tsparse.sparse_attn_forward(tsparse.SparseOps(device="cpu"),
                                         pt, torch.as_tensor(x), tcfg, kind,
                                         torch.as_tensor(pos), ct)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    yd, _ = tattn.attn_forward(pt, torch.as_tensor(x), tcfg, kind,
                               torch.as_tensor(pos))
    np.testing.assert_allclose(yt.numpy(), yd.numpy(), rtol=TOL, atol=TOL)


def test_sparse_operators_tile_on_their_device():
    """The operators are tiled where they lie, in their own type: the
    handle's blocks keep a bf16 tensor's type and the structure comes
    back to the host with the tiling, unread from the blocks."""
    ops = tsparse.SparseOps(device="cpu")
    a = torch.zeros((24, 16), dtype=torch.bfloat16)
    a[0, 3] = 1.5
    a[17, 9] = -2.0
    h = ops.tile(a)
    assert h.dtype == torch.bfloat16
    assert torch.equal(h.densify(), a)
    assert h.tiled.host()["real"].sum() == 2
    ref = api.DistBSR.from_dense(a.float().numpy(), g=1, block_size=8,
                                 device="cpu")
    for key in ("rows", "cols", "counts"):
        assert torch.equal(getattr(h.tiled, key), getattr(ref.tiled, key))
    assert h.structure_key() == ref.structure_key()


# ---------------------------------------------------------------------------
# plan-cache sharing across tenants
# ---------------------------------------------------------------------------
def test_second_tenant_reuses_first_tenants_plans(jax_refs):
    """Two tenants, different prompts, bucketed-equal shape: after tenant A
    warms the bucket, tenant B's sparse prefill runs through cached plans
    only: no new plan and no miss."""
    _, tcfg, _, tp = jax_refs["llama"]
    a, b = _prompts(tcfg, TENANT_LENS)
    api.clear_plan_cache()
    eng = ServeEngine(tcfg, params=tp, max_batch=2, max_len=MAX_LEN,
                      sparse=True, device="cpu")
    eng.submit(a, max_new_tokens=3)
    eng.run()                                     # tenant A warms bucket 16
    before = api.cache_stats()["plans"]
    assert before["misses"] > 0                   # A actually built plans
    seen = []
    hook = api.add_trace_hook(lambda plan: seen.append(plan))
    try:
        eng.submit(b, max_new_tokens=3)
        results = eng.run()
    finally:
        api.remove_trace_hook(hook)
    after = api.cache_stats()["plans"]
    assert seen == [], "tenant B should not build any new plan"
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    np.testing.assert_array_equal(results[1], jax_refs["tenant"][1])


def test_moe_tenants_share_plans_across_routings(jax_refs):
    """The MoE operators' capacity is their structural bound, not their
    block count: a second olmoe tenant of the same bucket, whose routing
    differs, builds no plan either (prefill and decode)."""
    _, tcfg, _, tp = jax_refs["olmoe"]
    a, b = _prompts(tcfg, (12, 14), seed=5)
    api.clear_plan_cache()
    eng = ServeEngine(tcfg, params=tp, max_batch=1, max_len=MAX_LEN,
                      sparse=True, device="cpu")
    eng.submit(a, max_new_tokens=3)
    eng.run()
    before = api.cache_stats()["plans"]
    seen = []
    hook = api.add_trace_hook(lambda plan: seen.append(plan))
    try:
        eng.submit(b, max_new_tokens=3)
        eng.run()
    finally:
        api.remove_trace_hook(hook)
    assert seen == []
    assert api.cache_stats()["plans"]["misses"] == before["misses"]


def test_plan_cache_eviction_rebuilds_under_churn(jax_refs):
    """Shrink the plan LRU below one bucket's working set and alternate
    buckets: plans churn (evictions grow) but every decoded stream still
    matches JAX's."""
    _, tcfg, _, tp = jax_refs["llama"]
    cache = api._PLAN_CACHE
    old_max = cache.maxsize
    api.clear_plan_cache()
    cache.maxsize = 1
    try:
        eng = ServeEngine(tcfg, params=tp, max_batch=1, max_len=MAX_LEN,
                          sparse=True, device="cpu")
        for toks in _prompts(tcfg, CHURN_LENS):
            eng.submit(toks, max_new_tokens=2)
        results = eng.run()
        stats = api.cache_stats()["plans"]
        assert stats["evictions"] > 0
        assert stats["size"] <= 1
        for rid, want in enumerate(jax_refs["churn"]):
            np.testing.assert_array_equal(results[rid], want,
                                          err_msg=f"request {rid}")
    finally:
        cache.maxsize = old_max
        api.clear_plan_cache()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_the_cpu(capsys):
    assert tserve.main(["--arch", "olmoe-1b-7b", "--smoke", "--sparse",
                        "--device", "cpu", "--requests", "2",
                        "--prompt-len", "6", "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] prefill" in out and "dropped mean/max 0.0000" in out
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_serve_cli_runs_the_recurrent_families(capsys, arch):
    assert tserve.main(["--arch", arch, "--smoke", "--sparse", "--device",
                        "cpu", "--requests", "2", "--prompt-len", "20",
                        "--gen-len", "3"]) == 0
    assert "[serve] prefill" in capsys.readouterr().out


def test_engine_refuses_a_frontend_model():
    cfg = tconfigs.get_config("llava-next-mistral-7b", smoke=True)
    with pytest.raises(ValueError, match="token prompts"):
        ServeEngine(cfg, device="cpu")
    with pytest.raises(SystemExit, match="vlm inputs"):
        tserve.main(["--arch", "llava-next-mistral-7b", "--smoke",
                     "--device", "cpu"])
