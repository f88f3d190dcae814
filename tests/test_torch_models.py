"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's.

The configuration registry must be equal field by field, full and smoke,
with the same parameter counts.  The building blocks (``rms_norm``,
``rope``, ``softcap``, ...), the router (``route_meta`` over a range of
token counts; ``route_tokens``' ``top_e``, ``slot`` and ``keep`` exactly,
ties included), ``moe_forward``, ``attn_forward``, ``attn_decode`` with
per-row positions and the whole ``forward`` run on the JAX package's
parameters carried across by ``params_from_jax``, in float32 within 1e-5
(``tests/test_kernels.py``'s tolerance; logits 1e-4), for the attention,
recurrent (RG-LRU, Mamba-2) and frontend (audio, vlm) families alike.
``greedy_decode`` must give JAX's tokens; the recurrent families' decode
steps must give their full forward's logits (``test_models_smoke.py``'s
2e-3), and an encoder has no decode path.  The layers themselves are held
in ``test_torch_recurrent.py``.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax, unstack_layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ("llama3-8b", "gemma2-9b", "olmoe-1b-7b", "mamba2-130m",
         "recurrentgemma-2b", "hubert-xlarge", "llava-next-mistral-7b")
# the archs with a decode path (hubert-xlarge is an encoder)
DECODE_ARCHS = tuple(a for a in ARCHS if a != "hubert-xlarge")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def models():
    """Per arch: the smoke configs, the JAX parameters and the port's
    model holding the same values."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jconfigs.get_config(arch, smoke=True)
        tcfg = tconfigs.get_config(arch, smoke=True)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(i))
        tree = jax.tree.map(np.asarray, jp)
        out[arch] = (jcfg, tcfg, jp, tree,
                     params_from_jax(tree, tcfg, device="cpu"))
    return out


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _inputs(cfg, b, t, seed=0):
    """A model's inputs of ``b`` rows and ``t`` tokens (or frames), numpy:
    an audio model's frames, a vlm's tokens and its patches."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (b, t, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.frontend == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def _jax_in(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_in(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the configuration registry
# ---------------------------------------------------------------------------
def test_registry_lists_the_same_archs_and_shapes():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_equals_the_jax_config(arch, smoke):
    j = jconfigs.get_config(arch, smoke=smoke)
    t = tconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pattern == j.pattern
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_supported(t, shape) \
            == jconfigs.cell_supported(j, shape)
    assert ttf.layer_plan(t) == jtf.layer_plan(j)


def test_olmoe_published_size():
    cfg = tconfigs.get_config("olmoe-1b-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.vocab_size) == (16, 2048, 16, 128, 50304)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) \
        == (64, 8, 1024)
    assert cfg.param_count() == 6_919_028_736


def test_unknown_layer_kind_raises():
    cfg = dataclasses.replace(tconfigs.get_config("llama3-8b", smoke=True),
                              layer_pattern="gx")
    with pytest.raises(ValueError, match="unknown layer kind"):
        ttf.init_params(cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS + ("qwen2.5-3b", "arctic-480b"))
def test_init_params_matches_the_jax_tree(arch):
    """The port's random model has the JAX tree's tensors, one per leaf
    of each layer, with the same shapes, and their sizes add up to
    JAX's."""
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = ttf.init_params(cfg, seed=0, device="cpu")
    want = params_from_jax(tree, cfg, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in want.named_parameters()}
    assert sum(v.numel() for v in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in model.parameters())
    again = ttf.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_exact_params(arch):
    """``chip_smoke.exact_params``, which holds each published model's
    parameter count on the card, equals the size of the JAX package's
    parameter tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jconfigs.get_config(arch, smoke=True), jax.random.PRNGKey(0)))
    assert smoke.exact_params(tconfigs.get_config(arch, smoke=True)) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_cache(cfg, 1, 16)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    jd = jnp.dtype(dtype)
    want = jcommon.rms_norm(jnp.asarray(x, jd), jnp.asarray(s))
    got = tcommon.rms_norm(_t(x).to(getattr(torch, dtype)), _t(s))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else 2 ** -7
    _close(got.float(), _np(want.astype(jnp.float32)), tol)
    _close(tcommon.rms_norm(_t(x), _t(s), zero_centered=False),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s),
                            zero_centered=False))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((4, 32), (32,), (32,)))
    _close(tcommon.layer_norm(_t(x), _t(s), _t(b)),
           jcommon.layer_norm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b)))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_and_apply_rope(theta):
    pos = np.arange(37, dtype=np.int32)
    js, jc = jcommon.rope(jnp.asarray(pos), 16, theta)
    ts, tc = tcommon.rope(_t(pos), 16, theta)
    _close(ts, js)
    _close(tc, jc)
    x = np.random.default_rng(2).standard_normal((2, 37, 3, 16)).astype(
        np.float32)
    _close(tcommon.apply_rope(_t(x), ts, tc),
           jcommon.apply_rope(jnp.asarray(x), js, jc))


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    _close(tcommon.softcap(_t(x), cap), jcommon.softcap(jnp.asarray(x), cap))


# ---------------------------------------------------------------------------
# the router and the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_route_meta_over_token_counts(arch, groups):
    for smoke in (False, True):
        jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=smoke),
                                   moe_dispatch_groups=groups)
        tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=smoke),
                                   moe_dispatch_groups=groups)
        for n in list(range(1, 70)) + [100, 128, 256, 1000, 4096]:
            assert tmoe.route_meta(n, tcfg) == jmoe.route_meta(n, jcfg), n


def _route_case(kind, n, d, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "ties":
        # every expert equally likely: top-k must take the lowest indices
        router = np.zeros((d, e), np.float32)
    elif kind == "pairs":
        # duplicated expert columns: pairs of exactly tied probabilities
        half = rng.standard_normal((d, e // 2)).astype(np.float32)
        router = np.repeat(half, 2, axis=1)
    else:
        router = rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5
    return x, router


@pytest.mark.parametrize("kind", ["random", "ties", "pairs"])
@pytest.mark.parametrize("groups", [1, 2])
def test_route_tokens_exact(kind, groups):
    jcfg = dataclasses.replace(jconfigs.get_config("olmoe-1b-7b"),
                               moe_dispatch_groups=groups)
    tcfg = dataclasses.replace(tconfigs.get_config("olmoe-1b-7b"),
                               moe_dispatch_groups=groups)
    x, router = _route_case(kind, 96, 32, 64, seed=groups)
    want = jmoe.route_tokens(jnp.asarray(router), jnp.asarray(x), jcfg)
    got = tmoe.route_tokens(_t(router), _t(x), tcfg)
    for key in ("top_e", "slot", "keep", "onehot"):
        np.testing.assert_array_equal(got[key].numpy(), _np(want[key]),
                                      err_msg=key)
    for key in ("cap", "G", "ng"):
        assert got[key] == want[key]
    for key in ("logits", "probs", "top_p", "dropped"):
        _close(got[key], want[key], what=key)
    if kind != "random":
        assert float(want["dropped"]) > 0 or kind == "pairs"
    aux_j = jmoe.router_aux(want, jcfg)
    aux_t = tmoe.router_aux(got, tcfg)
    for key in aux_j:
        _close(aux_t[key], aux_j[key], what=key)


def test_moe_forward(models):
    jcfg, tcfg, jp, _, tp = models["olmoe-1b-7b"]
    layer_j = jtf.unstack_groups(jcfg, jp["groups"])[0]["moe"]
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(
        np.float32)
    yj, aux_j = jmoe.moe_forward(layer_j, jnp.asarray(x), jcfg)
    yt, aux_t = tmoe.moe_forward(tp.layers[0].moe, _t(x), tcfg)
    _close(yt, yj)
    for key in aux_j:
        _close(aux_t[key], aux_j[key], what=key)
    # a capacity that drops tokens: the kept ones still agree
    jd = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    td = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    yj, aux_j = jmoe.moe_forward(layer_j, jnp.asarray(x), jd)
    yt, aux_t = tmoe.moe_forward(tp.layers[0].moe, _t(x), td)
    assert float(aux_j["moe_dropped"]) > 0
    _close(yt, yj)
    _close(aux_t["moe_dropped"], aux_j["moe_dropped"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", [("llama3-8b", "g"), ("gemma2-9b", "l"),
                                       ("gemma2-9b", "g"),
                                       ("olmoe-1b-7b", "g")])
def test_attn_forward_and_prefill_cache(models, arch, kind):
    jcfg, tcfg, jp, _, tp = models[arch]
    li = jcfg.pattern.index(kind)
    pj = jtf.unstack_groups(jcfg, jp["groups"])[li]["attn"]
    pt = tp.layers[li].attn
    t = 20                                     # past gemma2 smoke's window
    x = np.random.default_rng(4).standard_normal((2, t, jcfg.d_model))
    x = x.astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    cj = jattn.init_attn_cache(jcfg, kind, 2, 32, jnp.float32)
    ct = tattn.init_attn_cache(tcfg, kind, 2, 32, torch.float32, CPU)
    yj, cj = jattn.attn_forward(pj, jnp.asarray(x), jcfg, kind,
                                jnp.asarray(pos), cj)
    yt, ct = tattn.attn_forward(pt, _t(x), tcfg, kind, _t(pos), ct)
    _close(yt, yj)
    for key in ("k", "v"):
        _close(ct[key], cj[key], what=key)
    np.testing.assert_array_equal(ct["pos"].numpy(), _np(cj["pos"]))


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "g"), ("gemma2-9b", "l")])
def test_blocked_attention(models, arch, kind):
    """The kv-chunked online softmax (above BLOCKED_ATTN_THRESHOLD), run
    here at a small chunk with a ragged tail."""
    jcfg, tcfg, *_ = models[arch]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 21, jcfg.n_heads, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 21, jcfg.n_kv_heads, 16)).astype(
        np.float32) for _ in range(2))
    pos = np.arange(21, dtype=np.int32)
    want = jattn._sdpa_blocked(*map(jnp.asarray, (q, k, v)), jcfg, kind,
                               jnp.asarray(pos), jnp.asarray(pos),
                               kv_chunk=8)
    got = tattn._sdpa_blocked(_t(q), _t(k), _t(v), tcfg, kind, _t(pos),
                              _t(pos), kv_chunk=8)
    _close(got, want)
    mask = tattn._pair_mask(tcfg, kind, _t(pos), _t(pos))[None]
    _close(got, tattn._sdpa(_t(q), _t(k), _t(v), mask, tcfg))


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "g"), ("gemma2-9b", "l")])
def test_attn_decode_per_row_positions(models, arch, kind):
    """Rows at different depths in one step (continuous batching), past
    the local window's ring wrap."""
    jcfg, tcfg, jp, _, tp = models[arch]
    li = jcfg.pattern.index(kind)
    pj = jtf.unstack_groups(jcfg, jp["groups"])[li]["attn"]
    pt = tp.layers[li].attn
    rng = np.random.default_rng(6)
    cj = jattn.init_attn_cache(jcfg, kind, 3, 32, jnp.float32)
    ct = tattn.init_attn_cache(tcfg, kind, 3, 32, torch.float32, CPU)
    pos = np.array([0, 5, 17], np.int32)
    for step in range(6):
        x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
        yj, cj = jattn.attn_decode(pj, jnp.asarray(x), cj,
                                   jnp.asarray(pos), jcfg, kind)
        yt, ct = tattn.attn_decode(pt, _t(x), ct, _t(pos), tcfg, kind)
        _close(yt, yj, what=f"step {step}")
        np.testing.assert_array_equal(ct["pos"].numpy(), _np(cj["pos"]))
        pos = pos + 1
    # an int position broadcasts to every row
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    yj, _ = jattn.attn_decode(pj, jnp.asarray(x), cj, 23, jcfg, kind)
    yt, _ = tattn.attn_decode(pt, _t(x), ct, 23, tcfg, kind)
    _close(yt, yj)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(models, arch):
    jcfg, tcfg, jp, _, tp = models[arch]
    batch = _inputs(jcfg, 2, 13, seed=7)
    lj, _, aux_j = jtf.forward(jp, _jax_in(batch), jcfg)
    lt, _, aux_t = ttf.forward(tp, _torch_in(batch), tcfg)
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    _close(lt, lj, LOGIT_TOL)
    for key in aux_j:
        _close(aux_t[key], aux_j[key], LOGIT_TOL, what=key)
    lu, _, _ = ttf.forward_unscanned(tp, _torch_in(batch), tcfg)
    assert torch.equal(lu, lt)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_steps(models, arch):
    """Padded prefill (per-row lengths) fills the cache JAX's way (the
    attention layers' slots masked, the recurrent states as the reference
    leaves them); the decode steps at per-row positions give JAX's
    logits."""
    jcfg, tcfg, jp, _, tp = models[arch]
    batch = _inputs(jcfg, 2, 16, seed=8)
    total = 16 + jcfg.num_patches
    lengths = np.array([total, total - 5], np.int32)
    lj, cj, pj = jlm.prefill(jp, _jax_in(batch), jcfg, 32,
                             jnp.float32, jnp.asarray(lengths))
    lt, ct, pt = tlm.prefill(tp, _torch_in(batch), tcfg, 32,
                             torch.float32, _t(lengths))
    _close(lt, lj, LOGIT_TOL)
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    for layer_j, layer_t in zip(unstack_layers(jcfg, cj), ct):
        assert set(layer_t) == set(layer_j)
        for key in layer_j:
            if key == "pos":
                np.testing.assert_array_equal(layer_t["pos"].numpy(),
                                              layer_j["pos"])
            else:
                _close(layer_t[key], layer_j[key], what=key)
    jstep = jlm.make_decode_step(jcfg, with_aux=True)
    tstep = tlm.make_decode_step(tcfg, with_aux=True)
    tok = np.argmax(_np(lj), -1)[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj, aux_j = jstep(jp, jnp.asarray(tok), cj, pj)
        lt, ct, aux_t = tstep(tp, _t(tok), ct, pt)
        _close(lt, lj, LOGIT_TOL)
        _close(aux_t["dropped"], aux_j["dropped"])
        tok = np.argmax(_np(lj), -1)[:, None].astype(np.int32)
        pj, pt = pj + 1, pt + 1


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_greedy_decode_tokens_equal_jax(models, arch):
    jcfg, tcfg, jp, _, tp = models[arch]
    batch = _inputs(jcfg, 2, 10, seed=9)
    want = jlm.greedy_decode(jp, _jax_in(batch), jcfg, steps=5, max_len=24)
    got = tlm.greedy_decode(tp, _torch_in(batch), tcfg, steps=5,
                            max_len=24)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_decode_matches_forward(models, arch):
    """Prefill on 8 tokens, then decode tokens 8..11: the logits equal the
    full forward's (``test_models_smoke.py``'s counterpart, its 2e-3)."""
    _, tcfg, _, _, tp = models[arch]
    toks = _t(_tokens(tcfg, (2, 12), seed=1))
    full, _, _ = ttf.forward(tp, {"tokens": toks}, tcfg)
    last, caches, pos = tlm.prefill(tp, {"tokens": toks[:, :8]}, tcfg,
                                    max_len=32, cache_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(), rtol=2e-3,
                               atol=2e-3)
    step = tlm.make_decode_step(tcfg)
    for t in range(8, 12):
        logits, caches = step(tp, toks[:, t:t + 1], caches, pos)
        np.testing.assert_allclose(
            logits.numpy(), full[:, t].numpy(), rtol=2e-3, atol=2e-3,
            err_msg=f"{arch}: decode diverges at position {t}")
        pos = pos + 1


def test_encoder_has_no_decode(models):
    _, tcfg, _, _, tp = models["hubert-xlarge"]
    with pytest.raises(ValueError, match="encoder"):
        tlm.prefill(tp, {"frames": torch.zeros((1, 4, tcfg.frontend_dim))},
                    tcfg, max_len=8)


def test_caches_from_jax_carry_every_layer_kind(models):
    """A JAX prefill's cache, carried across, decodes the port's step to
    JAX's logits (RG-LRU, local attention and Mamba layers)."""
    from repro_torch.models.convert import caches_from_jax
    for arch in ("recurrentgemma-2b", "mamba2-130m"):
        jcfg, tcfg, jp, _, tp = models[arch]
        toks = _tokens(jcfg, (2, 20), seed=11)
        _, cj, pj = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32,
                                jnp.float32)
        ct = caches_from_jax(jax.tree.map(np.asarray, cj), tcfg,
                             device="cpu")
        assert [set(c) for c in ct] == [
            {"g": {"k", "v", "pos"}, "l": {"k", "v", "pos"},
             "r": {"h", "conv"}, "m": {"ssm", "conv"}}[k]
            for k in tcfg.pattern]
        tok = toks[:, -1:]
        lj, _ = jlm.make_decode_step(jcfg)(jp, jnp.asarray(tok), cj, pj)
        lt, _ = tlm.make_decode_step(tcfg)(tp, _t(tok), ct, int(pj))
        _close(lt, lj, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-9b", "mamba2-130m",
                                  "recurrentgemma-2b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_bf16_compute_matches_jax_within_bf16(models, arch):
    """The published configs compute in bfloat16 on float32 parameters cast
    per use: the logits stay within a few bf16 steps of the JAX package's.
    (Dense layers only: in an MoE layer a bf16 rounding may flip a near-tie
    of the router and so route a token elsewhere.)"""
    jcfg, tcfg, jp, _, tp = models[arch]
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    batch = _inputs(jcfg, 1, 12, seed=10)
    lj, _, _ = jtf.forward(jp, _jax_in(batch), jcfg)
    lt, _, _ = ttf.forward(tp, _torch_in(batch), tcfg)
    assert lt.dtype == torch.float32
    scale = float(np.abs(_np(lj)).max())
    assert float(np.abs(lt.numpy() - _np(lj)).max()) <= 0.05 * scale
