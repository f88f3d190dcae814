"""The port's recurrent, SSM and frontend layers (``repro_torch.models``
``rglru``, ``ssm``, ``frontend``) against the JAX package's.

The same inputs, drawn from numpy seeds, and the same parameters (the
smoke configs' JAX layers, carried across by ``params_from_jax``) go
through both packages on the CPU, in float32 within 1e-5
(``tests/test_kernels.py``'s tolerance): the RG-LRU block's gates, conv,
full-sequence forward (the port's log-depth scan where the reference runs
``jax.lax.associative_scan``, at T 1, 2, 7 and 64 too) and one-step
decode; the Mamba-2 SSD's chunked form (T a multiple of the chunk and
not), final state, forward and decode; the audio and vlm frontends.  In
bfloat16 the outputs stay within the reference's 2e-2 of JAX's.

The reference's SSD overflows in its gradient (``_ssd_chunked`` takes
``exp`` of the intra-chunk segment sums before masking the upper
triangle): at chunk 256 and dt 0.1 JAX's gradients w.r.t. ``dt`` and
``a_log`` are non-finite, while the port's equal JAX's at chunk 16 (the
same function, with small exponents) within 1e-5 of their largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import frontend as jfront
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.models import frontend as tfront
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
BF16_TOL = 2e-2          # tests/test_models_smoke.py's bf16 tolerance


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, _np(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol, err_msg=what)


def _model(arch, seed=0):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch, i) for i, arch in enumerate(
        ("recurrentgemma-2b", "mamba2-130m", "hubert-xlarge",
         "llava-next-mistral-7b"))}


def _layer(models, arch, part):
    """(jcfg, tcfg, JAX params, port params) of the first layer holding
    ``part`` (``"rec"`` or ``"mamba"``)."""
    jcfg, tcfg, jp, tp = models[arch]
    kind = {"rec": "r", "mamba": "m"}[part]
    li = jcfg.pattern.index(kind)
    pj = jtf.unstack_groups(jcfg, jp["groups"])[li][part]
    return jcfg, tcfg, pj, getattr(tp.layers[li], part)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def test_rglru_gates_and_block_projection(models):
    jcfg, tcfg, pj, pt = _layer(models, "recurrentgemma-2b", "rec")
    xc = _x((2, 9, trglru._w(tcfg)), 0)
    _close(trglru._block_proj(_t(xc), pt.gate_a, pt.gate_a_b),
           jrglru._block_proj(jnp.asarray(xc), pj["gate_a"],
                              pj["gate_a_b"]))
    aj, bj = jrglru._gates(pj, jnp.asarray(xc))
    at, bt = trglru._gates(pt, _t(xc))
    assert at.dtype == bt.dtype == torch.float32
    _close(at, aj, what="a")
    _close(bt, bj, what="b")


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_conv(models, with_state):
    jcfg, tcfg, pj, pt = _layer(models, "recurrentgemma-2b", "rec")
    w = trglru._w(tcfg)
    xb = _x((2, 6, w), 1)
    state = _x((2, 3, w), 2) if with_state else None
    oj, sj = jrglru._conv(jnp.asarray(xb), pj,
                          None if state is None else jnp.asarray(state))
    ot, st = trglru._conv(_t(xb), pt, None if state is None else _t(state))
    _close(ot, oj)
    _close(st, sj)


@pytest.mark.parametrize("t", [1, 2, 7, 64])
def test_rglru_scan_equals_the_associative_scan(t):
    """The log-depth scan against ``jax.lax.associative_scan`` of the
    reference's combine, on decays near 1 and near 0."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.05, 0.999, (2, t, 5)).astype(np.float32)
    b = rng.standard_normal((2, t, 5)).astype(np.float32)

    def combine(u, v):
        a1, b1 = u
        a2, b2 = v
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    _close(trglru._scan(_t(a), _t(b)), want)
    # and the recurrence itself, step by step
    h = np.zeros((2, 5), np.float64)
    seq = []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    _close(trglru._scan(_t(a), _t(b)), np.stack(seq, 1))


def test_rglru_scan_keeps_long_products_of_small_decays():
    """Hundreds of decays below 1: a closed form by cumprod underflows
    to 0, the scan keeps h = b[t] + a[t] h[t-1] exact."""
    t = 600
    a = np.full((1, t, 1), 0.5, np.float32)
    b = np.ones((1, t, 1), np.float32)
    h = trglru._scan(_t(a), _t(b))
    assert torch.isfinite(h).all()
    _close(h[0, -1, 0], 2.0)


def test_rglru_forward_and_prefill_cache(models):
    jcfg, tcfg, pj, pt = _layer(models, "recurrentgemma-2b", "rec")
    x = _x((2, 21, jcfg.d_model), 3)
    cj = jrglru.init_rglru_cache(jcfg, 2)
    ct = trglru.init_rglru_cache(tcfg, 2)
    yj, cj = jrglru.rglru_forward(pj, jnp.asarray(x), jcfg, cj)
    yt, ct = trglru.rglru_forward(pt, _t(x), tcfg, ct)
    _close(yt, yj)
    for key in ("h", "conv"):
        assert ct[key].dtype == torch.float32
        _close(ct[key], cj[key], what=key)
    y0, none = trglru.rglru_forward(pt, _t(x), tcfg)
    assert none is None and torch.equal(y0, yt)


def test_rglru_decode_steps(models):
    """Prefill then three decode steps, the cache carried, against JAX's,
    and the decoded outputs against the full forward's."""
    jcfg, tcfg, pj, pt = _layer(models, "recurrentgemma-2b", "rec")
    x = _x((2, 12, jcfg.d_model), 4)
    _, cj = jrglru.rglru_forward(pj, jnp.asarray(x[:, :9]), jcfg,
                                 jrglru.init_rglru_cache(jcfg, 2))
    _, ct = trglru.rglru_forward(pt, _t(x[:, :9]), tcfg,
                                 trglru.init_rglru_cache(tcfg, 2))
    full, _ = trglru.rglru_forward(pt, _t(x), tcfg)
    for i in range(9, 12):
        yj, cj = jrglru.rglru_decode(pj, jnp.asarray(x[:, i:i + 1]), cj,
                                     jcfg)
        yt, ct = trglru.rglru_decode(pt, _t(x[:, i:i + 1]), ct, tcfg)
        _close(yt, yj, what=f"step {i}")
        _close(ct["h"], cj["h"], what=f"h {i}")
        _close(yt[:, 0], full[:, i], what=f"decode vs forward {i}")


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------
def _ssd_inputs(tcfg, t, seed, dt_scale=0.05):
    s, di, nh = tssm._dims(tcfg)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((2, t, nh, s.head_dim)).astype(np.float32)
    bmat = rng.standard_normal((2, t, s.d_state)).astype(np.float32)
    cmat = rng.standard_normal((2, t, s.d_state)).astype(np.float32)
    dt = (rng.uniform(0.2, 1.0, (2, t, nh)) * dt_scale).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    return xh, bmat, cmat, dt, a_log


@pytest.mark.parametrize("t", [16, 32, 21, 5])
def test_ssd_chunked(models, t):
    """T a whole number of chunks (16, 32) and not (21: padded with
    identity steps; 5: one short chunk) at the smoke chunk of 16."""
    _, tcfg, _, _ = models["mamba2-130m"]
    chunk = tcfg.ssm.chunk
    args = _ssd_inputs(tcfg, t, seed=t)
    want = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    got = tssm._ssd_chunked(*map(_t, args), chunk)
    assert got.shape == want.shape
    _close(got, want)
    # the chunking does not change the function
    _close(tssm._ssd_chunked(*map(_t, args), 4), want)


def test_final_state(models):
    _, tcfg, _, _ = models["mamba2-130m"]
    xh, bmat, cmat, dt, a_log = _ssd_inputs(tcfg, 19, seed=5)
    want = jssm._final_state(*map(jnp.asarray, (xh, bmat, cmat, dt,
                                                a_log)))
    _close(tssm._final_state(*map(_t, (xh, bmat, cmat, dt, a_log))), want)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_and_split(models, with_state):
    jcfg, tcfg, pj, pt = _layer(models, "mamba2-130m", "mamba")
    x = _x((2, 7, jcfg.d_model), 6)
    parts_j = jssm._split_proj(pj, jnp.asarray(x), jcfg)
    parts_t = tssm._split_proj(pt, _t(x), tcfg)
    for got, want in zip(parts_t, parts_j):
        _close(got, want)
    xbc = _np(parts_j[1])
    state = _x((2, 3, xbc.shape[-1]), 7) if with_state else None
    oj, sj = jssm._causal_conv(jnp.asarray(xbc), pj, jcfg,
                               None if state is None else jnp.asarray(state))
    ot, st = tssm._causal_conv(_t(xbc), pt, tcfg,
                               None if state is None else _t(state))
    _close(ot, oj)
    _close(st, sj)


@pytest.mark.parametrize("t", [16, 21])
def test_mamba_forward_and_prefill_cache(models, t):
    jcfg, tcfg, pj, pt = _layer(models, "mamba2-130m", "mamba")
    x = _x((2, t, jcfg.d_model), 8)
    cj = jssm.init_mamba_cache(jcfg, 2)
    ct = tssm.init_mamba_cache(tcfg, 2)
    yj, cj = jssm.mamba_forward(pj, jnp.asarray(x), jcfg, cj)
    yt, ct = tssm.mamba_forward(pt, _t(x), tcfg, ct)
    _close(yt, yj)
    for key in ("ssm", "conv"):
        assert ct[key].dtype == torch.float32
        _close(ct[key], cj[key], what=key)


def test_mamba_decode_steps(models):
    jcfg, tcfg, pj, pt = _layer(models, "mamba2-130m", "mamba")
    x = _x((2, 12, jcfg.d_model), 9)
    _, cj = jssm.mamba_forward(pj, jnp.asarray(x[:, :9]), jcfg,
                               jssm.init_mamba_cache(jcfg, 2))
    _, ct = tssm.mamba_forward(pt, _t(x[:, :9]), tcfg,
                               tssm.init_mamba_cache(tcfg, 2))
    full, _ = tssm.mamba_forward(pt, _t(x), tcfg)
    for i in range(9, 12):
        yj, cj = jssm.mamba_decode(pj, jnp.asarray(x[:, i:i + 1]), cj, jcfg)
        yt, ct = tssm.mamba_decode(pt, _t(x[:, i:i + 1]), ct, tcfg)
        assert yt.dtype == torch.float32
        _close(yt, yj, what=f"step {i}")
        _close(ct["ssm"], cj["ssm"], what=f"ssm {i}")
        _close(yt[:, 0], full[:, i], what=f"decode vs forward {i}")


def test_mamba_decode_keeps_the_residual_type(models):
    """A bf16 step over the float32 state returns bf16 (the reference's
    cast: the state must not promote the residual), within 2e-2 of
    JAX's."""
    jcfg, tcfg, pj, pt = _layer(models, "mamba2-130m", "mamba")
    x = _x((2, 1, jcfg.d_model), 10)
    cj = jssm.init_mamba_cache(jcfg, 2)
    ct = tssm.init_mamba_cache(tcfg, 2)
    yj, cj = jssm.mamba_decode(pj, jnp.asarray(x, jnp.bfloat16), cj, jcfg)
    yt, ct = tssm.mamba_decode(pt, _t(x).bfloat16(), ct, tcfg)
    assert yt.dtype == torch.bfloat16 and ct["ssm"].dtype == torch.float32
    _close(yt, yj, BF16_TOL)


# ---------------------------------------------------------------------------
# the reference's SSD overflow, mended
# ---------------------------------------------------------------------------
def _ssd_grads_jax(args, chunk):
    xh, bmat, cmat, dt, a_log, w = map(jnp.asarray, args)

    def f(dt, a_log):
        return jnp.sum(jssm._ssd_chunked(xh, bmat, cmat, dt, a_log, chunk)
                       * w)
    return jax.value_and_grad(f, argnums=(0, 1))(dt, a_log)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """B 1, T 256, H 2 (A = 1 and 16), a constant dt of 0.1: A dt (L - 1)
    reaches 408 at chunk 256, past float32's 88.7.  JAX's value is finite
    and its gradients are not; the port's value and gradients at chunk 256
    equal JAX's at chunk 16 (A dt (L - 1) = 24) within 1e-5 of their
    largest magnitude.  (Elementwise 1e-5 is out of float32's reach here:
    at chunk 256 each decay is ``exp`` of a difference of cumulative sums
    near -400, whose rounding, ~400 x 6e-8, is a 2.4e-5 relative error of
    the decay, in JAX's forward as in the port's.)"""
    rng = np.random.default_rng(11)
    t, h, p, n = 256, 2, 4, 8
    args = (rng.standard_normal((1, t, h, p)).astype(np.float32),
            rng.standard_normal((1, t, n)).astype(np.float32),
            rng.standard_normal((1, t, n)).astype(np.float32),
            np.full((1, t, h), 0.1, np.float32),
            np.log(np.array([1.0, 16.0], np.float32)),
            rng.standard_normal((1, t, h, p)).astype(np.float32))
    val256, (gdt256, ga256) = _ssd_grads_jax(args, 256)
    assert np.isfinite(float(val256))
    assert not np.isfinite(_np(gdt256)).all()
    assert not np.isfinite(_np(ga256)).all()
    val16, (gdt16, ga16) = _ssd_grads_jax(args, 16)
    assert np.isfinite(_np(gdt16)).all() and np.isfinite(_np(ga16)).all()

    xh, bmat, cmat, dt, a_log, w = map(_t, args)
    dt.requires_grad_(True)
    a_log.requires_grad_(True)
    val = (tssm._ssd_chunked(xh, bmat, cmat, dt, a_log, 256) * w).sum()
    val.backward()
    _close(val, val16, what="value")
    _close(val, val256, what="value at the reference's chunk")
    for got, want, what in ((dt.grad, gdt16, "d/d dt"),
                            (a_log.grad, ga16, "d/d a_log")):
        want = _np(want)
        assert torch.isfinite(got).all(), what
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * np.abs(want).max(), (what, err)


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------
def test_audio_embed(models):
    jcfg, tcfg, jp, tp = models["hubert-xlarge"]
    frames = _x((2, 9, jcfg.frontend_dim), 12)
    _close(tfront.audio_embed(tp.frontend, _t(frames), tcfg),
           jfront.audio_embed(jp["frontend"], jnp.asarray(frames), jcfg))


def test_vlm_embed(models):
    jcfg, tcfg, jp, tp = models["llava-next-mistral-7b"]
    patches = _x((2, jcfg.num_patches, jcfg.frontend_dim), 13)
    _close(tfront.vlm_embed(tp.frontend, _t(patches), tcfg),
           jfront.vlm_embed(jp["frontend"], jnp.asarray(patches), jcfg))


def test_frontend_weights_follow_the_config():
    for arch, keys in (("hubert-xlarge", {"proj", "ln_scale", "ln_bias"}),
                       ("llava-next-mistral-7b", {"proj1", "proj2"}),
                       ("mamba2-130m", None)):
        cfg = tconfigs.get_config(arch, smoke=True)
        fr = tfront.init_frontend(cfg, torch.Generator().manual_seed(0))
        assert (fr is None) if keys is None else \
            {n for n, _ in fr.named_parameters()} == keys


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("part", ["rec", "mamba"])
def test_bf16_forward_within_the_reference_tolerance(models, part):
    arch = "recurrentgemma-2b" if part == "rec" else "mamba2-130m"
    jcfg, tcfg, pj, pt = _layer(models, arch, part)
    x = _x((2, 21, jcfg.d_model), 14)
    jfwd = jrglru.rglru_forward if part == "rec" else jssm.mamba_forward
    tfwd = trglru.rglru_forward if part == "rec" else tssm.mamba_forward
    yj, _ = jfwd(pj, jnp.asarray(x, jnp.bfloat16), jcfg)
    yt, _ = tfwd(pt, _t(x).bfloat16(), tcfg)
    assert yt.dtype == torch.bfloat16
    _close(yt, yj, BF16_TOL)
