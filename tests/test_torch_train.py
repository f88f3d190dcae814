"""The port's training path (``repro_torch.models.lm`` loss and train step,
``repro_torch.optim``, ``repro_torch.launch.train``) against the JAX
package's.

The same parameters (``params_from_jax``) and optimizer state
(``opt_state_from_jax``) go through both packages on the same
``SyntheticLM`` batches, in float32 on the CPU: ``loss_fn``'s loss, aux
and dropped, and every gradient, within 1e-5 (``tests/test_kernels.py``'s
float32 tolerance); one and three train steps' parameters, moments and
gradient norms likewise, the parameters within 1e-5 plus what Adam may
make of the two runs' gradient differences (``AdamW.rounding_allowance``).
Recomputing layers (``cfg.remat``) must not change a gradient or a
metric.  The cases cover every family: attention (dense and MoE), the
recurrent ones (Mamba-2, RG-LRU with local attention) and the frontends
(an audio encoder's frames, a vlm's patches).  ``train()`` must lower the
loss and resume a stopped job to the straight run's parameters (the JAX
test's 1e-5 / 1e-6, on its config, mamba2-130m).  Serving a model
that was trained builds no autograd graph, and
the sparse kernels' wrappers refuse inputs that need a gradient.
JAX references are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import lm as tlm
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamW, cosine_schedule

TOL = 1e-5
# arch -> config changes on both sides; "olmoe-1b-7b/cap1" routes at the
# published capacity factor, so the smoke batch drops tokens
CASES = {"qwen2.5-3b": {}, "llama3-8b": {}, "gemma2-9b": {},
         "olmoe-1b-7b": {}, "olmoe-1b-7b/cap1": {"capacity_factor": 1.25},
         "mamba2-130m": {}, "recurrentgemma-2b": {}, "hubert-xlarge": {},
         "llava-next-mistral-7b": {}}
BATCH, SEQ = 2, 16
STEP_CASES = ("qwen2.5-3b", "olmoe-1b-7b/cap1", "mamba2-130m",
              "recurrentgemma-2b", "hubert-xlarge", "llava-next-mistral-7b")
STEPS, LR = 3, 3e-3


def _configs(case, **over):
    arch = case.split("/")[0]
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    moe = CASES[case]
    if moe:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    assert jcfg.compute_dtype == tcfg.compute_dtype == "float32"
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


def _np(x):
    return np.asarray(x)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _named(tree, cfg):
    """A parameter-shaped JAX tree as numpy arrays keyed by the port's
    parameter names (the parameters' own conversion)."""
    return {n: p.detach().numpy() for n, p in params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, device="cpu").named_parameters()}


def _batch(cfg, step=0, seed=1):
    return SyntheticLM(cfg, BATCH, SEQ, seed=seed)(step)


@pytest.fixture(scope="module")
def grads_ref():
    """Per case: the configs, the JAX parameters, a batch, JAX's loss,
    metrics and gradients (by the port's names)."""
    out = {}
    for i, case in enumerate(CASES):
        jcfg, tcfg = _configs(case)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(i))
        batch = JSyntheticLM(jcfg, BATCH, SEQ, seed=1)(0)
        (total, metrics), grads = jax.value_and_grad(
            jlm.loss_fn, has_aux=True)(
                jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        out[case] = (jcfg, tcfg, jax.tree.map(np.asarray, jp), batch,
                     float(total), {k: float(v) for k, v in metrics.items()},
                     _named(grads, tcfg))
    return out


def _opt():
    return dict(lr=cosine_schedule(LR, 1, STEPS)), \
        dict(lr=jcosine(LR, 1, STEPS))


@pytest.fixture(scope="module")
def steps_ref():
    """Per case of ``STEP_CASES``: JAX's parameters, moments and gradient
    norms after one and after three jitted train steps from one state, and
    ``mu`` and ``nu`` after every step (for ``AdamW.rounding_allowance``)."""
    out = {}
    for i, case in enumerate(STEP_CASES):
        jcfg, tcfg = _configs(case)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(10 + i))
        opt = JAdamW(**_opt()[1])
        state = opt.init(jp)
        start = (jax.tree.map(np.asarray, jp),
                 jax.tree.map(np.asarray, state))
        step = jax.jit(jlm.make_train_step(jcfg, opt))
        after, mus, nus = {}, [], []
        p, s = jp, state
        for t in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in
                     JSyntheticLM(jcfg, BATCH, SEQ, seed=3)(t).items()}
            p, s, m = step(p, s, batch)
            mus.append(_named(s["mu"], tcfg))
            nus.append(_named(s["nu"], tcfg))
            if t + 1 in (1, STEPS):
                after[t + 1] = (_named(p, tcfg), mus[-1], nus[-1],
                                float(s["step"]), float(m["grad_norm"]),
                                float(m["loss"]))
        out[case] = (tcfg, start, after, mus, nus)
    return out


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def test_cross_entropy_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 5] = -1
    want = jlm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlm.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    _close(got, want)
    none = np.full((3, 7), -1, np.int32)
    assert float(tlm.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(none))) == 0.0
    assert float(jlm.cross_entropy(jnp.asarray(logits),
                                   jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(grads_ref, case):
    """Loss, aux and dropped, and the gradient of every parameter (the
    router's included), against ``jax.value_and_grad`` of JAX's
    ``loss_fn`` on the same parameters and batch."""
    jcfg, tcfg, tree, batch, total, metrics, grads = grads_ref[case]
    model = params_from_jax(tree, tcfg, device="cpu").requires_grad_(True)
    got, m = tlm.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tcfg)
    got.backward()
    _close(got, total, what="total loss")
    for k in ("loss", "aux", "dropped"):
        _close(m[k], metrics[k], what=k)
    if case == "olmoe-1b-7b/cap1":
        assert metrics["dropped"] > 0        # the case drops tokens
        assert metrics["aux"] > 0
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for n, p in named.items():
        # a parameter the loss does not read (an audio encoder's token
        # embedding) has no gradient here and a zero one in JAX
        _close(p.grad if p.grad is not None else torch.zeros_like(p),
               grads[n], what=n)
    if tcfg.moe is not None:
        assert any(n.endswith("moe.router") and grads[n].any()
                   for n in grads)


@pytest.mark.parametrize("case", ["qwen2.5-3b", "olmoe-1b-7b/cap1"])
def test_remat_gives_the_same_gradients_and_metrics(grads_ref, case):
    """``cfg.remat`` recomputes each layer in the backward pass: the
    gradients equal those without it (and JAX's with ``remat=True``), and
    ``dropped`` and the aux losses count once."""
    jcfg, tcfg, tree, batch, total, metrics, grads = grads_ref[case]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
        loss, m = tlm.loss_fn(model, tbatch, cfg)
        loss.backward()
        runs[remat] = (loss.detach(), m, {n: p.grad for n, p in
                                          model.named_parameters()})
    (l0, m0, g0), (l1, m1, g1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=TOL, atol=TOL)
    jr = dataclasses.replace(jcfg, remat=True)
    (_, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jr)
    jg = _named(jg, tcfg)
    _close(m1["dropped"], float(jm["dropped"]))
    for n in g1:
        _close(g1[n], jg[n], what=n)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_shift_batch_equals_jax(arch):
    """Inputs and labels of a raw batch: next-token prediction, an audio
    encoder's frame units unshifted, a vlm's patch positions labelled
    -1."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    batch = SyntheticLM(tcfg, BATCH, SEQ, seed=2)(0)
    ji, jl = jlm._shift_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              jcfg)
    ti, tl = tlm._shift_batch({k: torch.from_numpy(v)
                               for k, v in batch.items()}, tcfg)
    assert set(ti) == set(ji)
    for k in ji:
        np.testing.assert_array_equal(ti[k].numpy(), _np(ji[k]), err_msg=k)
    np.testing.assert_array_equal(tl.numpy(), _np(jl))
    if tcfg.frontend == "vlm":
        assert (tl[:, :tcfg.num_patches] == -1).all()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_opt_state_from_jax_keys_the_moments_by_parameter_name():
    jcfg, tcfg = _configs("gemma2-9b")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    state = JAdamW(nu_dtype="bfloat16").init(jp)
    state = jax.tree.map(lambda x: x + 1, state)
    got = opt_state_from_jax(jax.tree.map(np.asarray, state), tcfg,
                             device="cpu")
    names = [n for n, _ in params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu")
             .named_parameters()]
    assert list(got["mu"]) == list(got["nu"]) == names
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 1
    assert float(got["gnorm"]) == 1.0
    assert all(v.dtype == torch.float32 and bool((v == 1).all())
               for v in got["mu"].values())
    assert all(v.dtype == torch.bfloat16 and bool((v == 1).all())
               for v in got["nu"].values())
    fresh = AdamW(nu_dtype="bfloat16").init(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    assert {n: (v.shape, v.dtype) for n, v in fresh["nu"].items()} \
        == {n: (v.shape, v.dtype) for n, v in got["nu"].items()}


@pytest.mark.parametrize("n_steps", [1, STEPS])
@pytest.mark.parametrize("case", STEP_CASES)
def test_train_steps_match_jax(steps_ref, case, n_steps):
    """``make_train_step`` from JAX's parameters and AdamW state, on the
    same batches: parameters, ``mu``, ``nu``, the step and the gradient
    norm after one and after three steps."""
    tcfg, (tree, state), after, jmus, nus = steps_ref[case]
    model = params_from_jax(tree, tcfg, device="cpu")
    opt_state = opt_state_from_jax(state, tcfg, device="cpu")
    topt = AdamW(**_opt()[0])
    step = tlm.make_train_step(tcfg, topt)
    mus = []
    for t in range(n_steps):
        batch = {k: torch.from_numpy(v) for k, v in
                 SyntheticLM(tcfg, BATCH, SEQ, seed=3)(t).items()}
        model, opt_state, metrics = step(model, opt_state, batch)
        mus.append({n: v.numpy().copy() for n, v in opt_state["mu"].items()})
    params, mu, nu, n, gnorm, loss = after[n_steps]
    assert int(opt_state["step"]) == n
    _close(metrics["grad_norm"], gnorm, what="grad_norm")
    _close(metrics["loss"], loss, what="loss")
    for name, p in model.named_parameters():
        _close(opt_state["mu"][name], mu[name], what="mu/" + name)
        _close(opt_state["nu"][name], nu[name], what="nu/" + name)
        err = np.abs(p.detach().numpy() - params[name])
        allowed = TOL + TOL * np.abs(params[name]) + topt.rounding_allowance(
            [x[name] for x in nus[:n_steps]], [x[name] for x in mus],
            [x[name] for x in jmus[:n_steps]], TOL)
        assert (err <= allowed).all(), (
            f"{name}: |port - JAX| up to {err.max():.3g}, "
            f"{int((err > allowed).sum())} elements past the allowance")


def test_update_and_apply_agree():
    """``update`` (the reference's: a tree of updates) and ``apply`` (each
    update added as it is computed) give the same parameters and state."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for n, s in shapes.items()}
    grads = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, s in shapes.items()}
    opt = AdamW(lr=cosine_schedule(0.1, 2, 10), clip_norm=0.5)
    pa, pb = ({n: v.clone() for n, v in p0.items()} for _ in range(2))
    sa, sb = opt.init(pa), opt.init(pb)
    for _ in range(3):
        upd, sa = opt.update(grads, sa, pa)
        pa = {n: pa[n] + upd[n] for n in pa}
        sb = opt.apply(pb, grads, sb)
    for n in shapes:
        assert torch.equal(pa[n], pb[n])
        assert torch.equal(sa["mu"][n], sb["mu"][n])
        assert torch.equal(sa["nu"][n], sb["nu"][n])
    assert torch.equal(sa["gnorm"], sb["gnorm"])
    assert int(sa["step"]) == int(sb["step"]) == 3


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------
def test_train_needs_a_card_unless_told_the_cpu():
    from repro_torch.launch import train as launch_train
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: train() would run on it")
    cfg = tconfigs.get_config("qwen2.5-3b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, steps=1, batch=1, seq=4, log_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "hubert-xlarge", "llava-next-mistral-7b"])
def test_train_cli_runs_every_family(capsys, arch):
    """The CLI trains the recurrent and frontend families on their own
    batches (tokens, frames, patches and tokens)."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                              "--batch", "2", "--seq", "16",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mean loss" in out and "nan" not in out


def test_loss_decreases_tiny_lm():
    """The port's counterpart of ``test_train_loop.py``'s first test."""
    cfg = tconfigs.get_config("qwen2.5-3b", smoke=True)
    state = train(cfg, steps=30, batch=4, seq=32, lr=3e-3, ckpt_dir=None,
                  log_every=0, device="cpu")
    losses = np.asarray(state["losses"])
    assert len(losses) == len(state["grad_norms"]) == len(state["step_s"]) \
        == 30
    assert np.isfinite(losses).all() and np.isfinite(state["grad_norms"]).all()
    assert losses[-5:].mean() < losses[:5].mean(), \
        f"loss did not decrease: {losses[:5]} -> {losses[-5:]}"


def _params_close(a, b):
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=na)


def test_checkpoint_resume_equals_the_straight_run(tmp_path):
    """train 20 straight == train 10, 'crash', resume to 20 (the port's
    counterpart of ``test_train_loop.py``'s resume test, on its config,
    mamba2-130m smoke)."""
    cfg = tconfigs.get_config("mamba2-130m", smoke=True)
    kw = dict(steps=20, batch=2, seq=16, ckpt_every=100, log_every=0,
              seed=7, device="cpu")
    full = train(cfg, ckpt_dir=str(tmp_path / "straight"), **kw)
    d2 = str(tmp_path / "resumed")
    first = train(cfg, ckpt_dir=d2, stop_after=10, **kw)
    assert len(first["losses"]) == 10
    second = train(cfg, ckpt_dir=d2, **kw)
    assert len(second["losses"]) == 10
    np.testing.assert_allclose(second["losses"], full["losses"][10:],
                               rtol=1e-5, atol=1e-6)
    _params_close(full["params"], second["params"])
    assert int(second["opt"]["step"]) == int(full["opt"]["step"]) == 20


def test_resume_from_a_periodic_checkpoint(tmp_path):
    """A periodic checkpoint holds the steps before its label: a job whose
    last checkpoint is a periodic one resumes to the straight run's
    parameters, taking no batch twice."""
    import shutil
    cfg = tconfigs.get_config("qwen2.5-3b", smoke=True)
    kw = dict(steps=12, batch=2, seq=16, ckpt_every=4, log_every=0,
              seed=5, device="cpu")
    full = train(cfg, **kw)
    d = tmp_path / "run"
    train(cfg, ckpt_dir=str(d), stop_after=6, **kw)
    shutil.rmtree(d / "step_6")        # the crash lost the final save
    resumed = train(cfg, ckpt_dir=str(d), **kw)
    assert len(resumed["losses"]) == 8           # steps 4..11
    np.testing.assert_allclose(resumed["losses"], full["losses"][4:],
                               rtol=1e-5, atol=1e-6)
    _params_close(full["params"], resumed["params"])


def test_serving_a_trained_model_builds_no_graph():
    """After training, the parameters require gradients; the serving
    steps still run without them."""
    from repro_torch.serving import ServeEngine
    cfg = tconfigs.get_config("qwen2.5-3b", smoke=True)
    model = train(cfg, steps=2, batch=2, seq=8, log_every=0,
                  device="cpu")["params"]
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :8])
    logits, caches, _ = tlm.prefill(model, {"tokens": toks}, cfg, 16,
                                    torch.float32)
    assert not logits.requires_grad
    step = tlm.make_decode_step(cfg)
    logits, _ = step(model, toks[:, :1], caches, 8)
    assert not logits.requires_grad
    out = tlm.greedy_decode(model, {"tokens": toks}, cfg, 3, 16)
    assert out.shape == (BATCH, 3)
    eng = ServeEngine(cfg, params=model, max_len=24, device="cpu")
    eng.submit(toks[0].numpy(), max_new_tokens=3)
    res = eng.run()
    np.testing.assert_array_equal(res[0], out[0].numpy())


def test_kernel_wrappers_refuse_inputs_that_need_a_gradient():
    """B1-B3 have no backward: while grad mode is on, a wrapper given an
    input that requires grad raises instead of computing a result cut off
    from autograd; under ``no_grad`` it runs."""
    blocks = torch.randn(3, 4, 4, requires_grad=True)
    rows = torch.tensor([0, 1, 1], dtype=torch.int32)
    cols = torch.tensor([0, 0, 1], dtype=torch.int32)
    dense = torch.randn(8, 5)
    pairs = [torch.tensor([0, 1], dtype=torch.int32)] * 2
    calls = {
        "bsr_spmm_raw": lambda: ops.bsr_spmm_raw(blocks, rows, cols, dense,
                                                 n_block_rows=2),
        "bsr_pair_matmul": lambda: ops.bsr_pair_matmul(
            blocks, blocks.detach(), *pairs, *pairs, n_block_rows=2,
            n_block_cols=2),
        "bsr_pair_accumulate": lambda: ops.bsr_pair_accumulate(
            blocks.detach(), blocks, *pairs, pairs[0], n_slots=2),
        "steal_pair_accumulate": lambda: ops.steal_pair_accumulate(
            blocks.detach(), dense, *pairs, pairs[0], n_slots=2,
            out=torch.zeros(2 * 4, 5, requires_grad=True)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
