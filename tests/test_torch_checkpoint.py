"""The port's checkpoint manager (``repro_torch.ckpt``): the five cases of
``tests/test_checkpoint.py`` (roundtrip, garbage collection, async save,
structure mismatch, an uncommitted write), on a model and an AdamW state,
plus what in-place restore and async snapshots add: restored values land
in the caller's tensors, bfloat16 moments survive numpy, a shape mismatch
raises, and a snapshot taken at ``save()`` is what gets written even when
the tensors change while the writer runs.
"""
import json
import os

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW


def _tree(seed=0, nu_dtype="float32"):
    cfg = tconfigs.get_config("qwen2.5-3b", smoke=True)
    model = ttf.init_params(cfg, seed=seed, device="cpu")
    opt = AdamW(nu_dtype=nu_dtype).init(model)
    gen = torch.Generator().manual_seed(seed)
    for v in list(opt["mu"].values()) + list(opt["nu"].values()):
        v.copy_(torch.rand(v.shape, generator=gen))
    opt["step"].fill_(3)
    opt["gnorm"].fill_(0.5 + seed)
    return model, opt


def _flat(model, opt):
    out = dict(model.named_parameters())
    out.update(step=opt["step"], gnorm=opt["gnorm"])
    out.update({f"mu/{n}": v for n, v in opt["mu"].items()})
    out.update({f"nu/{n}": v for n, v in opt["nu"].items()})
    return out


def _assert_equal(a, b):
    fa, fb = _flat(*a), _flat(*b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].detach(), fb[k].detach()), k


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    saved = _tree(0)
    mgr.save(5, *saved, extra={"loss": 1.25})
    like = _tree(1)
    step, (model, opt), extra = mgr.restore(None, like)
    assert step == 5 and extra["loss"] == 1.25
    assert model is like[0] and opt is like[1]      # restored in place
    _assert_equal(saved, (model, opt))
    with open(tmp_path / "step_5" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert "step" in keys and "top.embed" in keys
    assert "mu/layers.0.attn.wq" in keys and "nu/top.embed" in keys


def test_bfloat16_moments_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    saved = _tree(0, nu_dtype="bfloat16")
    mgr.save(2, *saved)
    _, restored, _ = mgr.restore(2, _tree(1, nu_dtype="bfloat16"))
    assert restored[1]["nu"]["top.embed"].dtype == torch.bfloat16
    _assert_equal(saved, restored)


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, *tree)
    assert mgr.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, *_tree())
    mgr.wait()
    assert mgr.latest_step() == 7


def test_async_save_writes_the_snapshot_taken_at_save(tmp_path):
    """The next step updates the parameters in place while the writer
    runs; the checkpoint holds the values of the ``save()`` call."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    model, opt = _tree()
    want = {k: v.detach().clone() for k, v in _flat(model, opt).items()}
    mgr.save(1, model, opt)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        opt["step"].add_(1)
    mgr.wait()
    _, restored, _ = mgr.restore(1, _tree(2))
    got = _flat(*restored)
    for k in want:
        assert torch.equal(got[k].detach(), want[k]), k


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    model, opt = _tree()
    mgr.save(1, model, opt)
    bad = dict(opt)
    bad["mu"] = {n: v for n, v in opt["mu"].items() if n != "top.embed"}
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(None, (model, bad))
    other = tconfigs.get_config("llama3-8b", smoke=True)
    small = ttf.init_params(other, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(None, (small, AdamW().init(small)))


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    model, opt = _tree()
    mgr.save(1, model, opt)
    bad = dict(opt, gnorm=torch.zeros(2))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(None, (model, bad))


def test_partial_write_is_invisible(tmp_path):
    """A staging dir without manifest must not count as a checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, *_tree())
    os.makedirs(tmp_path / "step_9", exist_ok=True)  # crashed writer stub
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, _tree())


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "hubert-xlarge", "llava-next-mistral-7b"])
def test_roundtrip_of_the_recurrent_and_frontend_families(tmp_path, arch):
    """The RG-LRU (``rec``), Mamba (``mamba``) and frontend parameters and
    their moments save under their names and restore in place."""
    cfg = tconfigs.get_config(arch, smoke=True)
    models = [ttf.init_params(cfg, seed=s, device="cpu") for s in (0, 1)]
    states = [AdamW().init(m) for m in models]
    for v in states[0]["mu"].values():
        v.fill_(0.25)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, models[0], states[0])
    step, (model, opt), _ = mgr.restore(None, (models[1], states[1]))
    assert step == 2 and model is models[1]
    _assert_equal((models[0], states[0]), (model, opt))
    with open(tmp_path / "step_2" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    part = {"mamba2-130m": "mamba.a_log", "recurrentgemma-2b": "rec.lam",
            "hubert-xlarge": "frontend.ln_scale",
            "llava-next-mistral-7b": "frontend.proj2"}[arch]
    assert any(k.endswith(part) for k in keys), part
