"""Sharding specs and placements: the port's against the JAX package's.

For every config of the registry, the port's parameter, cache and AdamW
state specs (``transformer.param_specs``, ``cache_specs``,
``AdamW.state_specs``; one module per layer, keyed by parameter name)
equal the reference's (``models/convert.py`` maps its stacked trees),
raw and sanitized on a 16x16, a 2x16x16, a 1x4 and a 2x2 mesh.  JAX
sanitizes against an ``AbstractMesh`` (no devices) and the abstract
shapes of ``jax.eval_shape``; the port against the same shapes without
the scan's leading axis and the mesh's ``{axis: size}``.  Besides:
``filter_spec`` and ``batch_partition_spec`` equal JAX's, the
divisibility cases of GQA's kv heads, DTensor placements (mesh order
refused otherwise), ``make_production_mesh`` on a fake world of 256 and
512 ranks, and ``constrain`` outside and inside a mesh.
"""
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import get_config as jget, list_archs
from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import P
from repro_torch.models import convert, transformer as tf
from repro_torch.models.common import BATCH_AXES, MODEL_AXIS, constrain
from repro_torch.optim import AdamW

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
CACHE = dict(batch=16, max_len=512)


def _sizes(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _jmesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _p(spec) -> P:
    return P(*(tuple(e) if isinstance(e, (list, tuple)) else e
               for e in spec))


def _unstacked_shapes(cfg, tree):
    """The reference's abstract parameter tree as the port's names ->
    per-layer shapes (the scan's leading axis dropped)."""
    shapes = convert.specs_from_jax(
        jax.tree.map(lambda x: JP(*x.shape), tree), cfg)
    return {n: tuple(s) for n, s in shapes.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jc = jget(name)
    abstract = jax.eval_shape(lambda k: jtf.init_params(jc, k),
                              jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: jtf.init_cache(jc, CACHE["batch"],
                                                   CACHE["max_len"]))
    return name, jc, get_config(name), abstract, caches


def test_raw_param_and_cache_specs_equal_jax(arch):
    name, jc, tc, _, _ = arch
    for smoke in (False, True):
        jcfg, tcfg = (jget(name, smoke=True), get_config(name, smoke=True)) \
            if smoke else (jc, tc)
        assert convert.specs_from_jax(jtf.param_specs(jcfg), tcfg) \
            == tf.param_specs(tcfg)
        assert convert.cache_specs_from_jax(jtf.cache_specs(jcfg), tcfg) \
            == tf.cache_specs(tcfg)


def test_param_specs_name_every_parameter():
    for name in ARCHS:
        cfg = get_config(name, smoke=True)
        model = tf.init_params(cfg, device="cpu")
        assert sorted(tf.param_specs(cfg)) == sorted(
            n for n, _ in model.named_parameters())
        assert len(tf.cache_specs(cfg)) == len(tf.init_cache(
            cfg, 2, 8, device="cpu"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitized_param_specs_equal_jax(arch, mesh):
    name, jc, tc, abstract, _ = arch
    jm, sizes = _jmesh(mesh), _sizes(mesh)
    jspecs = jtf.param_specs(jc)
    jsan = jax.tree.map(lambda s, x: jmesh.sanitize_spec(s, x.shape, jm),
                        jspecs, abstract,
                        is_leaf=lambda s: isinstance(s, JP))
    want = convert.specs_from_jax(jsan, tc)
    shapes = _unstacked_shapes(tc, abstract)
    got = {n: tmesh.sanitize_spec(s, shapes[n], sizes)
           for n, s in tf.param_specs(tc).items()}
    assert got == want
    # AdamW's moments shard like the parameters, step and norm replicate
    jstate = JAdamW.state_specs(jspecs)
    tstate = AdamW.state_specs(tf.param_specs(tc))
    assert tstate["step"] == _p(jstate["step"]) == P()
    assert tstate["gnorm"] == _p(jstate["gnorm"])
    for k in ("mu", "nu"):
        opt_abs = jax.eval_shape(JAdamW().init, abstract)[k]
        jm_san = jax.tree.map(
            lambda s, x: jmesh.sanitize_spec(s, x.shape, jm), jstate[k],
            opt_abs, is_leaf=lambda s: isinstance(s, JP))
        assert {n: tmesh.sanitize_spec(s, shapes[n], sizes)
                for n, s in tstate[k].items()} \
            == convert.specs_from_jax(jm_san, tc)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitized_cache_specs_equal_jax(arch, mesh):
    name, jc, tc, _, caches = arch
    jm, sizes = _jmesh(mesh), _sizes(mesh)
    jsan = jax.tree.map(lambda s, x: jmesh.sanitize_spec(s, x.shape, jm),
                        jtf.cache_specs(jc), caches,
                        is_leaf=lambda s: isinstance(s, JP))
    want = convert.cache_specs_from_jax(jsan, tc)
    shapes = convert.cache_specs_from_jax(
        jax.tree.map(lambda x: JP(*x.shape), caches), tc)
    got = [{k: tmesh.sanitize_spec(s, tuple(shapes[i][k]), sizes)
            for k, s in layer.items()}
           for i, layer in enumerate(tf.cache_specs(tc))]
    assert got == want


SPECS = [JP(), JP(None), JP("data", "model"), JP(("pod", "data"), None),
         JP(("pod", "data"), "model", None), JP("pod", "model"),
         JP(None, ("data", "model")), JP("model", None, "data")]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_filter_and_batch_specs_equal_jax(mesh):
    jm, sizes = _jmesh(mesh), _sizes(mesh)
    for s in SPECS:
        assert tmesh.filter_spec(_p(s), sizes) \
            == _p(jmesh.filter_spec(s, jm))
        for shape in ((32, 64, 8), (6, 5, 4), (2, 48), (512,)):
            assert tmesh.sanitize_spec(_p(s), shape, sizes) \
                == _p(jmesh.sanitize_spec(s, shape, jm))
    for batch in (1, 2, 4, 6, 16, 32, 64, 128):
        for trailing in ((), (None,), (None, "model")):
            assert tmesh.batch_partition_spec(batch, sizes, trailing) \
                == _p(jmesh.batch_partition_spec(batch, jm, trailing))


def test_gqa_kv_heads_shard_only_where_the_axis_divides():
    """Qwen2.5-3B's 2 kv heads: replicated on a model axis of 4, sharded
    on 2 (the activations' constraint in attention)."""
    cfg = get_config("qwen2.5-3b")
    k_shape = (4, 512, cfg.n_kv_heads, cfg.resolved_head_dim)
    spec = P(BATCH_AXES, None, MODEL_AXIS, None)
    assert tmesh.sanitize_spec(spec, k_shape, _sizes("1x4")) \
        == P("data", None, None, None)
    assert tmesh.sanitize_spec(spec, k_shape, _sizes("2x2")) \
        == P("data", None, "model", None)
    # its attention weights' kv projection (2 x 128 columns) divides both
    wk = (cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim)
    for mesh in ("1x4", "2x2", "16x16"):
        assert tmesh.sanitize_spec(P("data", MODEL_AXIS), wk, _sizes(mesh)) \
            == _p(jmesh.sanitize_spec(JP("data", "model"), wk,
                                      _jmesh(mesh)))


class _FakeMesh:
    """A mesh's shape and axis names (the coordinate is passed)."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sizes = _sizes("2x16x16")
    assert tmesh.placements_of(P(("pod", "data"), "model"), sizes) \
        == (Shard(0), Shard(0), Shard(1))
    assert tmesh.placements_of(P(None, "data"), sizes) \
        == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tmesh.placements_of(P(("data", "pod")), sizes)
    with pytest.raises(ValueError, match="twice"):
        tmesh.placements_of(P("data", "data"), sizes)
    tree = {"a": P("data", "model"), "b": [P(None), P("pod")]}
    got = tmesh.placements_for(tree, _sizes("2x2"))
    assert got == {"a": (Shard(0), Shard(1)),
                   "b": [(Replicate(), Replicate()),
                         (Replicate(), Replicate())]}
    shapes = {"a": (4, 3), "b": [(2,), (5,)]}
    assert tmesh.sanitized_placements(tree, shapes, _sizes("2x2"))["a"] \
        == (Shard(0), Replicate())


def test_local_chunk_is_the_nested_shard():
    """A dimension split over (pod, data): pod major, as DTensor and the
    reference's PartitionSpec tuple order."""
    mesh = _FakeMesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6).reshape(8, 6)
    pl = tmesh.placements_of(P(("pod", "data"), "model"),
                             tmesh.mesh_sizes(mesh))
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                got = tmesh.local_chunk(x, pl, mesh, (pod, data, model))
                row = (pod * 2 + data) * 2
                assert torch.equal(got, x[row:row + 2,
                                          model * 3:(model + 1) * 3])
    assert tmesh.shard_bytes((8, 6), torch.float32, pl,
                             tmesh.mesh_sizes(mesh)) == 2 * 3 * 4
    with pytest.raises(ValueError, match="split"):
        tmesh.local_chunk(torch.zeros(6, 6), pl, mesh, (0, 0, 0))


@pytest.fixture
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod, fake_world):
    fake_world(512 if multi_pod else 256)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want = (2, 16, 16) if multi_pod else (16, 16)
    assert tuple(mesh.shape) == want
    assert tuple(mesh.mesh_dim_names) == (
        ("pod", "data", "model") if multi_pod else ("data", "model"))
    assert tmesh.mesh_sizes(mesh) == dict(zip(mesh.mesh_dim_names, want))


def test_production_mesh_needs_its_world(fake_world):
    fake_world(64)
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")


def test_constrain(fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.randn(4, 6)
    assert constrain(x, BATCH_AXES, MODEL_AXIS) is x      # no mesh
    fake_world(4)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with tmesh.set_mesh(mesh):
        assert tmesh.current_mesh() is mesh
        assert constrain(x, BATCH_AXES, MODEL_AXIS) is x  # a rank's tensor
        dt = DTensor.from_local(x[:2, :3], mesh, (Shard(0), Shard(1)),
                                run_check=False, shape=(4, 6),
                                stride=(6, 1))
        assert constrain(dt, BATCH_AXES, MODEL_AXIS) is dt
        moved = constrain(dt, None, MODEL_AXIS)
        assert isinstance(moved, DTensor)
        assert tuple(moved.placements) == (Replicate(), Shard(1))
    assert tmesh.current_mesh() is None
