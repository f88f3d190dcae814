"""The benchmark's inputs: its copy of the R-MAT generator gives the
port's edges, and a seed gives the same inputs every time."""
import numpy as np
import pytest
import torch

from bench import inputs, manifest, rmat


@pytest.mark.parametrize("scale, ef, seed", [(7, 8, 1), (9, 1, 2), (6, 4, 0),
                                             (8, 2, 2 ** 31 + 5)])
def test_copied_generator_gives_the_ports_edges(scale, ef, seed):
    from repro_torch.core.bsr import rmat_edges
    assert np.array_equal(rmat.rmat_edges(scale, ef, seed=seed),
                          rmat_edges(scale, ef, seed=seed))


def test_configurations_graph_is_the_ports():
    """Each configuration's graph is the port's edges; a relabelled one's
    are renamed by a permutation of the vertices drawn from the graph seed
    plus one."""
    from repro_torch.core.bsr import rmat_edges
    man = manifest.load()
    for w in man["workloads"]:
        cfg = dict(manifest.config(man, w), scale=7)
        edges = rmat_edges(7, cfg["edgefactor"], seed=cfg["graph_seed"])
        if cfg.get("relabel"):
            edges = np.random.default_rng(cfg["graph_seed"] + 1).permutation(
                1 << 7)[edges]
        assert np.array_equal(rmat.graph(cfg), np.unique(edges, axis=0))


def _fig1_rmat_csr():
    """``rmat_csr`` of the repo's ``benchmarks/fig1_load_imbalance.py``,
    its source run alone with the port's R-MAT generator (importing the
    module would load the JAX package)."""
    import ast

    import scipy.sparse as sps
    from repro_torch.core.bsr import rmat_edges
    path = manifest.ROOT / "benchmarks" / "fig1_load_imbalance.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "rmat_csr")
    space = {"np": np, "sps": sps, "rmat_edges": rmat_edges}
    exec(compile(ast.Module([fn], []), str(path), "exec"), space)
    return space["rmat_csr"]


@pytest.mark.parametrize("scale, seed", [(7, 1), (9, 4)])
def test_relabelled_graph_follows_fig1(scale, seed):
    """Under ``"relabel"`` the graph is fig1's relabelled R-MAT adjacency,
    edge for edge; without it, fig1's unpermuted one."""
    rmat_csr = _fig1_rmat_csr()
    cfg = {"scale": scale, "edgefactor": 8, "a": 0.6, "b": 0.4 / 3,
           "c": 0.4 / 3, "d": 0.4 / 3, "graph_seed": seed}
    for relabel in (True, False):
        got = rmat.graph(dict(cfg, relabel=relabel))
        want = rmat_csr(scale, 8, seed, permute=relabel).tocoo()
        assert np.array_equal(got, np.stack([want.row, want.col], axis=1))


def test_seed_gives_the_same_inputs():
    cfg = dict(manifest.config(manifest.load(), {"config": "rmat16-spmm"}),
               scale=7)

    def make(seed):
        gen = inputs.generator(seed, "cpu")
        mat = inputs.matrix(cfg, gen, torch.float32, "cpu")
        return mat, inputs.dense_pool(gen, 2, mat.n, 4, torch.float32, "cpu")
    (m1, b1), (m2, b2), (m3, b3) = make(2 ** 33 + 1), make(2 ** 33 + 1), \
        make(5)
    assert torch.equal(m1.vals, m2.vals) and torch.equal(b1, b2)
    # another seed: the same graph, other values
    assert torch.equal(m1.rows, m3.rows) and torch.equal(m1.cols, m3.cols)
    assert not torch.equal(m1.vals, m3.vals) and not torch.equal(b1, b3)
