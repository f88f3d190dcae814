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
    from repro_torch.core.bsr import rmat_edges
    man = manifest.load()
    for w in man["workloads"]:
        cfg = dict(manifest.config(man, w), scale=7)
        want = np.unique(rmat_edges(7, cfg["edgefactor"],
                                    seed=cfg["graph_seed"]), axis=0)
        assert np.array_equal(rmat.graph(cfg), want)


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
