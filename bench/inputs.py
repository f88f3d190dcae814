"""The benchmark's inputs, made from ``--seed``: a configuration's graph
(fixed by the configuration), its values and the dense operands (drawn
on the card from the seed), and the program's handle of the matrix.

The graph is the deployment's dataset and stays the same from seed to
seed, so every seed gives the program the same structure and amount of
work; the values and B change with the seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import rmat

# a pool of dense operands holds at least four times the H100's 50 MB L2,
# so that each is read from HBM, as a user's fresh operand is
POOL_BYTES = 4 * 50_000_000


@dataclasses.dataclass
class Matrix:
    """An n x n sparse matrix as the benchmark made it: its nonzeros at
    (rows, cols), sorted by row, with ``vals`` (on the device)."""
    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    host_rows: np.ndarray
    host_cols: np.ndarray

    @property
    def nnz(self) -> int:
        return len(self.host_rows)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def matrix(cfg: dict, gen: torch.Generator, dtype: torch.dtype,
           device) -> Matrix:
    """The configuration's graph with standard normal values from
    ``gen``, rounded to ``dtype``."""
    edges = rmat.graph(cfg)
    rows = torch.as_tensor(edges[:, 0], device=device)
    cols = torch.as_tensor(edges[:, 1], device=device)
    vals = torch.randn(len(edges), generator=gen, device=device,
                       dtype=torch.float32).to(dtype)
    return Matrix(1 << cfg["scale"], rows, cols, vals, edges[:, 0],
                  edges[:, 1])


def dense_pool(gen: torch.Generator, count: int, rows: int, width: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """``count`` standard normal ``rows x width`` operands in one tensor."""
    return torch.randn((count, rows, width), generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def handle(mat: Matrix, cfg: dict, device, log):
    """The program's ``DistBSR`` of ``mat``, tiled from a dense matrix
    made on the device (the program tiles dense input only); the dense
    matrix is freed before this returns."""
    from repro_torch.core.api import DistBSR
    t0 = time.perf_counter()
    dense = torch.zeros((mat.n, mat.n), dtype=mat.vals.dtype, device=device)
    dense[mat.rows, mat.cols] = mat.vals
    a_h = DistBSR.from_dense(dense, g=cfg["g"], block_size=cfg["block_size"],
                             device=device)
    del dense
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t = a_h.tiled
    real = int(t.counts.sum())
    filled = 100 * mat.nnz / max(1, real * cfg["block_size"] ** 2)
    log(f"A: R-MAT scale {cfg['scale']}, edge factor {cfg['edgefactor']}, "
        f"{mat.nnz} nonzeros ({str(mat.vals.dtype)[6:]}), bs "
        f"{cfg['block_size']}, g {cfg['g']}: {real} real blocks, capacity "
        f"{t.capacity}, {t.store_capacity} stored slots a tile, "
        f"{t.blocks.numel() * t.blocks.element_size() / 1e9:.3f} GB stored, "
        f"{filled:.4f} % of the real blocks' elements nonzero; tiled in "
        f"{time.perf_counter() - t0:.2f} s")
    return a_h
