"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` (with the shared ``csrc/*.cuh`` headers it
includes) is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and bound with ``ctypes``.  The library goes into
``build/`` beside this file (listed in ``.gitignore``), named after a hash
of its source, the headers and the flags, at first use; nothing is built
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["build", "load", "nvcc_path", "refuse_autograd", "NVCC_FLAGS"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each source: name -> (argtypes, restype)
_SIGNATURES = {
    "bsr_spmm": {
        # a, b, ent, n_ent, chunks, n_chunks, reduce, n_reduce, fill,
        # n_fill, partial, out, count, bs, nbr, K, n, accumulate, dtype,
        # stream
        "bsr_spmm_launch": ([_P, _P, _P, _L, _P, _L, _P, _L, _P, _L, _P, _P,
                             _P] + [_I] * 6 + [_P], _I),
        # bs, dtype -> 1 tensor cores, 0 SIMT
        "bsr_spmm_path": ([_I, _I], _I),
        # b, skip_chunks, n_chunks, skip, n_skip, flags, any, out, bs, nbr,
        # K, n, dtype, stream
        "bsr_spmm_nan_launch": ([_P, _P, _L, _P, _L, _P, _P, _P] + [_I] * 5
                                + [_P], _I),
        # a, b, rowptr, brow, aoff, units, n_units, fill, n_fill, out,
        # count_blocks, count_elems, bs, nbr, K, n, accumulate, dtype, stream
        "bsr_spmm_elem_launch": ([_P] * 6 + [_L, _P, _L, _P, _P, _P]
                                 + [_I] * 6 + [_P], _I),
        # b, flag_chunks, n_flag, skip, n_skip, segs, n_segs, seg_chunks,
        # rowptr, brow, counts, any, out, bs, nbr, K, n, dtype, stream
        "bsr_spmm_elem_nan_launch": ([_P, _P, _L, _P, _L, _P, _L] + [_P] * 6
                                     + [_I] * 5 + [_P], _I),
        # a, b, a_rowptr, a_brow, a_off, ea, a_rows, b_rowptr, b_col, b_off,
        # eb, b_rows, windows, units, n_units, zero_rows, n_zero, maps,
        # colptr, col_ent, n_col, vals, flags, out, count_blocks, credit, T,
        # span, bs, R, K, n, window, accumulate, dtype, stream
        "bsr_spmm_sparse_b_launch": ([_P] * 5 + [_L, _L] + [_P] * 3
                                     + [_L, _L, _P, _P, _L, _P, _L, _P, _P,
                                        _P, _L] + [_P] * 4 + [_L]
                                     + [_I] * 9 + [_P], _I),
    },
    "bsr_pair": {
        # a, b, pa, pb, pidx, chunks, n_chunks, reduce, n_reduce, fill,
        # n_fill, partial, out, count, T, Sa, Sb, P, bs, n_slots, nbc,
        # accumulate, dtype, stream
        "bsr_pair_launch": ([_P] * 6 + [_L, _P, _L, _P, _L, _P, _P, _P]
                            + [_I] * 9 + [_P], _I),
        # bs, dtype -> 1 tensor cores, 0 SIMT
        "bsr_pair_path": ([_I, _I], _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def refuse_autograd(who: str, *tensors) -> None:
    """Raise where a kernel's result would need a gradient.  The kernels
    have no backward (nor do the reference's), and a launch on
    ``data_ptr()`` cuts its output off from autograd, so while grad mode is
    on no input (``None`` entries skipped) may require grad.  The wrappers
    call this on the card and on the CPU path alike."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{who} has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on "
                       "first use and need the CUDA toolkit")


def _library_path(name: str) -> Tuple[Path, Path]:
    """The source and its library, named after a hash of the source, the
    shared headers under ``csrc/`` and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, all
    started together.  Returns the compiler output by name (register and
    spill counts from ``-Xptxas=-v``); raises if any build fails."""
    names = tuple(names or _SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src, lib = _library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_library_path(name)[1]))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
    return lib
