"""Device selection and float32 precision for the port.

Counterpart of ``repro/runtime/platform.py``: where the JAX package plants
XLA flags before the backend starts, the port picks a ``torch.device`` and
keeps float32 products in full float32 (no TF32) so results match the
reference.  Timing lives in ``repro_torch.obs`` (``sync_elapsed``,
``timed``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "rank_device", "strict_fp32", "as_tensor"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says so.

    ``None`` means the card.  A machine without one raises instead of
    running quietly on the CPU; tests and CPU users pass ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available on this machine")
    return dev


def rank_device(local_rank: int, device: DeviceLike = None) -> torch.device:
    """The device of the rank ``local_rank`` of a process grid on this host.

    ``None`` (or ``"cuda"``) gives ``cuda:(local_rank % device_count)``, so
    ranks share the cards round-robin; it raises where there is no card.
    ``"cpu"`` gives the CPU, for ranks that run on the host.
    """
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"a rank runs on the card or the CPU, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: ranks run on the card by "
            "default; pass device='cpu' to run them on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def strict_fp32() -> None:
    """Keep float32 products in IEEE float32 (TF32 off), as the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or a numpy array.

    numpy has no native bfloat16; arrays of the ``bfloat16`` extension
    dtype (what ``np.asarray`` gives for a JAX bf16 array) are
    reinterpreted bit for bit.  A read-only array (such as a view of a JAX
    buffer) is copied, so the tensor never aliases memory it may not write.
    """
    if not isinstance(x, torch.Tensor):
        arr = np.ascontiguousarray(x)
        if not arr.flags.writeable:
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            x = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(arr)
    return x.to(device=device, dtype=dtype)
