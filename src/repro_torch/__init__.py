"""PyTorch/CUDA port of the distributed sparse-matmul engine in ``repro``.

The port keeps the JAX package's layout and names (``repro/core/bsr.py`` ↔
``repro_torch/core/bsr.py``) and is held against it by the tests.  It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no device argument a machine without a card raises
(see :func:`repro_torch.runtime.device.resolve_device`).
"""
