"""Kernels of the port: hand-written CUDA for Hopper, their plain PyTorch
versions (``ref``) and the ``impl`` dispatch (``ops``).

Nothing here builds or loads a kernel at import time: the CUDA library is
compiled on first use (see :mod:`repro_torch.kernels.loader`).
"""
