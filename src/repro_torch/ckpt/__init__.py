"""Checkpointing of the port (counterpart of ``repro.ckpt``)."""
from .checkpoint import CheckpointManager  # noqa: F401
