"""Data pipelines of the port (counterpart of ``repro.data``)."""
from .pipeline import MemmapTokens, Prefetcher, SyntheticLM, make_batch_specs  # noqa: F401
