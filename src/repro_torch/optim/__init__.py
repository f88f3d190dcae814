"""Optimizer of the port (counterpart of ``repro.optim``)."""
from .adamw import AdamW, cosine_schedule  # noqa: F401
from .compression import (ErrorFeedbackState, compress_int8,  # noqa: F401
                          compressed_psum, decompress_int8)
