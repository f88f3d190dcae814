"""hubert-xlarge [audio]: encoder-only backbone; the conv feature extractor
is a STUB (input_specs provides precomputed 512-d frame features)
[arXiv:2106.07447; unverified]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    causal=False, mlp_kind="gelu",
    frontend="audio", frontend_dim=512,
)
