"""llava-next-mistral-7b [vlm]: mistral-7b backbone; anyres vision tower is a
STUB (input_specs provides precomputed patch embeddings, prepended)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    rope_theta=1000000.0, mlp_kind="swiglu",
    frontend="vlm", frontend_dim=1024, num_patches=1152,
)
