"""qwen2.5-3b [dense]: GQA kv=2, QKV bias, tied [hf:Qwen/Qwen2.5-0.5B; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0, mlp_kind="swiglu",
    tie_embeddings=True,
)
