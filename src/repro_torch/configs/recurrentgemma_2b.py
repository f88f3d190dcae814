"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    layer_pattern="rrl", local_window=2048, lru_width=2560,
    mlp_kind="geglu", emb_scale=True, tie_embeddings=True,
)
