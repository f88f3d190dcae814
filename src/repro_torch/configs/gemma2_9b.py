"""gemma2-9b [dense]: local+global alternating attention, logit softcaps,
sandwich norms, GeGLU, tied embeddings [arXiv:2408.00118; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    layer_pattern="lg", local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    mlp_kind="geglu", emb_scale=True, tie_embeddings=True,
)
