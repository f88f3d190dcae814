"""mamba2-130m [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    layer_pattern="m", mlp_kind="none", tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
