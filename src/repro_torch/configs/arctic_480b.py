"""arctic-480b [moe]: 128 experts top-2 + dense residual branch
[hf:Snowflake/snowflake-arctic-base; hf]."""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
)
