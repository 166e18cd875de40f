"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: 128e top-2 MoE
with a dense residual branch. ~480B total parameters."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_head=128, d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_d_ff=4864,
)
SMOKE = CONFIG.reduced(top_k=2)
