"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + ONE shared attention
block invoked every 6 layers (weight co-location showcase)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_period=6,
    ssm_chunk=128,
)
SMOKE = CONFIG.reduced()
