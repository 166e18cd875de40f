"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD, state=128."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
)
SMOKE = CONFIG.reduced(n_heads=0, n_kv_heads=0, d_head=0, d_ff=0)
