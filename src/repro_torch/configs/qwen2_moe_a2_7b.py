"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed top-4 + 4 shared."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=0, vocab_size=151936,
    n_experts=60, top_k=4, moe_d_ff=1408,
    n_shared_experts=4, shared_expert_d_ff=5632,
)
SMOKE = CONFIG.reduced(top_k=2)
