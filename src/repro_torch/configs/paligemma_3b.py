"""PaliGemma-3B [arXiv:2407.07726]: SigLIP frontend (a stub: the caller
gives precomputed patch embeddings) + gemma decoder, prefix-LM attention
over the frontend tokens."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_head=256, d_ff=16384, vocab_size=257216,
    prefix_lm=True, frontend="siglip_stub", n_frontend_tokens=256,
    act="gelu", tie_embeddings=True,
)
SMOKE = CONFIG.reduced(n_kv_heads=1)
