"""Gemma2-9B [arXiv:2408.00118]: local+global alternating, logit softcap."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, d_head=256, d_ff=14336, vocab_size=256000,
    layer_pattern="local_global", sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, act="gelu", tie_embeddings=True,
)
SMOKE = CONFIG.reduced(n_kv_heads=2)
