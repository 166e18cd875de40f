"""StarCoder2-7B [arXiv:2402.19173]: dense, GQA kv=4, RoPE, GELU."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_head=128, d_ff=18432, vocab_size=49152,
    act="gelu", rope_theta=1e5,
)
SMOKE = CONFIG.reduced(n_kv_heads=2)
