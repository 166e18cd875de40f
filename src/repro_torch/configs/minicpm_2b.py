"""MiniCPM-2B [arXiv:2404.06395; hf]: llama-like dense, MHA, WSD schedule."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_head=64, d_ff=5760, vocab_size=122753,
    lr_schedule="wsd",
)
SMOKE = CONFIG.reduced()
