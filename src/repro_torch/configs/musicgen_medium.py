"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens
(the codec frontend is a stub: the backbone takes token ids, or frame
embeddings the caller gives)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_head=64, d_ff=6144, vocab_size=2048,
    frontend="encodec_stub", act="gelu",
)
SMOKE = CONFIG.reduced()
