"""stablelm-12b [dense] — standard GQA decoder
[hf:stabilityai/stablelm-2-12b].  40L d5120 32H (kv=8) ff13824
vocab 100352."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", n_layers=40, d_model=5120, d_ff=13824,
    vocab_size=100_352, n_heads=32, n_kv_heads=8, d_head=160,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, dtype="float32", remat="none",
)
