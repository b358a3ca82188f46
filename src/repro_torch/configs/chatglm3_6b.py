"""chatglm3-6b [dense] — 2D RoPE (rotary on half the head dims), GQA kv=2
[arXiv:2406.12793].  28L d4096 32H ff13696 vocab 65024."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, d_ff=13696,
    vocab_size=65_024, n_heads=32, n_kv_heads=2, d_head=128,
    rope_style="half", rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="chatglm3-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, rope_style="half",
    rope_theta=10_000.0, dtype="float32", remat="none",
)
