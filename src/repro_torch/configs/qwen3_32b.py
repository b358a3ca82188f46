"""qwen3-32b [dense] — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-32B].
64L d5120 64H ff25600 vocab 151936."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b", n_layers=64, d_model=5120, d_ff=25600,
    vocab_size=151_936, n_heads=64, n_kv_heads=8, d_head=128,
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, qk_norm=True, dtype="float32",
    remat="none",
)
