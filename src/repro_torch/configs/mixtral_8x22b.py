"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  56L d6144 48H (GQA kv=8) ff16384 vocab 32768,
window 4096 => sub-quadratic, long_500k runs."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b", n_layers=56, d_model=6144, d_ff=16384,
    vocab_size=32_768, n_heads=48, n_kv_heads=8, d_head=128,
    window=4096, moe_experts=8, moe_top_k=2,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, d_ff=96, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, window=16,
    moe_experts=4, moe_top_k=2, dtype="float32", remat="none",
)
