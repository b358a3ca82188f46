"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].  48L d5120 40H (GQA kv=8) expert
ff 8192 vocab 202048.  Full attention (chunked-attention variant not in
the assigned config) => long_500k skipped."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, d_ff=8192,
    vocab_size=202_048, n_heads=40, n_kv_heads=8, d_head=128,
    moe_experts=16, moe_top_k=1,
)

SMOKE = ModelConfig(
    name="llama4-smoke", n_layers=2, d_model=64, d_ff=96, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, moe_experts=4, moe_top_k=1,
    dtype="float32", remat="none",
)
