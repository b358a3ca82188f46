"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th
block [hf:meta-llama/Llama-3.2-11B-Vision].  40L d4096 32H (kv=8) ff14336
vocab 128256.  The vision tower is a STUB: input_specs() provides 1600
precomputed patch embeddings of width d_model."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b", n_layers=40, d_model=4096, d_ff=14336,
    vocab_size=128_256, n_heads=32, n_kv_heads=8, d_head=128,
    cross_attn_every=5, cross_tokens=1600, frontend="vision",
)

SMOKE = ModelConfig(
    name="llama32v-smoke", n_layers=4, d_model=64, d_ff=128, vocab_size=128,
    n_heads=4, n_kv_heads=2, d_head=16, cross_attn_every=2,
    cross_tokens=16, frontend="vision", dtype="float32", remat="none",
)
