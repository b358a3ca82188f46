"""gemma3-1b [dense] — 5:1 local:global attention, 128k-class context
[hf:google/gemma-3-1b-pt].  26L d1152 4H (GQA kv=1, head_dim 256)
ff6912 vocab 262144, local window 1024, tied embeddings."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, d_ff=6912,
    vocab_size=262_144, n_heads=4, n_kv_heads=1, d_head=256,
    window=1024, global_every=6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", n_layers=3, d_model=64, d_ff=128, vocab_size=256,
    n_heads=2, n_kv_heads=1, d_head=32, window=16, global_every=3,
    tie_embeddings=True, dtype="float32", remat="none",
)
