"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  48L d2048 32H (kv=32 == MHA) ff8192, 4 parallel
codebooks of vocab 2048 (delay pattern).  The EnCodec frontend is a STUB:
token ids arrive pre-computed, [B, S, 4]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large", n_layers=48, d_model=2048, d_ff=8192,
    vocab_size=2048, n_heads=32, n_kv_heads=32, d_head=64,
    frontend="audio", codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=64,
    n_heads=4, n_kv_heads=4, d_head=16, frontend="audio", codebooks=4,
    dtype="float32", remat="none",
)
