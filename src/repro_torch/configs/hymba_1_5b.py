"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer
[arXiv:2411.13676].  32L d1600 25H (GQA kv=5) ff5504 vocab 32001,
ssm_state 16.  Global (full) attention only on the first, middle and last
layers; SWA elsewhere (window 1024).  Meta-tokens are not modelled."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="hymba-1.5b", n_layers=32, d_model=1600, d_ff=5504,
    vocab_size=32001, n_heads=25, n_kv_heads=5, d_head=64,
    window=1024, swa_all_but=(0, 15, 31),
    ssm="hybrid", ssm_state=16, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="hymba-smoke", n_layers=3, d_model=64, d_ff=128, vocab_size=128,
    n_heads=5, n_kv_heads=1, d_head=16, window=16, swa_all_but=(0,),
    ssm="hybrid", ssm_state=8, ssm_head_dim=16, dtype="float32",
    remat="none",
)
