"""mamba2-130m [ssm] — pure Mamba-2 SSD blocks (state-space duality),
attention-free [arXiv:2405.21060].  24L d768, d_inner 1536, 24 heads of
64, state 128, vocab 50280, no MLP (d_ff=0)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m", n_layers=24, d_model=768, d_ff=0,
    vocab_size=50_280, n_heads=0, n_kv_heads=0,
    ssm="mamba2", ssm_state=128, ssm_head_dim=64, rope_style="none",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", n_layers=2, d_model=64, d_ff=0, vocab_size=128,
    n_heads=0, n_kv_heads=0, ssm="mamba2", ssm_state=16, ssm_head_dim=16,
    rope_style="none", dtype="float32", remat="none",
)
