"""LM stack of the port: the serving path (prefill and decode) of all ten
architecture families (dense, MoE, hybrid attention + Mamba-2, vision
cross-attention, the audio frontend; int8 and ring KV caches) and the
training path (loss, train step with gradient accumulation and remat)
of every family, with attention (K2) and the SSD scan (K3) as
hand-written CUDA kernels on the card; the placements of a model, its
optimizer state, batch and cache on a device mesh (``params``) and the
residual-stream policy (``ShardingPolicy``)."""
from .config import ModelConfig
from .convert import opt_state_from_jax, opt_state_to_jax, \
    params_from_jax, params_to_jax
from .params import batch_pspecs, cache_pspecs, param_pspecs, \
    to_placements
from .steps import make_decode_step, make_loss_fn, make_prefill_step, \
    make_train_step, softmax_cross_entropy
from .transformer import NO_POLICY, ShardingPolicy, Transformer, \
    decode_step, forward, init_params, make_cache, prefill

__all__ = ["ModelConfig", "Transformer", "init_params", "forward",
           "prefill", "decode_step", "make_cache", "make_loss_fn",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "softmax_cross_entropy", "params_from_jax", "params_to_jax",
           "opt_state_from_jax", "opt_state_to_jax", "ShardingPolicy",
           "NO_POLICY", "param_pspecs", "batch_pspecs", "cache_pspecs",
           "to_placements"]
