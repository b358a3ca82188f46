"""Model configuration of the LM stack (a copy of the reference
package's ``ModelConfig``, every field and helper kept;
``activation_dtype`` is a ``torch.dtype``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # --- attention
    n_heads: int = 0                 # query heads (0 => attention-free)
    n_kv_heads: int = 0
    d_head: int = 0                  # defaults to d_model // n_heads
    window: int = 0                  # sliding-window size for local layers
    global_every: int = 0            # 0: all global; k: layers (i+1)%k==0
    #     are global, the rest local-windowed (gemma3 5:1 => 6)
    swa_all_but: tuple = ()          # hymba: global attn only at these layer
    #     indices (empty + window>0 + global_every==0 => SWA everywhere)
    rope_style: str = "full"         # "full" | "half" (chatglm 2d) | "none"
    rope_theta: float = 500_000.0
    qk_norm: bool = False
    # --- MoE
    moe_experts: int = 0             # 0 => dense MLP
    moe_top_k: int = 1
    moe_dispatch: str = "dense"      # "dense" | "gather"
    moe_capacity: float = 1.25
    moe_groups: int = 1
    moe_fold_gates: bool = False
    # --- SSM (mamba2 / hybrid)
    ssm: str = "none"                # "none" | "mamba2" | "hybrid"
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4                # depthwise conv kernel width
    ssm_expand: int = 2
    # --- cross attention (VLM)
    cross_attn_every: int = 0        # 0 => none; k => 1 cross per k layers
    cross_tokens: int = 0
    # --- frontends
    frontend: str = "none"           # "none" | "vision" | "audio"
    codebooks: int = 1               # audio: parallel codebooks
    # --- misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"              # "none" | "full" | "dots"
    use_pallas: bool = False         # reference only: its TPU fast path
    window_ring_cache: bool = False  # ring KV cache for SWA
    kv_cache_dtype: str = "none"     # "none" (= activation dtype) | "int8"
    max_cache_len: int = 0           # decode cache length (set per shape)
    unroll_layers: bool = False      # reference only: dry-run unrolling

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.ssm != "none" and not self.ssm_heads:
            object.__setattr__(
                self, "ssm_heads",
                self.ssm_expand * self.d_model // self.ssm_head_dim)

    # ------------------------------------------------------------ helpers
    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (0 = full attention)."""
        if self.window <= 0:
            return 0
        if self.global_every:                   # gemma3-style local:global
            return 0 if (i + 1) % self.global_every == 0 else self.window
        if self.swa_all_but:                    # hymba-style
            return 0 if i in self.swa_all_but else self.window
        return self.window                      # mixtral-style SWA everywhere

    def window_pattern(self):
        return tuple(self.layer_window(i) for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.ssm != "none" or self.window > 0

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d                                     # embed
        if not self.tie_embeddings:
            n += d * v * (self.codebooks if self.frontend == "audio" else 1)
        per_layer = 0
        if not self.attn_free:
            hq, hk, dh = self.n_heads, self.n_kv_heads, self.d_head
            per_layer += d * hq * dh + 2 * d * hk * dh + hq * dh * d
            if self.qk_norm:
                per_layer += 2 * dh
        if self.ssm in ("mamba2", "hybrid"):
            di, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * ns + hs)    # in_proj
            per_layer += di * d                        # out_proj
            per_layer += (di + 2 * ns) * self.ssm_conv + 2 * hs + di
        if f > 0:
            mlp = 3 * d * f                            # swiglu
            if self.moe_experts:
                per_layer += self.moe_experts * mlp + d * self.moe_experts
            else:
                per_layer += mlp
        per_layer += 2 * d                             # norms
        n += per_layer * self.n_layers
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            hq, hk, dh = self.n_heads, self.n_kv_heads, self.d_head
            n_per = d * hq * dh + 2 * d * hk * dh + hq * dh * d + 2 * d
            n += n_cross * n_per
        n += d                                         # final norm
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of E experts)."""
        if not self.moe_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f
        inactive = (self.moe_experts - self.moe_top_k) * mlp * self.n_layers
        return self.param_count() - inactive
