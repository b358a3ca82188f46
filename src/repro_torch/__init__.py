"""PyTorch/CUDA port of the vectorized ESTEE simulator (``repro``).

The survey's dynamic simulator runs as batched PyTorch tensor code with
an explicit row axis; its max-min rate solver is a hand-written CUDA
kernel (``kernels/csrc/waterfill.cu``) on the card and a plain PyTorch
version on the CPU.  The package imports ``torch`` and numpy only —
nothing of JAX or of ``repro``.

    from repro_torch.core.vectorized import build, make_grid_runner
    python -m repro_torch.survey --mini            # on a CUDA card
"""
from .device import resolve_device

__all__ = ["resolve_device"]
