"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/``; ``_build`` compiles them with
``nvcc`` at first use.

* ``waterfill`` — K1, batched max-min fair rates (replaces the TPU
  kernel ``repro/kernels/waterfill.py::_waterfill_kernel``); call
  ``repro_torch.kernels.waterfill.waterfill``."""
from .waterfill import LAUNCHES as WATERFILL_LAUNCHES

__all__ = ["WATERFILL_LAUNCHES"]
