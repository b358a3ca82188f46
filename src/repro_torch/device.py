"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``.  There is no silent CPU fallback: asking for CUDA on a
machine without a card raises, and the CPU runs only when the caller
names it (the parity tests do)."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` (``"cuda"`` resolves to the
    current card's index); raises ``RuntimeError`` when a CUDA device is
    requested and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device='cpu' to run the plain "
            f"PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so tensors made on it compare equal to ``dev``
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
