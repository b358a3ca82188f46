"""The yardstick of a kernel's roofline share: the H100's published
peaks and the bytes a K1 launch needs.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit; a card set lower runs slower, so every run prints the card's
name and limit beside its numbers (``run.py``)."""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
DOWNLOAD_SLOTS = 4          # the flow-slot pool is DOWNLOAD_SLOTS * W flows


def k1_bytes(R: int, F: int, W: int) -> int:
    """Bytes one K1 launch (max-min rates of ``R`` rows of ``F`` flows
    over ``W`` workers) needs: each input read once (int32 source and
    destination, a bool activity flag per flow, f32 upload and download
    capacity per worker) and the f32 rate of each flow written once."""
    return R * (F * 4 * 2 + F * 1 + W * 4 * 2 + F * 4)

