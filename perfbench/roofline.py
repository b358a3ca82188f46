"""The yardstick of a kernel's roofline share: the H100's published
peaks and the bytes a K1 launch and a greedy placement (GP) launch
need.

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



def place_bytes(R: int, T: int, W: int, placing: int = 0, edges: int = 0,
                objects: int = 0) -> int:
    """Bytes one GP launch (greedy's placement, ``R`` rows of ``T``
    tasks over ``W`` workers) needs, as ``chip_smoke._place_bytes``
    counts them: the placing flags (one byte a task), the cores (int64)
    of the ``placing`` tasks that place, their ``edges`` input-edge
    entries and objects (int64 each), the size (f32) and W missing flags
    of each of the ``objects`` those edges reach, the workers' cores and
    loads (int64), read once; the proposed worker of every task (int64)
    written once.  The flags, cores, loads and proposals are fixed by
    the shape; a count left at 0 makes the bytes a lower bound."""
    return (R * T + 8 * placing + 16 * edges + objects * (4 + W)
            + 16 * R * W + 8 * R * T)
