"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/``; ``_build`` compiles them with
``nvcc`` at first use.

* ``waterfill`` — K1, batched max-min fair rates (replaces the TPU
  kernel ``repro/kernels/waterfill.py::_waterfill_kernel``) in two
  routes, one warp per row (``F <= 128``, ``W <= 32``) or one block per
  row; call ``repro_torch.kernels.waterfill.waterfill``.
* ``flash_attention`` — K2, GQA attention with causal and sliding-window
  masks (replaces ``repro/kernels/flash_attention.py::_flash_kernel``).
* ``ssd`` — K3, the Mamba-2 SSD chunked scan as three chunk-parallel
  kernels, ``ssd_chunk_state``, ``ssd_state_pass`` and
  ``ssd_chunk_scan`` (replaces ``repro/kernels/ssd.py::_ssd_kernel``).
* ``greedy_place`` — greedy's placement in the dynamic simulator's
  event step, transfer costs and the sequential choice in one kernel
  (replaces no Pallas kernel: the reference's ``fori_loop`` under
  ``jit``); call ``repro_torch.kernels.greedy_place.greedy_place``.
* ``list_schedule`` — the static list schedule of ``blevel``, ``tlevel``
  and ``mcp`` (level, order and placement) and greedy's priorities, one
  kernel a simulator call (replaces no Pallas kernel: the reference's
  ``fori_loop``s under ``jit``); call
  ``repro_torch.kernels.list_schedule.list_schedule`` or
  ``blevel_priorities``.

``ops.attention`` and ``ops.ssd`` dispatch K2 and K3 by device; ``ref``
holds their plain versions."""
from .flash_attention import LAUNCHES as FLASH_ATTENTION_LAUNCHES
from .greedy_place import LAUNCHES as GREEDY_PLACE_LAUNCHES
from .list_schedule import LAUNCHES as LIST_SCHEDULE_LAUNCHES
from .ssd import LAUNCHES as SSD_LAUNCHES
from .waterfill import LAUNCHES as WATERFILL_LAUNCHES

__all__ = ["FLASH_ATTENTION_LAUNCHES", "GREEDY_PLACE_LAUNCHES",
           "LIST_SCHEDULE_LAUNCHES", "SSD_LAUNCHES", "WATERFILL_LAUNCHES"]
