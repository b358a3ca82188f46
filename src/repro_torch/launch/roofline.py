"""Roofline terms of a training or serving step on one kind of card, and
the analytic model FLOPs of an LM step.

The hardware model is a ``Hardware`` record; the default, ``H100_SXM``,
is the NVIDIA H100 SXM5 (80 GB) of the NVIDIA H100 Tensor Core GPU
datasheet: 989e12 dense bf16 FLOP/s on the tensor cores, 67e12 float32
FLOP/s on the CUDA cores, 3.35e12 bytes/s of HBM3, and NVLink 4 at
900 GB/s per GPU in both directions together, 450e9 bytes/s each way.
A pipeline stage that spans two DGX H100 nodes crosses a 400 Gb/s NDR
InfiniBand link instead, 50e9 bytes/s: callers pass
``dataclasses.replace(H100_SXM, link_bw=50e9)``.  The module names
``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` are the H100's.

  compute term    = flops_per_chip / peak_flops
  memory term     = hbm_bytes_per_chip / hbm_bw
  collective term = collective_bytes_per_chip / link_bw

The reference's readers of a compiled XLA module (``shape_bytes``,
``parse_collectives``, ``cost_dict``, ``memory_stats`` and
``roofline_terms``, which take FLOPs, bytes and collective bytes from HLO
text and ``cost_analysis``) have no counterpart here yet: the dry run's
port takes the per-card totals from ``FlopCounterMode`` and
``CommDebugMode`` and hands them to ``terms_from_totals``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one card: FLOP/s in bf16 and float32, HBM and
    inter-card link bytes/s (one direction)."""
    name: str
    peak_flops_bf16: float
    peak_flops_f32: float
    hbm_bw: float
    link_bw: float


H100_SXM = Hardware(name="H100-SXM5-80GB", peak_flops_bf16=989e12,
                    peak_flops_f32=67e12, hbm_bw=3.35e12, link_bw=450e9)

PEAK_FLOPS = H100_SXM.peak_flops_bf16     # bf16 FLOP/s per card
HBM_BW = H100_SXM.hbm_bw                  # bytes/s per card
LINK_BW = H100_SXM.link_bw                # bytes/s per direction, NVLink 4


def terms_from_totals(flops: float, hbm_bytes: float, coll_bytes: float,
                      n_chips: int, model_flops: float = 0.0,
                      hw: Hardware = H100_SXM) -> dict:
    """Roofline record from per-card totals (however obtained), at
    ``hw``'s bf16 peak, HBM and link rates."""
    terms = {"compute_s": flops / hw.peak_flops_bf16,
             "memory_s": hbm_bytes / hw.hbm_bw,
             "collective_s": coll_bytes / hw.link_bw}
    dominant = max(terms, key=terms.get)
    return {
        "n_chips": n_chips,
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm_bytes,
        "collective_bytes_per_chip": coll_bytes,
        **terms,
        "dominant": dominant,
        "model_flops_global": model_flops,
        "hlo_flops_global": flops * n_chips,
        "useful_flops_ratio": (model_flops / (flops * n_chips)
                               if flops else 0.0),
    }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D forward (active params)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
