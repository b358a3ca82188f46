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

The reference reads a compiled XLA module (the per-device SPMD
partition: ``cost_analysis``, HLO text, ``memory_analysis``).  Here the
dry run (``launch/dryrun.py``) runs the step itself, on one rank's local
shards, under ``StepCost``, a dispatch mode that sees the local ops a
DTensor program issues (it defers every DTensor op to DTensor and
counts what that op runs on the local tensors):

* ``flops``: per-card FLOPs from ``torch.utils.flop_counter``'s
  formulas on the local shapes.  Work that every rank repeats (a
  replicated layer) counts on every card, as XLA's per-device count
  does; ``FlopCounterMode`` around DTensors would count global work.
* ``bytes``: per-card bytes accessed, the sum over every local op that
  is not a view, an allocation or a collective of its operand and result
  bytes.  Nothing is fused, so this is an upper bound on XLA's count.
* ``collectives()``: count and operand bytes of each collective the
  step issues, by kind, with ``parse_collectives``' keys.
* ``memory_stats``: the counterpart of ``memory_analysis``: argument,
  output and alias bytes from the local shard shapes.  XLA's temp size
  has no meta-device counterpart and is reported as absent (the card
  pass of ``chip_smoke.py``'s ``mesh`` phase gives a card's peak).

``roofline_terms`` hands these totals to ``terms_from_totals``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


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


COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# the c10d ops (DTensor's redistributions) by kind, matched on their
# names without underscores
_COLLECTIVE_KINDS = (("allgather", "all-gather"),
                     ("allreduce", "all-reduce"),
                     ("reducescatter", "reduce-scatter"),
                     ("alltoall", "all-to-all"),
                     ("broadcast", "collective-permute"))
# no data moved: views, allocations and the collectives' bookkeeping
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
             "detach", "alias", "lift_fresh")


def tensor_bytes(t) -> int:
    """Bytes of the local part of a tensor (a DTensor's local shard)."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def tree_bytes(tree) -> int:
    """Local bytes of every tensor in a nested dict / list / tuple /
    ``AdamState`` / ``nn.Module`` (its parameters)."""
    if isinstance(tree, torch.nn.Module):
        return sum(tensor_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tensor_bytes(tree)
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class StepCost(TorchDispatchMode):
    """Per-card FLOPs, bytes accessed and collectives of the local ops
    run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVE_OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor op: the local ops it runs come back through here
            return NotImplemented
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            # the fake tensors of DTensor's sharding propagation
            return out
        name = func._overloadpacket.__name__
        bare = name.replace("_", "")
        kind = next((k for key, k in _COLLECTIVE_KINDS if key in bare),
                    None)
        if func.namespace in ("_c10d_functional", "c10d") \
                and kind is not None:
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(tensor_bytes(t)
                                         for t in _tensors(args))
            return out
        if func.is_view or name in _NO_BYTES \
                or func.namespace != "aten":
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += sum(tensor_bytes(t) for t in _tensors(args)) \
            + sum(tensor_bytes(t) for t in _tensors(kwargs)) \
            + sum(tensor_bytes(t) for t in _tensors(out))
        return out

    def collectives(self) -> dict:
        """``parse_collectives``' record: operand bytes and counts by
        kind and their totals."""
        return {"bytes_by_op": dict(self.coll_bytes),
                "counts_by_op": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values()),
                "total_count": sum(self.coll_counts.values())}


def memory_stats(args, outputs, aliased) -> dict:
    """Per-card argument, output and alias bytes (``aliased``: the
    outputs written in place of arguments: parameters and optimizer
    state in training, the cache at decode) from the local shards."""
    return {"argument_size_in_bytes": tree_bytes(args),
            "output_size_in_bytes": tree_bytes(outputs),
            "alias_size_in_bytes": tree_bytes(aliased),
            "temp_size_in_bytes": None}


def roofline_terms(cost: StepCost, n_chips: int,
                   model_flops: float = 0.0,
                   hw: Hardware = H100_SXM) -> dict:
    """``terms_from_totals`` of a ``StepCost``'s per-card totals, with
    its collectives."""
    coll = cost.collectives()
    out = terms_from_totals(flops=float(cost.flops),
                            hbm_bytes=float(cost.bytes),
                            coll_bytes=float(coll["total_bytes"]),
                            n_chips=n_chips, model_flops=model_flops, hw=hw)
    out["collectives"] = coll
    return out


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
