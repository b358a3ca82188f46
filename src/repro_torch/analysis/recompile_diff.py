"""simlint layer (b) for the port: an op-trace differ that explains a
capture-count mismatch — the counterpart of
``repro.analysis.recompile_diff``.

The port's one-program-per-call contract is one CUDA graph capture per
simulator call (``survey.check_compiles``).  When the count is off,
``diff_traces`` runs the simulator at two argument tuples that should
share one step program, records the ATen ops of one event step of each
(``step_checks.observe``: op, input and output shapes and dtypes,
non-tensor arguments) and names the first op where the two diverge
(``Divergence``).  Identical traces mean the mismatch comes from the
Python side: a call that ran its step eagerly (``step_graph``, a CPU
device), stopped before its loop, or was made more often than the grid
needs.
"""
from __future__ import annotations

import dataclasses

from .step_checks import Target, observe


@dataclasses.dataclass(frozen=True)
class Divergence:
    """First difference between two step op traces."""
    path: str        # "step" or "carry"
    index: int       # op index in that trace (-1: the carry signature)
    reason: str      # what differs (op, shapes/dtypes, arguments, count)
    left: str
    right: str

    def render(self) -> str:
        return (f"first divergence at {self.path} op {self.index}: "
                f"{self.reason}\n  left:  {self.left}\n"
                f"  right: {self.right}")


def trace_step(fn, *args):
    """``(carry, ops)`` of one event step of ``fn(*args)``: the carry's
    ``{key: (shape, dtype)}`` and ``{"step": [...]}`` op records (the
    step run once on copies of the carry, the call then stopped)."""
    obs = observe(Target(name="trace", fn=fn, args=args,
                         argnames=tuple(f"arg{i}" for i in range(len(args))),
                         required_live=frozenset()))
    if not obs.carry:
        raise RuntimeError("the call never reached its event loop")
    if obs.error is not None:
        raise RuntimeError(f"the event step failed: {obs.error}")
    carry = {k: (shape, dtype) for k, (shape, dtype, _) in obs.carry.items()}
    return carry, obs.tracer.records


def diff_op_traces(a, b, path="step"):
    """First ``Divergence`` between two op-record lists, or None when
    they are identical (the counterpart of ``diff_jaxprs``)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x.op != y.op:
            return Divergence(path, i, "op differs", x.render(), y.render())
        if (x.ins, x.outs) != (y.ins, y.outs):
            return Divergence(path, i, f"shapes/dtypes differ on {x.op}",
                              x.render(), y.render())
        if x.args != y.args:
            return Divergence(path, i, f"arguments differ on {x.op}",
                              x.render(), y.render())
    if len(a) != len(b):
        i = min(len(a), len(b))
        extra = a[i] if len(a) > i else b[i]
        return Divergence(path, i, f"op count differs ({len(a)} vs "
                                   f"{len(b)})", f"{len(a)} ops",
                          f"{len(b)} ops (next: {extra.render()})")
    return None


def diff_traces(fn, args_a, args_b, labels=("A", "B")):
    """Run ``fn`` at two argument tuples and explain why their event
    steps would (or would not) be one captured program.  Returns a report
    string; never raises — failures become part of the report."""
    la, lb = labels
    try:
        ca, ta = trace_step(fn, *args_a)
    except Exception as e:
        return f"recompile-diff: tracing {la} failed: {e}"
    try:
        cb, tb = trace_step(fn, *args_b)
    except Exception as e:
        return f"recompile-diff: tracing {lb} failed: {e}"
    if ca != cb:
        keys = sorted(k for k in set(ca) | set(cb) if ca.get(k) != cb.get(k))
        d = Divergence("carry", -1, f"carry entries {keys} differ",
                       str({k: ca.get(k) for k in keys}),
                       str({k: cb.get(k) for k in keys}))
    else:
        d = diff_op_traces(ta["step"], tb["step"])
    if d is not None:
        return (f"recompile-diff: {la} and {lb} run *different* event "
                f"steps — each needs its own capture.\n{d.render()}")
    return (f"recompile-diff: {la} and {lb} run identical event steps "
            f"({len(ta['step'])} ops) — the capture count comes from the "
            f"Python side: a call that ran its step eagerly "
            f"(step_graph='eager' or a CPU device), one that stopped before "
            f"its loop, or more simulator calls than the grid's groups "
            f"(chunks).")
