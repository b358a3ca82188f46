"""repro_torch.analysis — "simlint" for the port (the counterpart of
``repro.analysis``).

Three layers, one CLI (``python -m repro_torch.analysis``):

* ``step_checks`` (JX1xx) — run every simulator / scheduler factory of
  the survey grid for one event step under a ``TorchDispatchMode`` and
  check the captured-step invariants: a stable carry, nothing baked into
  the CUDA graph, no float64, live arguments, the flow-slot pool and the
  ready frontiers, no host read inside the step.
* ``recompile_diff`` — an op-trace differ that explains a CUDA graph
  capture-count mismatch (the first divergent op, or "identical steps:
  look at the Python side").
* ``ast_rules`` (PY2xx) — source lint over ``core/vectorized/``,
  ``kernels/`` and ``workloads/`` for Python-level hazards in step code
  (host reads, numpy baked into the capture, value-dependent control
  flow, double-NaN ``where``, unmasked padded reductions).

Suppress single findings with ``# simlint: disable=RULE`` comments
(source rules); suppressed findings still appear in the JSON report.
"""
from .report import Finding, RULES, active, render_report, to_json
from .ast_rules import check_paths, check_source, default_paths
from .step_checks import Target, check_all, check_target, default_targets
from .recompile_diff import (Divergence, diff_op_traces, diff_traces,
                             trace_step)

__all__ = [
    "Finding", "RULES", "active", "render_report", "to_json",
    "check_paths", "check_source", "default_paths",
    "Target", "check_all", "check_target", "default_targets",
    "Divergence", "diff_op_traces", "diff_traces", "trace_step",
]
