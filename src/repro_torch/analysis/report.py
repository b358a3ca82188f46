"""Finding model, rule registry and report rendering of the port's
simlint — the counterpart of ``repro.analysis.report``, with the same
rule ids, so a finding here maps one to one onto the reference's.

A ``Finding`` is one rule violation at one location: ``path:line``
(source rules) or ``step:<target>`` (the step checks, which have no
single source line).  Suppressions are trailing or preceding-line
``# simlint: disable=RULE[,RULE...]`` comments; a suppressed finding
stays in the report but does not fail the run.
"""
from __future__ import annotations

import dataclasses
import json


#: rule id -> one-line description (the CLI's ``--list-rules`` output).
#: JX1xx rules run on one observed event step of each simulator call
#: (``step_checks``); PY2xx rules run on the Python source
#: (``ast_rules``).
RULES = {
    "JX101": "event step is shape- or dtype-unstable (a carry entry's "
             "step output differs from the carry), or it cannot be "
             "captured in a CUDA graph (a host read inside the step)",
    "JX102": "a value baked into the captured step: a carry entry whose "
             "step output is a Python number, or a step operand on "
             "another device than the carry",
    "JX103": "a float64/complex128 tensor in the event step or its "
             "set-up (the simulator contract is float32 end to end)",
    "JX104": "declared argument is dead: it reaches no op of the event "
             "step (its value was read on the host or dropped at build "
             "time -- the traced-cores contract)",
    "JX105": "flow-slot pool bound violated (no int32/float32 "
             "[R, DOWNLOAD_SLOTS*W] slot pool in the carry, or a "
             "per-edge float32 [R, E] carry survives in slot mode)",
    "JX106": "frontier bound violated (no [R, CT] task frontier, or in "
             "slot mode [R, CF] flow frontier, sized by frontier_caps_for "
             "in the carry, or a per-edge [R, E] carry in a frontier "
             "slot-mode target)",
    "PY201": "host read in step code (float()/int()/bool() on a "
             "non-literal, .item(), .tolist(), .cpu(), .numpy()): it "
             "synchronises, and a CUDA graph bakes the value in",
    "PY202": "numpy call in step code (its value is computed once, on "
             "the host, and baked into the CUDA graph at capture)",
    "PY203": "Python conditional on a tensor parameter of a step "
             "function (value-dependent control flow reads the host and "
             "does not capture)",
    "PY204": "torch.where-masked division whose denominator is guarded "
             "only by the where condition (produces NaN/inf lanes; use "
             "the double-where pattern)",
    "PY205": "reduction over a padded [T]/[E]-shaped tensor with no "
             "validity-mask operand in the expression",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # key of RULES
    location: str      # "src/...py:123" or "step:<target name>"
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.location}: {self.rule}{tag}: {self.message}"


def active(findings) -> list:
    """The findings that fail a run (non-suppressed)."""
    return [f for f in findings if not f.suppressed]


def render_report(findings, *, verbose: bool = False) -> str:
    """Human-readable report: one line per finding (suppressed ones only
    under ``verbose``), plus a summary line."""
    findings = list(findings)
    shown = findings if verbose else active(findings)
    lines = [f.render() for f in shown]
    n_sup = len(findings) - len(active(findings))
    lines.append(f"simlint: {len(active(findings))} finding(s), "
                 f"{n_sup} suppressed")
    return "\n".join(lines)


def to_json(findings, **meta) -> str:
    """Machine-readable report: findings plus a summary block; extra
    keyword arguments land in ``meta``."""
    findings = list(findings)
    doc = {
        "tool": "simlint",
        "meta": dict(meta),
        "summary": {
            "findings": len(active(findings)),
            "suppressed": len(findings) - len(active(findings)),
            "rules": sorted({f.rule for f in active(findings)}),
        },
        "findings": [dataclasses.asdict(f) for f in findings],
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"
