"""The port's simlint (``repro_torch.analysis``) on the CPU: one seeded
violation per rule trips exactly that rule, host code of ``run`` is not
step code, suppressions, the port's own tree is clean (source rules and
the step checks of all 27 targets), the target names and the report
formats equal the reference's, the op-trace differ names a seeded
divergent op, and the CLI's rule list and exit code.
"""
import io
import json
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (Finding, RULES, Target, active,  # noqa: E402
                                  check_all, check_paths, check_source,
                                  check_target, default_targets,
                                  diff_traces, render_report, to_json)
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.core.vectorized import sim as _sim  # noqa: E402


# ------------------------------------------------------------ PY2xx seeds

def _step_file(step_line, run_line="pass", extra=""):
    """A factory whose ``body`` (passed to ``_drive``) holds
    ``step_line``; ``run_line`` is host code of ``run``."""
    return f'''
import numpy as np
import torch
{extra}

def make_sim():
    def run(st):
        {run_line}

        def body(st, live):
            {step_line}
            return st
        return _drive(st, body, cond, 1)
    return run
'''


PY_SEEDS = {
    "PY201": 'n = int(st["valid"].sum())',
    "PY202": "x = np.arange(4)",
    "PY203": "if live:\n                st = dict(st)",
    "PY205": 'x = st["x"].sum()',
}


@pytest.mark.parametrize("rule", sorted(PY_SEEDS))
def test_seeded_step_code_violation_trips_its_rule(rule):
    found = check_source(_step_file(PY_SEEDS[rule]))
    assert {f.rule for f in found} == {rule}, found


@pytest.mark.parametrize("read", [".item()", ".tolist()", ".cpu()",
                                  ".numpy()"])
def test_method_host_reads_trip_py201(read):
    found = check_source(_step_file(f'x = st["valid"]{read}'))
    assert {f.rule for f in found} == {"PY201"}, found


def test_seeded_where_division_trips_py204_file_wide():
    src = "import torch\n\ndef f(n, d):\n" \
          "    return torch.where(d > 0, n / d, 0.0)\n"
    assert {f.rule for f in check_source(src)} == {"PY204"}
    guarded = "import torch\n\ndef f(n, d):\n" \
              "    return torch.where(d > 0, n / d.clamp(min=1), 0.0)\n"
    assert check_source(guarded) == []


def test_host_code_of_run_is_not_step_code():
    src = _step_file("x = st", run_line='n = int(st["x"].sum()); '
                                        'm = np.arange(3); y = st["x"].cpu()')
    assert check_source(src) == []


def test_step_code_reaches_called_helpers_and_factory_closures():
    src = '''
import torch

def helper(st):
    return int(st["valid"].sum())

def _live(cap):
    def cond(st):
        return st["x"].sum() < cap
    return cond

def make_sim():
    def run(st):
        def body(st, live):
            helper(st)
            return st
        return _drive(st, body if True else body, _live(3), 1)
    return run
'''
    assert sorted(f.rule for f in check_source(src)) == ["PY201", "PY205"]


def test_suppressions_trailing_and_preceding():
    trailing = _step_file('x = st["x"].sum()  # simlint: disable=PY205')
    preceding = _step_file('# simlint: disable=PY205\n'
                           '            x = st["x"].sum()')
    for src in (trailing, preceding):
        found = check_source(src)
        assert [f.rule for f in found] == ["PY205"]
        assert found[0].suppressed and active(found) == []


# ------------------------------------------------------------ JX1xx seeds

def _loop_target(body, *, args=None, argnames=("x",), required=(),
                 setup=None, **kw):
    """A target whose call drives a two-row carry through ``body``."""
    def fn(x, y=None):
        st = dict(a=x.clone(), n=torch.zeros(2, dtype=torch.int64))
        if setup is not None:
            st = setup(st, y)
        return _sim._drive(st, body, lambda s: s["n"] < 3, 1)
    x = torch.arange(8, dtype=torch.float32).view(2, 4)
    return Target(name="seeded", fn=fn, args=args or (x,),
                  argnames=argnames, required_live=frozenset(required), **kw)


def _count(st, live=None):
    return dict(st, n=st["n"] + 1)


JX_SEEDS = {
    # a carry entry changes shape: where(out=) broadcasts it silently
    "JX101": lambda: _loop_target(
        lambda st, live: dict(_count(st), a=st["a"][:, :1] * 2)),
    # a Python number baked into the step
    "JX102": lambda: _loop_target(lambda st, live: dict(_count(st), a=0.5)),
    "JX103": lambda: _loop_target(
        lambda st, live: dict(_count(st), a=(st["a"].double() * 2).float())),
    # y is read on the host at set-up: its value never reaches the step
    "JX104": lambda: _loop_target(
        _count, args=(torch.ones(2, 4), torch.ones(2)), argnames=("x", "y"),
        required=("x", "y"), setup=lambda st, y: dict(
            st, a=st["a"] * float(y.sum()))),
    "JX105": lambda: _loop_target(_count, slot_pool=16, n_edges=96),
    "JX106": lambda: _loop_target(_count, frontier_caps=(3, 5),
                                  n_edges=96),
}


@pytest.mark.parametrize("rule", sorted(JX_SEEDS))
def test_seeded_step_violation_trips_its_rule(rule):
    found = active(check_target(JX_SEEDS[rule]()))
    assert {f.rule for f in found} == {rule}, found


def test_host_read_inside_the_step_is_counted():
    def body(st, live):
        if bool(st["a"].sum() > 0):
            st = dict(st)
        return _count(st)
    stats = {}
    found = active(check_target(_loop_target(body), stats))
    assert {f.rule for f in found} == {"JX101"}
    assert "host read" in found[0].message
    assert stats["seeded"]["host_reads"] == 1


def test_greedy_prologue_reads_are_exempt_and_the_step_has_none():
    # greedy's whole step is held to JX101: no eager prologue is left
    # to exempt (the test keeps the name it had while one was), and its
    # placement is one op (the kernel's wrapper)
    stats = {}
    targets = [t for t in default_targets(device="cpu")
               if t.name == "make_bucket_dynamic_simulator[greedy,maxmin]"]
    from repro_torch.analysis.step_checks import observe
    obs = observe(targets[0])
    assert active(check_all(targets, stats=stats)) == []
    s = stats["make_bucket_dynamic_simulator[greedy,maxmin]"]
    assert s["host_reads"] == 0 and "prologue" not in s["ops"]
    ops = [r.op for r in obs.tracer.records["step"]]
    assert ops.count("repro_torch::greedy_place") == 1


# ------------------------------------------------------------ the tree

def test_port_tree_is_clean():
    found = check_paths()
    assert active(found) == [], render_report(found)
    # every suppression names its reason on the line or the one above
    assert {f.rule for f in found} <= {"PY201", "PY205"}


def test_all_27_targets_are_clean_on_the_cpu():
    stats = {}
    found = check_all(device="cpu", stats=stats)
    assert active(found) == [], render_report(found)
    assert len(stats) == 27
    assert all(s["host_reads"] == 0 for s in stats.values())
    # the only suppressed findings: float64 inside _ops.fma32
    assert all(f.rule == "JX103" and "fma32" in f.message for f in found)


def test_target_names_equal_the_reference():
    from repro.analysis import default_targets as ref_targets
    names = [t.name for t in default_targets(device="cpu")]
    assert names == [t.name for t in ref_targets()]
    assert len(names) == 27


# ------------------------------------------------------------ reports

def _both(findings):
    from repro.analysis import report as ref
    mine = [Finding(*f) for f in findings]
    theirs = [ref.Finding(*f) for f in findings]
    return mine, theirs, ref


def test_report_formats_equal_the_reference():
    findings = [("PY205", "src/x.py:3", "sum() over a padded tensor", False),
                ("JX104", "step:t", "argument y is dead", False),
                ("PY201", "src/y.py:9", "int() reads the host", True)]
    mine, theirs, ref = _both(findings)
    for verbose in (False, True):
        assert render_report(mine, verbose=verbose) == \
            ref.render_report(theirs, verbose=verbose)
    assert to_json(mine, device="cpu") == ref.to_json(theirs, device="cpu")
    doc = json.loads(to_json(mine))
    assert doc["summary"] == {"findings": 2, "suppressed": 1,
                              "rules": ["JX104", "PY205"]}
    assert set(RULES) == set(ref.RULES)


# ------------------------------------------------------------ the differ

def test_differ_names_a_seeded_divergent_op():
    def fn(x, mul):
        def body(st, live):
            a = st["a"] * 2 if bool(mul.item()) else st["a"] + 2
            return dict(_count(st), a=a)
        st = dict(a=x.clone(), n=torch.zeros(2, dtype=torch.int64))
        return _sim._drive(st, body, lambda s: s["n"] < 3, 1)
    x = torch.ones(2, 4)
    rep = diff_traces(fn, (x, torch.tensor(True)), (x, torch.tensor(False)))
    assert "different" in rep and "op differs" in rep
    assert "aten::mul" in rep and "aten::add" in rep
    same = diff_traces(fn, (x, torch.tensor(True)), (x * 3,
                                                       torch.tensor(True)))
    assert "identical event steps" in same
    wide = diff_traces(fn, (x, torch.tensor(True)),
                       (torch.ones(2, 5), torch.tensor(True)))
    assert "carry entries ['a'] differ" in wide


def test_survey_check_compiles_names_its_cause():
    from repro_torch.survey import check_compiles
    stats = dict(captures=0, sim_calls=2, groups=2, engine="vmap",
                 device="cpu", diagnose=lambda: "identical event steps")
    with pytest.raises(AssertionError, match="identical event steps"):
        check_compiles(stats)


# ------------------------------------------------------------ the CLI

def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_lists_the_reference_rules():
    from repro.analysis.__main__ import main as ref_main
    rc, text = _run_cli(["--list-rules"])
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        ref_main(["--list-rules"])
    ids = [line.split()[0] for line in text.splitlines()]
    assert rc == 0
    assert ids == [line.split()[0] for line in
                   ref_out.getvalue().splitlines()]


@pytest.mark.parametrize("rule", sorted(PY_SEEDS))
def test_cli_exits_1_on_a_seeded_violation(tmp_path, rule):
    bad = tmp_path / "seeded.py"
    bad.write_text(_step_file(PY_SEEDS[rule]))
    report = tmp_path / "report.json"
    rc, text = _run_cli(["--no-jaxpr", "--paths", str(bad), "--json",
                         str(report)])
    assert rc == 1
    assert json.loads(report.read_text())["summary"]["rules"] == [rule]
    rc, _ = _run_cli(["--no-jaxpr", "--no-ast"])
    assert rc == 0
