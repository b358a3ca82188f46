"""simlint PY2xx: AST lint for Python-level hazards in the port's step
code — the counterpart of ``repro.analysis.ast_rules`` in PyTorch's
idiom.

In the reference everything nested in a ``make_*`` factory runs under
``jit``.  Here ``run`` inside a factory is host code (it builds the
carry, reads ``live.any()`` and the results); only the event step runs
on the card, replayed from a CUDA graph.  "Step code" is therefore

* every function passed by name (or as a lambda) to ``_drive`` or
  ``_step_into`` — the ``body`` and ``cond`` of the event loop; an argument may be a conditional expression (both branches
  count) or a call of a function of the file (the functions nested in
  it, i.e. the closure it returns, count);
* transitively, every function of the same file that step code calls by
  name, looked up from the calling function's scope outwards (the
  factory's nested helpers, then the module's own).

Rules (ids in ``report.RULES``):

* PY201 — a host read in step code: ``float(x)``/``int(x)``/``bool(x)``
  on a non-literal, or ``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``.  It synchronises, and a captured step bakes the value
  read at capture into every replay.
* PY202 — an ``np.*`` call in step code (dtypes, ``iinfo`` and
  ``finfo`` excepted): it runs once, on the host, and the CUDA graph
  replays its value.
* PY203 — a Python ``if``/``while`` whose test mentions a parameter of
  the step function (``is [not] None`` tests are static and exempt).
* PY204 — ``torch.where(cond, a / b, ...)`` where the denominator ``b``
  also appears in ``cond`` and has no ``maximum``/``clamp``/``clip``/
  ``where`` guard of its own (file-wide).
* PY205 — a reduction (``sum``/``amax``/``amin``/``max``/``min``/
  ``mean``/``any``/``all``/``prod``, ``torch.`` or method form) in step
  code whose operands show no validity mask: a mask-ish name, an inline
  ``torch.where``, or a ``where=``/``initial=`` keyword.  Scatter forms
  (``scatter_reduce``, ``index_reduce``) are not reductions.

Suppress with ``# simlint: disable=RULE[,RULE...]`` on the finding's
line or on a comment-only line directly above it.
"""
from __future__ import annotations

import ast
import os
import re

from .report import Finding

_LOOP_CALLS = {"_drive", "_step_into"}
_NP_ROOTS = {"np", "numpy"}
_TORCH_ROOTS = {"torch"}
_NP_ALLOWED = {"float32", "float64", "int32", "int64", "uint32", "uint8",
               "bool_", "dtype", "iinfo", "finfo", "ndim", "shape"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
_REDUCTIONS = {"sum", "amax", "amin", "max", "min", "mean", "any", "all",
               "prod"}
_GUARDS = {"maximum", "clamp", "clamp_min", "clip", "where"}
# names that signal a validity mask is involved in a reduction operand
_MASKISH = re.compile(
    r"valid|mask|active|running|waiting|eligible|elig|cand|done|started"
    r"|pick|frozen|live|occ|enabled|needed|cross|due|ready|blocked"
    r"|missing|produced|newly|sat\b|take|free|queued|handled|prod",
    re.IGNORECASE)
_DIRECTIVE = re.compile(r"#\s*simlint:\s*disable=([A-Z0-9,\s]+)")
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def parse_suppressions(source: str) -> dict:
    """``{line_number: {rule, ...}}`` — a trailing directive covers its
    own line; a comment-only directive line covers the next line."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        target = i + 1 if line.lstrip().startswith("#") else i
        out.setdefault(target, set()).update(rules)
        out.setdefault(i, set()).update(rules)
    return out


def _attr_chain(node):
    """('torch', 'where') for ``torch.where``; () when not a plain chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _params(fn):
    a = fn.args
    params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
    if a.vararg:
        params.add(a.vararg.arg)
    if a.kwarg:
        params.add(a.kwarg.arg)
    return params


def _own_defs(scope):
    """``{name: FunctionDef}`` defined in ``scope``'s own body (through
    ``if``/``for``/``with``/``try`` blocks, not inside nested functions)."""
    out = {}
    stack = list(scope.body)
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCS):
            out.setdefault(node.name, node)
            continue
        if isinstance(node, (ast.ClassDef, ast.Lambda)):
            continue
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                stack.append(child)
    return out


def _step_functions(tree):
    """Step-code function/lambda nodes (see the module docstring), each
    paired with its own parameter-name set."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    defs = {id(tree): _own_defs(tree)}

    def scopes_of(node):
        """The enclosing function scopes of ``node``, innermost first,
        then the module."""
        out = []
        p = parents.get(node)
        while p is not None:
            if isinstance(p, _FUNCS):
                out.append(p)
            p = parents.get(p)
        return out + [tree]

    def resolve(name, at):
        for scope in scopes_of(at):
            if id(scope) not in defs:
                defs[id(scope)] = _own_defs(scope)
            if name in defs[id(scope)]:
                return defs[id(scope)][name]
        return None

    step = {}
    todo = []

    def add(fn):
        if id(fn) not in step:
            step[id(fn)] = (fn, _params(fn))
            todo.append(fn)

    def add_arg(arg, at):
        if isinstance(arg, ast.Lambda):
            add(arg)
        elif isinstance(arg, ast.Name):
            fn = resolve(arg.id, at)
            if fn is not None:
                add(fn)
        elif isinstance(arg, ast.IfExp):
            add_arg(arg.body, at)
            add_arg(arg.orelse, at)
        elif isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name):
            # a factory call: the closures nested in it are the step code
            fn = resolve(arg.func.id, at)
            if fn is not None:
                for inner in ast.walk(fn):
                    if inner is not fn and isinstance(inner, _FUNCS
                                                      + (ast.Lambda,)):
                        add(inner)

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _LOOP_CALLS):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                add_arg(arg, node)
    # transitively: the file's functions that step code calls by name
    while todo:
        fn = todo.pop()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = resolve(node.func.id, node)
                if callee is not None:
                    add(callee)
    return list(step.values())


def _is_literalish(node):
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_literalish(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_literalish(node.left) and _is_literalish(node.right)
    return False


def _has_guard(node):
    """True when a division denominator is already protected by a
    ``maximum``/``clamp``/``clip``/``where`` inside itself."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in _GUARDS):
            return True
    return False


def _is_where(chain):
    return len(chain) >= 2 and chain[0] in _TORCH_ROOTS \
        and chain[-1] == "where"


def _mask_indicator(nodes):
    """Does any node subtree show evidence of masking?"""
    for root in nodes:
        for n in ast.walk(root):
            if isinstance(n, ast.Name) and _MASKISH.search(n.id):
                return True
            if isinstance(n, ast.Attribute) and _MASKISH.search(n.attr):
                return True
            if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and _MASKISH.search(n.value)):
                return True
            if isinstance(n, ast.Call) and _is_where(_attr_chain(n.func)):
                return True
    return False


def check_source(source: str, path: str = "<string>"):
    """All PY2xx findings for one file's source text."""
    tree = ast.parse(source, filename=path)
    suppressed = parse_suppressions(source)
    findings = []
    seen = set()

    def emit(rule, node, message):
        key = (rule, node.lineno, message)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            rule=rule, location=f"{path}:{node.lineno}", message=message,
            suppressed=rule in suppressed.get(node.lineno, ())))

    # ---- file-wide: PY204 (double-NaN where) -------------------------
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_where(_attr_chain(
                node.func)) and len(node.args) == 3):
            continue
        cond, yes, no = node.args
        cond_names = _names_in(cond)
        for branch in (yes, no):
            for n in ast.walk(branch):
                if (isinstance(n, ast.BinOp)
                        and isinstance(n.op, (ast.Div, ast.FloorDiv,
                                              ast.Mod))):
                    den = n.right
                    if _has_guard(den):
                        continue
                    hit = _names_in(den) & cond_names
                    if hit:
                        emit("PY204", node,
                             f"where-guarded division: denominator "
                             f"{'/'.join(sorted(hit))} is tested only in "
                             f"the where condition; unselected lanes "
                             f"still evaluate it (use the double-where "
                             f"pattern)")

    # ---- step-code rules ---------------------------------------------
    for fn, params in _step_functions(tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                # PY201: host reads
                if (isinstance(node.func, ast.Name)
                        and node.func.id in ("float", "int", "bool")
                        and len(node.args) == 1
                        and not _is_literalish(node.args[0])):
                    emit("PY201", node,
                         f"{node.func.id}() reads the host in step code")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _HOST_READS
                        and not (chain and chain[0] in _NP_ROOTS)):
                    emit("PY201", node,
                         f".{node.func.attr}() reads the host in step code")
                # PY202: numpy in step code
                if (len(chain) >= 2 and chain[0] in _NP_ROOTS
                        and chain[-1] not in _NP_ALLOWED):
                    emit("PY202", node,
                         f"numpy call {'.'.join(chain)}() runs on the host "
                         f"once and is baked into the captured step; use "
                         f"torch")
                # PY205: unmasked reduction
                red = None
                operands = []
                if (len(chain) >= 2 and chain[0] in _TORCH_ROOTS
                        and chain[-1] in _REDUCTIONS):
                    red = chain[-1]
                    operands = list(node.args)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in _REDUCTIONS
                      and not (len(chain) >= 2
                               and chain[0] in _NP_ROOTS | _TORCH_ROOTS)):
                    red = node.func.attr    # method form: x.sum()
                    operands = [node.func.value] + list(node.args)
                if red is not None:
                    kw = {k.arg for k in node.keywords}
                    if ("initial" not in kw and "where" not in kw
                            and not _mask_indicator(
                                operands + [k.value
                                            for k in node.keywords])):
                        emit("PY205", node,
                             f"{red}() over a possibly padded tensor with "
                             f"no validity-mask operand")
            elif isinstance(node, (ast.If, ast.While)):
                # PY203: value-dependent Python control flow
                test = node.test
                if (isinstance(test, ast.Compare)
                        and all(isinstance(op, (ast.Is, ast.IsNot))
                                for op in test.ops)):
                    continue              # `x is None` etc. — static
                hit = _names_in(test) & params
                if hit:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    emit("PY203", node,
                         f"python {kind} on step parameter "
                         f"{'/'.join(sorted(hit))} reads the host and does "
                         f"not capture; use torch.where")
    return findings


def default_paths():
    """The step-code surfaces simlint watches by default."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(pkg, "core", "vectorized"),
            os.path.join(pkg, "kernels"),
            os.path.join(pkg, "workloads")]


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def check_paths(paths=None):
    """Run every AST rule over the given files/directories (defaults to
    ``core/vectorized``, ``kernels``, ``workloads``)."""
    findings = []
    cwd = os.getcwd()
    for path in iter_py_files(paths or default_paths()):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(path, cwd)
        shown = rel if not rel.startswith("..") else path
        findings.extend(check_source(source, path=shown))
    return findings
