"""simlint JX1xx for the port: checks on one observed event step of each
simulator — the counterpart of ``repro.analysis.jaxpr_checks``.

PyTorch has no jaxpr.  What a simulator call runs on the card is its
carry (a dict of ``[R, ...]`` tensors, ``sim._drive``) and one event
step, written into the carry in place (``sim._step_into``) and replayed
from a CUDA graph.  So each target runs one real simulator call on seeded
random graphs padded to the reference's bucket shapes (padding is inert)
under a ``TorchDispatchMode`` that sees every ATen op, and ``sim``'s
private drive hook hands the check the carry and the step before the
first step runs.  The check runs that step once on copies of the
carry, then stops the call.  The hand-written kernels (K1, greedy's
placement, the list schedule) are launched through ctypes, where the
mode cannot see them, so each wrapper is recorded as one op from its
inputs to its output (on the CPU its plain version stands in for it, as
one op too).
The float64 inside ``_ops.fma32`` (the single rounding of the
reference's contracted multiply-adds) is reported as suppressed JX103.

* JX101 — a carry entry whose step output differs from the carry in
  shape or dtype (or is missing), a step that fails, or a host read
  inside the step (``aten._local_scalar_dense``, a copy to the CPU):
  the CUDA graph cannot capture it.  Greedy's step is held to it like
  every other: its invocation is captured with the rest.
* JX102 — a value baked into the captured step: a carry entry whose
  step output is a Python number, or an operand of a step op that is a
  tensor on another device than the carry.
* JX103 — a float64/complex128 output of any op of the call (set-up and
  step).
* JX104 — a required-live argument whose value reaches no op of the step
  (or, for a scheduler, the schedule): taint flows from each argument
  through every op and every in-place or ``out=`` write, and stops at
  host reads.  The required-live sets are the reference's.
* JX105 — flow-slot pool: a max-min slot-mode carry holds int32 and
  float32 ``[R, S]`` entries (``S = DOWNLOAD_SLOTS * W``) and no float32
  ``[R, E]`` entry.
* JX106 — ready frontiers: a frontier target's carry holds the ``[R,
  CT]`` task list (and in slot mode the ``[R, CF]`` flow list) with
  ``frontier_caps_for``'s caps, and in frontier slot mode no ``[R, E]``
  entry at all.  The lists hold int64 ids here (PyTorch's gather and
  scatter take int64 indices; the reference's are int32).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .report import Finding
from ..core.graphs import random_graph
from ..core.vectorized import sim as _sim
from ..core.vectorized.api import make_grid_runner
from ..core.vectorized.scheduling import (VEC_SCHEDULERS,
                                          make_bucket_scheduler,
                                          rows_schedule)
from ..core.vectorized.sim import (DOWNLOAD_SLOTS, make_bucket_simulator,
                                   make_bucket_dynamic_simulator)
from ..core.vectorized.specs import (_BSPEC_FIELDS, BucketedGraphSpec,
                                     encode_graph, frontier_caps_for,
                                     pad_spec)
from ..device import resolve_device

_BAD_DTYPES = (torch.float64, torch.complex128)
_HOST_READS = {"aten::_local_scalar_dense", "aten::is_nonzero",
               "aten::item", "aten::equal"}


@dataclasses.dataclass(frozen=True)
class Target:
    """One check target: a built simulator (or scheduler) and its
    arguments, with its liveness, slot-pool and frontier contract."""
    name: str
    fn: object                  # the callable the factory returned
    args: tuple                 # its arguments (tensors, specs, None)
    argnames: tuple             # one name per entry of ``args``
    required_live: frozenset    # leaf names whose value must reach the step
    slot_pool: int | None = None       # expected S for slot-mode targets
    n_edges: int | None = None         # bucket E (banned [R, E] carries)
    frontier_caps: tuple | None = None  # expected (CF, CT), frontier mode
    scheduler: bool = False     # a schedule function: no loop, no step


class _Stop(Exception):
    """Raised by the drive hook once the step has been observed."""


def _spec_str(shape, dtype):
    return f"{str(dtype).replace('torch.', '')}[{','.join(map(str, shape))}]"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a step: its name, the ``dtype[shape]`` of each tensor
    operand and output, and its other arguments (repr-truncated)."""
    op: str
    ins: tuple
    outs: tuple
    args: str

    def render(self) -> str:
        return (f"{self.op} :: {' '.join(self.ins)} -> {' '.join(self.outs)}"
                f"{' ' + self.args if self.args else ''}")


def _key(t):
    """Taint key of a tensor: its storage (views and in-place writes
    share it); ``None`` for tensors without memory of their own."""
    if t.numel() == 0 or t.device.type == "meta":
        return None
    return (t.device, t.untyped_storage().data_ptr())


class _Tracer(TorchDispatchMode):
    """Every ATen op of a simulator call: taint from the arguments,
    dtypes, host reads and off-device operands of the step."""

    def __init__(self):
        super().__init__()
        self.taint = {}
        self.phase = "setup"        # "setup" | "step"
        self.opaque = 0
        self.in_fma = 0
        self.reached = set()
        self.bad = []               # (phase, op, dtype, inside fma32)
        self.host_reads = []        # op names read on the host in the step
        self.off_device = []        # (op, operand device) in the step
        self.device = None
        self.n_ops = {"setup": 0, "step": 0}
        self.records = {"step": []}   # OpRecords

    def seed(self, name, t):
        k = _key(t)
        if k is not None:
            self.taint[k] = self.taint.get(k, frozenset()) | {name}

    def taint_of(self, tensors):
        out = frozenset()
        for t in tensors:
            k = _key(t)
            if k is not None:
                out = out | self.taint.get(k, frozenset())
        return out

    def record(self, name, inputs, outputs, other=""):
        """One op from ``inputs`` to ``outputs`` (also a kernel wrapper);
        ``other``: its non-tensor arguments."""
        if self.phase in self.records:
            self.records[self.phase].append(OpRecord(
                name, tuple(_spec_str(t.shape, t.dtype) for t in inputs),
                tuple(_spec_str(t.shape, t.dtype) for t in outputs), other))
        u = self.taint_of(inputs)
        for t in outputs:
            k = _key(t)
            if k is not None:
                self.taint[k] = u
            if t.dtype in _BAD_DTYPES:
                self.bad.append((self.phase, name, str(t.dtype),
                                 self.in_fma > 0))
        self.n_ops[self.phase] += 1
        if self.phase != "setup":
            self.reached |= u
        if self.phase == "step" and self.device is not None:
            for t in inputs:
                if t.device != self.device:
                    self.off_device.append((name, str(t.device)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.opaque:
            return out
        schema = func._schema
        flat = tree_flatten((args, kwargs))[0]
        flat_in = [a for a in flat if isinstance(a, torch.Tensor)]
        other = [a for a in flat if not isinstance(a, torch.Tensor)]
        other = repr(other) if other else ""
        written = []
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                v = kwargs.get(arg.name, args[i] if i < len(args) else None)
                written += [a for a in tree_flatten(v)[0]
                            if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.record(schema.name, flat_in, outs + written,
                    other if len(other) <= 120 else other[:117] + "...")
        if self.phase == "step":
            to_host = (schema.name == "aten::_to_copy"
                       and flat_in and flat_in[0].device.type != "cpu"
                       and str(kwargs.get("device", "")) == "cpu")
            if schema.name in _HOST_READS or to_host:
                self.host_reads.append(schema.name)
        return out


@contextlib.contextmanager
def _opaque_kernels(tracer):
    """Record each call of a kernel wrapper (K1's, greedy's placement,
    the list schedule's two entries) as one op (the mode cannot see a
    ctypes launch; on the CPU the plain version's ops, and its host
    reads, are the kernel's stand-in, not the step's)."""
    from ..kernels import greedy_place as gk
    from ..kernels import list_schedule as lk
    from ..kernels import waterfill as wk
    inner_wf, inner_gp = wk._waterfill, gk.greedy_place
    inner_ls, inner_lp = lk.list_schedule, lk.blevel_priorities

    def opaque(name, fn, inputs, *args, **kwargs):
        tracer.opaque += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            tracer.opaque -= 1
        tracer.record(name, inputs, list(out) if isinstance(out, tuple)
                      else [out])
        return out

    def waterfill_seen(src, dst, active, caps_up, caps_down,
                       max_rounds=None, route=None):
        return opaque("repro_torch::waterfill", inner_wf,
                      [src, dst, active, caps_up, caps_down], src, dst,
                      active, caps_up, caps_down, max_rounds, route)

    def greedy_place_seen(*args, **kwargs):
        return opaque("repro_torch::greedy_place", inner_gp, list(args),
                      *args, **kwargs)

    def tensors(args):
        return [a for a in args if torch.is_tensor(a)]

    def list_schedule_seen(*args):
        return opaque("repro_torch::list_schedule", inner_ls,
                      tensors(args), *args)

    def blevel_priorities_seen(*args):
        return opaque("repro_torch::blevel_priorities", inner_lp,
                      tensors(args), *args)

    def fma_seen(a, b, c):
        tracer.in_fma += 1
        try:
            return fma(a, b, c)
        finally:
            tracer.in_fma -= 1

    fma = _sim.fma32
    wk._waterfill, gk.greedy_place = waterfill_seen, greedy_place_seen
    lk.list_schedule, lk.blevel_priorities = (list_schedule_seen,
                                              blevel_priorities_seen)
    _sim.fma32 = fma_seen
    try:
        yield
    finally:
        wk._waterfill, gk.greedy_place = inner_wf, inner_gp
        lk.list_schedule, lk.blevel_priorities = inner_ls, inner_lp
        _sim.fma32 = fma


@dataclasses.dataclass
class Observation:
    """What one target's call showed: the carry ``{key: (shape, dtype,
    device)}``, the step's outputs, the tracer's records, and an error
    raised by the step (``None`` when it ran)."""
    carry: dict
    step_out: dict
    tracer: _Tracer
    error: str | None = None


def _seed_args(tracer, target):
    for name, arg in zip(target.argnames, target.args, strict=True):
        if isinstance(arg, BucketedGraphSpec):
            for f, v in arg.fields().items():
                if torch.is_tensor(v):
                    tracer.seed(f"{name}.{f}", v)
        elif torch.is_tensor(arg):
            tracer.seed(name, arg)


def observe(target: Target) -> Observation:
    """Run ``target`` under the tracer up to its first event step, run
    that step once on copies of the carry, and stop the call."""
    tracer = _Tracer()
    _seed_args(tracer, target)
    obs = Observation(carry={}, step_out={}, tracer=tracer)

    def hook(st, live, body, cond):
        obs.carry = {k: (tuple(v.shape), v.dtype, v.device)
                     for k, v in st.items()}
        tracer.device = live.device
        work = {k: v.clone() for k, v in st.items()}
        lv = live.clone()
        try:
            tracer.phase = "step"

            def body_seen(s, l):
                new = body(s, l)
                obs.step_out.update(new)
                return new
            _sim._step_into(work, lv, body_seen, cond)
        except _Stop:
            raise
        except Exception as e:                  # the step itself failed
            obs.error = f"{type(e).__name__}: {e}"
        tracer.phase = "done"
        raise _Stop

    prev = _sim._DRIVE_OBSERVER
    _sim._DRIVE_OBSERVER = hook
    try:
        with _opaque_kernels(tracer), tracer:
            out = target.fn(*target.args)
            if target.scheduler:
                # a schedule: its value is the result
                for t in tree_flatten(out)[0]:
                    if torch.is_tensor(t):
                        tracer.reached |= tracer.taint_of([t])
    except _Stop:
        pass
    finally:
        _sim._DRIVE_OBSERVER = prev
    return obs


def leaf_names(argnames, args):
    """One name per tensor leaf of ``args`` (spec fields spelled out)."""
    names = []
    for an, a in zip(argnames, args, strict=True):
        if isinstance(a, BucketedGraphSpec):
            names.extend(f"{an}.{f}" for f in _BSPEC_FIELDS)
        elif torch.is_tensor(a):
            names.append(an)
    return names


def check_target(target: Target, stats: dict | None = None):
    """All JX1xx findings for one target; ``stats`` (a dict), when given,
    gets the target's op counts and host reads under its name."""
    loc = f"step:{target.name}"
    try:
        obs = observe(target)
    except Exception as e:                      # the call failed
        return [Finding("JX101", loc,
                        f"simulator call failed before its step: "
                        f"{type(e).__name__}: {e}")]
    tr = obs.tracer
    if stats is not None:
        stats[target.name] = dict(ops=dict(tr.n_ops),
                                  host_reads=len(tr.host_reads),
                                  carry=len(obs.carry))
    findings = []
    if not target.scheduler and not obs.carry:
        return [Finding("JX101", loc, "the call never reached its event "
                                      "loop (no carry observed)")]

    # JX101 / JX102: carry stability, baked values, host reads (from the
    # step's outputs, also when writing them into the carry failed)
    for k, (shape, dtype, _dev) in sorted(obs.carry.items()):
        if not obs.step_out:
            break
        v = obs.step_out.get(k)
        if v is None:
            findings.append(Finding("JX101", loc,
                                    f"carry entry {k!r} missing from the "
                                    f"step's output"))
        elif not torch.is_tensor(v):
            findings.append(Finding(
                "JX102", loc, f"carry entry {k!r} is {type(v).__name__} "
                              f"{v!r} after the step: a Python value baked "
                              f"into the captured step"))
        elif tuple(v.shape) != shape or v.dtype != dtype:
            findings.append(Finding(
                "JX101", loc, f"carry entry {k!r} is unstable: carry "
                              f"{_spec_str(shape, dtype)} != step output "
                              f"{_spec_str(v.shape, v.dtype)}"))
    extra = sorted(set(obs.step_out) - set(obs.carry))
    if extra:
        findings.append(Finding("JX101", loc, f"the step returns entries "
                                              f"outside the carry {extra}"))
    if obs.error is not None and not findings:
        findings.append(Finding("JX101", loc,
                                f"the event step failed: {obs.error}"))
    if tr.host_reads:
        findings.append(Finding(
            "JX101", loc, f"{len(tr.host_reads)} host read(s) inside the "
                          f"step ({', '.join(sorted(set(tr.host_reads)))}): "
                          f"a CUDA graph cannot capture them"))
    for op, dev in sorted(set(tr.off_device)):
        findings.append(Finding(
            "JX102", loc, f"{op} in the step reads a tensor on {dev}, not "
                          f"on the carry's {tr.device}: its value is baked "
                          f"into the captured step"))

    # JX103: no float64/complex128 anywhere.  ``_ops.fma32`` rounds
    # ``a * b + c`` once, as the reference's contracted multiply-add, by
    # way of float64 (a float32 product is exact there) and returns
    # float32: its float64 stays inside it, so it is reported suppressed
    bad = sorted(set(tr.bad))
    for phase, op, dt, _ in (b for b in bad if not b[3]):
        findings.append(Finding(
            "JX103", loc, f"{dt} output of {op} in the {phase} (the "
                          f"simulator contract is float32 end to end)"))
    in_fma = sorted({f"{op} ({phase})" for phase, op, _, f in bad if f})
    if in_fma:
        findings.append(Finding(
            "JX103", loc, f"float64 inside _ops.fma32: {', '.join(in_fma)} "
                          f"(an exact single-rounding emulation; its "
                          f"output is float32)", suppressed=True))

    # JX104: required-live arguments reach the step (or the schedule)
    names = set(leaf_names(target.argnames, target.args))
    for name in sorted(target.required_live):
        if name not in names:
            findings.append(Finding("JX104", loc,
                                    f"required argument {name} is not an "
                                    f"argument of the target"))
        elif name not in tr.reached:
            where = "schedule" if target.scheduler else "event step"
            findings.append(Finding(
                "JX104", loc, f"argument {name} is dead: its value reaches "
                              f"no op of the {where} (read on the host or "
                              f"dropped at build time)"))

    carry = {k: (shape, dtype) for k, (shape, dtype, _) in obs.carry.items()}
    R = next(iter(carry.values()))[0][0] if carry else None
    # JX105: bounded slot pool, no per-edge float32 carry in slot mode
    if target.slot_pool is not None and carry:
        S, E = target.slot_pool, target.n_edges
        have = {(dt, shape) for shape, dt in carry.values()}
        for dt in (torch.int32, torch.float32):
            if (dt, (R, S)) not in have:
                findings.append(Finding(
                    "JX105", loc, f"no {_spec_str((R, S), dt)} flow-slot "
                                  f"pool in the carry (S = "
                                  f"DOWNLOAD_SLOTS*W = {S})"))
        for k, (shape, dt) in sorted(carry.items()):
            if E and shape == (R, E) and dt == torch.float32:
                findings.append(Finding(
                    "JX105", loc, f"float32[{R},{E}] per-edge carry {k!r} "
                                  f"in a slot-mode target — the O(E) state "
                                  f"the flow-slot pool replaced"))

    # JX106: bounded frontier lists; frontier+slot carries nothing [R, E]
    if target.frontier_caps is not None and carry:
        CF, CT = target.frontier_caps
        E = target.n_edges
        want = {CT: "task"}
        if target.slot_pool is not None:
            want[CF] = "flow"
        found = {shape[1] for shape, dt in carry.values()
                 if len(shape) == 2 and dt in (torch.int32, torch.int64)}
        for cap, kind in sorted(want.items()):
            if cap not in found:
                findings.append(Finding(
                    "JX106", loc, f"no [{R},{cap}] {kind} frontier list in "
                                  f"the carry (frontier_caps_for derived "
                                  f"CF={CF}, CT={CT})"))
        if target.slot_pool is not None and E:
            for k, (shape, dt) in sorted(carry.items()):
                if shape == (R, E):
                    findings.append(Finding(
                        "JX106", loc, f"{_spec_str(shape, dt)} per-edge "
                                      f"carry {k!r} in a frontier slot-mode "
                                      f"target — the O(E) loop state the "
                                      f"ready frontier replaced"))
    return findings


# ------------------------------------------------------------ the grid

_SPEC_LEAVES = frozenset(f"bspec.{f}" for f in _BSPEC_FIELDS)
# the static path never reads obj_valid (sizes of invalid objects are
# already zero in the padded spec); everything else must stay live
_STATIC_SIM_LIVE = frozenset(
    (_SPEC_LEAVES - {"bspec.obj_valid"})
    | {"assignment", "priority", "bandwidth", "cores"})
_SCHED_SPEC_LIVE = frozenset({"bspec.producer", "bspec.edge_task",
                              "bspec.edge_obj", "bspec.edge_valid",
                              "bspec.cpus"})


def _dynamic_live(scheduler):
    live = set(_SPEC_LEAVES) | {"est_durations", "est_sizes",
                                "decision_delay", "bandwidth", "cores"}
    if scheduler == "greedy":
        live.add("msd")             # only the in-loop scheduler is gated
    if scheduler == "random":
        live.add("seed")            # the only seed-consuming scheduler
        live.discard("est_sizes")   # random ignores transfer estimates
        # ... and obj_valid masks only those estimates: the reference
        # counts it live because an equation reads it; here liveness is
        # the value reaching the step
        live.discard("bspec.obj_valid")
    return frozenset(live)


def _scheduler_live(scheduler):
    live = set(_SCHED_SPEC_LIVE) | {"est_durations", "cores"}
    if scheduler == "random":
        live.add("seed")
    else:
        live |= {"est_sizes", "bandwidth"}
    if scheduler == "etf":
        live.add("bspec.n_inputs")
    return frozenset(live)


def _graph_spec(shape, seed, n_tasks, device):
    """A seeded random graph's spec padded to ``shape`` (padding is
    inert), as tensors on ``device``."""
    T, O, E = shape
    for s in range(seed, seed + 64):
        spec = encode_graph(random_graph(s, n_tasks=n_tasks))
        if spec.T <= T and spec.O <= O and spec.E <= E:
            return pad_spec(spec, shape).to(device)
    raise ValueError(f"no random graph of {n_tasks} tasks fits {shape}")


def default_targets(n_workers: int = 4, shape=(32, 64, 96), device="cuda",
                    rows: int = 2, seed: int = 0):
    """The check targets: the reference's 27 names — both simulator
    families over both netmodels, every registered scheduler, the
    frontier grid, the two ``frontier=False`` pins, the grid engine and
    the static scheduler bindings — all with call-time cores.  Each runs
    ``rows`` rows on a seeded random graph padded to ``shape`` (the
    frontier grid: ``(1280, 192, 2048)``)."""
    dev = resolve_device(device)
    W, R = n_workers, rows
    T, O, E = shape
    S = W * DOWNLOAD_SLOTS
    rng = np.random.default_rng(seed)
    spec = _graph_spec(shape, seed, min(T, 20), dev)

    def f32(*s):
        return torch.as_tensor(rng.uniform(0.5, 2.0, s).astype(np.float32),
                               device=dev)

    def full(value, dtype):
        return torch.full((R,), value, dtype=dtype, device=dev)

    cores = torch.full((R, W), 4, dtype=torch.int64, device=dev)
    bandwidth = full(100 * 1024 * 1024.0, torch.float32)
    static_names = ("bspec", "assignment", "priority", "durations", "sizes",
                    "bandwidth", "cores")
    dyn_names = ("bspec", "est_durations", "est_sizes", "msd",
                 "decision_delay", "bandwidth", "seed", "cores")

    def static_args(sp, t):
        a = torch.as_tensor(rng.integers(0, W, (R, t)), device=dev)
        return (sp, a, f32(R, t), None, None, bandwidth, cores)

    def dyn_args(sp, t, o):
        return (sp, f32(R, t), f32(R, o) * 1e6, full(0.1, torch.float32),
                full(0.05, torch.float32), bandwidth,
                full(3, torch.int64), cores)

    opts = dict(max_cores=4, device=dev)
    targets = []
    for netmodel in ("maxmin", "simple"):
        targets.append(Target(
            name=f"make_bucket_simulator[{netmodel}]",
            fn=make_bucket_simulator(W, None, netmodel, **opts),
            args=static_args(spec, T), argnames=static_names,
            required_live=_STATIC_SIM_LIVE,
            slot_pool=S if netmodel == "maxmin" else None, n_edges=E))
    for sched in sorted(VEC_SCHEDULERS):
        for netmodel in ("maxmin", "simple"):
            targets.append(Target(
                name=f"make_bucket_dynamic_simulator[{sched},{netmodel}]",
                fn=make_bucket_dynamic_simulator(W, None, sched, netmodel,
                                                 **opts),
                args=dyn_args(spec, T, O), argnames=dyn_names,
                required_live=_dynamic_live(sched),
                slot_pool=S if netmodel == "maxmin" else None, n_edges=E))

    # the frontier grid (JX106), on a bucket shape where the derived caps
    # (CF=512, CT=320) differ from every other axis (T=1280, O=192,
    # E=2048, S=16, O*W=768), so a [cap]-wide entry cannot alias [T] or
    # [E] state; at (32, 64, 96) the caps equal T and E
    fr_shape = (1280, 192, 2048)
    Tf, Of, Ef = fr_shape
    fr_spec = _graph_spec(fr_shape, seed, 120, dev)
    fr_caps = frontier_caps_for(fr_shape)
    for netmodel in ("maxmin", "simple"):
        targets.append(Target(
            name=f"make_bucket_simulator[{netmodel},frontier@T{Tf}]",
            fn=make_bucket_simulator(W, None, netmodel, **opts),
            args=static_args(fr_spec, Tf), argnames=static_names,
            required_live=_STATIC_SIM_LIVE,
            slot_pool=S if netmodel == "maxmin" else None,
            n_edges=Ef, frontier_caps=fr_caps))
    for sched, netmodel in (("blevel", "maxmin"), ("greedy", "maxmin"),
                            ("blevel", "simple")):
        targets.append(Target(
            name=(f"make_bucket_dynamic_simulator"
                  f"[{sched},{netmodel},frontier@T{Tf}]"),
            fn=make_bucket_dynamic_simulator(W, None, sched, netmodel,
                                             **opts),
            args=dyn_args(fr_spec, Tf, Of), argnames=dyn_names,
            required_live=_dynamic_live(sched),
            slot_pool=S if netmodel == "maxmin" else None,
            n_edges=Ef, frontier_caps=fr_caps))

    # the frontier=False escape hatch keeps the slot-pool carry contract
    # (slot pool present, no float32 [R, E] in slot mode)
    targets.append(Target(
        name="make_bucket_simulator[maxmin,frontier=off]",
        fn=make_bucket_simulator(W, None, "maxmin", frontier=False, **opts),
        args=static_args(spec, T), argnames=static_names,
        required_live=_STATIC_SIM_LIVE, slot_pool=S, n_edges=E))
    targets.append(Target(
        name="make_bucket_dynamic_simulator[blevel,maxmin,frontier=off]",
        fn=make_bucket_dynamic_simulator(W, None, "blevel", "maxmin",
                                         frontier=False, **opts),
        args=dyn_args(spec, T, O), argnames=dyn_names,
        required_live=_dynamic_live("blevel"), slot_pool=S, n_edges=E))

    # the grid engine (engine.py): the dynamic simulator's rows streamed
    # through ShardedGridRunner on one card, 2 clusters x 1 point.  Its
    # rows are built from host arrays inside the runner, so no argument
    # taint reaches it: liveness is not checked (required_live empty),
    # and slot-pool and frontier classification are left to the targets
    # above, as in the reference
    graph = random_graph(seed, n_tasks=min(T, 20))
    runner = make_grid_runner([(graph, encode_graph(graph))], "blevel", W,
                              np.full((2, W), 4, np.int32), shape=shape,
                              device=dev, engine="sharded", stream_rows=2)
    targets.append(Target(
        name="sharded_engine[blevel,maxmin,grid@1]", fn=runner,
        args=([dict(bandwidth=100 * 1024 * 1024.0)],), argnames=("points",),
        required_live=frozenset()))

    sched_names = ("bspec", "est_durations", "est_sizes", "bandwidth",
                   "seed", "cores")
    for sched in sorted(k for k, v in VEC_SCHEDULERS.items()
                        if v == "static"):
        targets.append(Target(
            name=f"make_bucket_scheduler[{sched}]",
            fn=rows_schedule(make_bucket_scheduler(W, None, sched,
                                                   max_cores=4), dev),
            args=(spec, f32(R, T), f32(R, O) * 1e6, bandwidth,
                  full(3, torch.int64), cores),
            argnames=sched_names, required_live=_scheduler_live(sched),
            scheduler=True))
    return targets


def check_all(targets=None, n_workers: int = 4, shape=(32, 64, 96), *,
              device="cuda", stats: dict | None = None):
    """Run every JX1xx check over the target grid on ``device`` (default
    the card; raises without one); returns the findings.  ``stats``, when
    given, gets each target's op counts and host reads."""
    if targets is None:
        targets = default_targets(n_workers, shape, device=device)
    findings = []
    for t in targets:
        findings.extend(check_target(t, stats))
    return findings
