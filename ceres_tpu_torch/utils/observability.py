"""Tracing, problem dumps and checkpointing (port of
``ceres_tpu/utils/observability.py``; the tracer is the port's own).

- ``EventLogger`` — scoped phase timer (event_logger.h:41-75); deltas are
  logged per phase and the total on ``finish``.
- ``ExecutionSummary`` / ``ScopedExecutionTimer`` — name -> {time, calls}
  aggregation (execution_summary.h:44-84). The solver's control flow is
  single-threaded on the host, so no lock; a time is the host's, which
  covers the device work only where the timed code waits for it.
- trust-region problem dumps — write (J, D, b, x) per iteration for
  offline debugging (solver.h:725-735, trust_region_minimizer.cc:386-396,
  linear_least_squares_problems.cc writers), here as .npz.
- checkpoint/resume — the reference has none; Ceres users emulate it with
  IterationCallbacks. ``CheckpointManager`` saves the blocks' values per
  iteration and can seed a resumed solve.
- the tracer (``enable_tracing`` .. ``disable_tracing``; off by default):
  host spans and the device's phase stamps of every solve, on one clock.

The tracer. ``span(name)`` records a host span: its name, start and end on
``time.perf_counter_ns``, its parent span and its solve; while a
``torch.profiler`` records, it also enters
``torch.profiler.record_function("ceres.<name>")``, so that the spans stand
in the profiler's trace on its clock. ``EventLogger`` and
``ScopedExecutionTimer`` record their phases as spans when the tracer is on
(their times are then the spans'). Off, ``span`` is one test of a module
flag that returns a shared null context, and nothing else of the tracer
runs.

Device phases. The loops stamp the device work with ``phase(name)``: a
one-thread kernel writes (phase code, ``%globaltimer``) into the next row
of the running loop's ``cuda_graph.DeviceLog``, captured into the loop's
CUDA graphs like any kernel (on the CPU a stamp takes the host clock at
once). The stamps, in the order of ``PHASES``:

- ``replay`` / ``region``: the start of a fused-loop replay (the start's
  graph, an LM iteration's, outside its IF node) or of a host-loop region;
  ``end``: its end. A replay whose IF node was skipped is a ``replay``
  followed by its ``end``.
- ``evaluate``: ``evaluator._full_impl`` (the start's evaluation too);
- ``assemble``: the column norms and scaling, the LM damping, the Schur
  elimination, S's assembly, the reduced rhs and the preconditioner;
- ``linear_solve``: the factorization and its solve, or CG, and the
  back-substitution;
- ``candidate``: the model cost change, the candidate point and its cost;
- ``update``: the radius, the convergence tests and the state copies.

A stamp begins a phase that lasts to the next stamp. A loop made while the
tracer is on has a log and graphs with the stamps (the loops' caches key
on ``tracing_enabled()``); one made while it is off has neither. Each loop
reads its log with the read it makes anyway, and hands the stamps to
``device_stamps``, which maps them onto the host clock by the device's
calibration (``calibrate``: an eager stamp between two host clock reads
around a synchronize, taken when the tracer is turned on and again when
its records are taken, and whenever ``calibrate`` is called; the latest
maps). ``solve`` and ``fused_solve`` are each one
``solve_scope``: their spans and device stamps go to
``SolverSummary.spans`` (a ``SolveTrace``; None with the tracer off), with
the residual-family evaluations the solve made by route (``evaluations``:
a residual's fused kernel or vmap(jacfwd), counted with the tracer on or
off, captured ones once per replay that ran them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class EventLogger:
    """Scoped phase timer (event_logger.h:41-75). With the tracer on, each
    event is also a span ``<name>:<event>`` over the same clock readings."""

    def __init__(self, name: str, verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self._start_ns = self._last_ns = time.perf_counter_ns()
        self.events = []

    def add_event(self, event: str) -> None:
        now = time.perf_counter_ns()
        record_span(f"{self.name}:{event}", self._last_ns, now)
        self.events.append((event, (now - self._last_ns) * 1e-9, (now - self._start_ns) * 1e-9))
        self._last_ns = now
        if self.verbose:
            print(
                f"{self.name:30s} : {event:30s} "
                f"{self.events[-1][1]:10.6f} {self.events[-1][2]:10.6f}"
            )

    def finish(self) -> None:
        self.add_event("total")


class ExecutionSummary:
    """name -> {time, calls} aggregation (execution_summary.h:44-84)."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def update_time(self, name: str, dt: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{'name':<40s}{'calls':>8s}{'time (s)':>12s}"]
        for name in sorted(self.times):
            lines.append(
                f"{name:<40s}{self.calls[name]:>8d}{self.times[name]:>12.4f}"
            )
        return "\n".join(lines)


class ScopedExecutionTimer:
    """with ScopedExecutionTimer('Evaluator::Residual', summary): ...
    (execution_summary.h ScopedExecutionTimer). With the tracer on, the
    block is a span of that name and its time the span's."""

    def __init__(self, name: str, summary: ExecutionSummary):
        self.name = name
        self.summary = summary

    def __enter__(self):
        self._span = span(self.name).__enter__()
        self._t0 = time.perf_counter_ns() if self._span is None else 0
        return self

    def __exit__(self, *exc):
        if self._span is None:
            ns = time.perf_counter_ns() - self._t0
        else:
            self._span.__exit__(*exc)
            ns = self._span.end_ns - self._span.start_ns
        self.summary.update_time(self.name, ns * 1e-9)
        return False


def _host(a):
    return a.detach().cpu().numpy()


def dump_trust_region_problem(path_base: str, iteration: int, ctx, D, step=None) -> str:
    """Write the LM subproblem min |J x - f|^2 + |D x|^2 to an .npz
    (analog of DumpLinearLeastSquaresProblem,
    trust_region_minimizer.cc:386-396 / linear_least_squares_problems.cc
    textfile writers — npz replaces the matlab dumps). The dense Jacobian
    is formed on the device: dumps are for small problems."""
    path = f"{path_base}_{iteration:03d}.npz"
    np.savez_compressed(
        path,
        jacobian=_host(ctx.to_dense()),
        rhs=_host(ctx.residual_vector()),
        D=_host(D),
        step=None if step is None else _host(step),
    )
    return path


@dataclasses.dataclass
class Checkpoint:
    x: np.ndarray
    trust_region_radius: float
    iteration: int
    cost: float


class CheckpointManager:
    """Iteration-granular checkpoint/resume.

    Use as an IterationCallback: ``options.callbacks.append(cm.callback)``
    with ``options.update_state_every_iteration`` — then ``cm.latest()``
    seeds a resumed solve via ``problem.set_parameter_block_value`` /
    ``SolverOptions.initial_trust_region_radius``.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._problem = None

    def attach(self, problem) -> None:
        self._problem = problem

    def callback(self, it) -> None:
        """IterationCallback hook (iteration_callback.h)."""
        if self._problem is None:
            return
        state = {
            "iteration": it.iteration,
            "cost": it.cost,
            "trust_region_radius": it.trust_region_radius,
        }
        blocks = {
            str(pid): self._problem.parameter_block_value(pid)
            for pid in self._problem.parameter_block_ids()
        }
        path = self.dir / f"ckpt_{it.iteration:06d}.npz"
        np.savez_compressed(path, meta=json.dumps(state), **blocks)
        for old in sorted(self.dir.glob("ckpt_*.npz"))[: -self.keep]:
            old.unlink()

    def latest(self) -> Optional[dict]:
        ckpts = sorted(self.dir.glob("ckpt_*.npz"))
        if not ckpts:
            return None
        with np.load(ckpts[-1], allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            blocks = {int(k): data[k] for k in data.files if k != "meta"}
        return {"meta": meta, "blocks": blocks}

    def restore(self, problem) -> Optional[dict]:
        """Load the latest checkpoint into the problem's blocks."""
        ck = self.latest()
        if ck is None:
            return None
        for pid, values in ck["blocks"].items():
            problem.set_parameter_block_value(pid, values)
        return ck["meta"]


# -- the tracer ---------------------------------------------------------------------

# Device stamp codes: a stamp's code is its index here (the module's docstring).
PHASES = ("replay", "region", "end", "evaluate", "assemble", "linear_solve", "candidate",
          "update")
_CODES = {name: code for code, name in enumerate(PHASES)}
# An LM iteration's phases, in the fused loop's order.
LM_PHASES = ("evaluate", "assemble", "linear_solve", "candidate", "update")
# Spans and stamps the tracer holds at once; what comes beyond is counted as
# dropped.
CAPACITY = 1 << 20
# Eager stamps a calibration makes; it keeps the narrowest bracket.
CALIBRATION_TRIES = 5

_NULL = contextlib.nullcontext()
# Residual-family evaluations since the process started, by route: "kernel"
# (the residual's fused form, ``evaluator._fused_form``) and "vmap"
# (vmap(jacfwd)); captured ones credited once per replay that ran them. Each
# solve's share goes to its ``SolveTrace.evaluations``.
evaluations: Dict[str, int] = {"kernel": 0, "vmap": 0}
_tracer: Optional["_Tracer"] = None  # the module flag: None while the tracer is off
_log = None  # the DeviceLog that phase() stamps into: the running loop's


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed host span, its times on ``time.perf_counter_ns``; the id of
    its solve's root span (None outside a solve)."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    solve_id: Optional[int]


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One reading of a device's clock against the host's: the device wrote
    ``device_ns`` inside a bracket of ``width_ns`` host nanoseconds whose
    middle is ``host_ns``."""

    device: str
    host_ns: int
    device_ns: int
    width_ns: int


@dataclasses.dataclass
class SolveTrace:
    """The records of one solve (``SolverSummary.spans``): its host spans,
    the root first, and the device's phase stamps in the order the device
    wrote them, each (phase, host-clock ns), mapped by a calibration whose
    bracket was ``calibration_width_ns`` wide (0 on the CPU, whose stamps
    read the host clock). ``dropped_*``: what the tracer's capacity or the
    device log's left out. The device figures are None where a stamp was
    dropped or none was written, never 0 for want of records.
    ``evaluations``: the residual-family evaluations the solve made, by route
    (``evaluations`` of this module)."""

    spans: List[Span]
    stamps: List[Tuple[str, int]]
    dropped_spans: int = 0
    dropped_stamps: int = 0
    calibration_width_ns: int = 0
    evaluations: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def root(self) -> Span:
        return self.spans[0]

    def intervals(self) -> Optional[list]:
        """One device interval per replay or region: (kind "replay" or
        "region", start ns, end ns, [(phase, start ns, end ns), ...]); each
        phase lasts from its stamp to the next, and the first entry, under
        the kind's name, is the time before the first phase (a replay's
        predicate and the launch of its IF node)."""
        if self.dropped_stamps or not self.stamps:
            return None
        out, current = [], None
        for name, t in self.stamps:
            if current is not None:
                phase, start, _ = current[2][-1]
                current[2][-1] = (phase, start, t)
            if name in ("replay", "region"):
                if current is not None:
                    return None
                current = (name, t, [(name, t, t)])
            elif current is None:
                return None
            elif name == "end":
                out.append((current[0], current[1], t, current[2]))
                current = None
            else:
                current[2].append((name, t, t))
        return None if current is not None else out

    def phase_ms(self) -> Optional[Dict[str, float]]:
        """Device milliseconds by phase (the kinds' own time under
        "replay" and "region"), over the solve."""
        intervals = self.intervals()
        if intervals is None:
            return None
        out: Dict[str, float] = {}
        for _, _, _, phases in intervals:
            for phase, start, end in phases:
                out[phase] = out.get(phase, 0.0) + (end - start) * 1e-6
        return out

    def phase_counts(self) -> Optional[Dict[str, int]]:
        """How many times each phase began, consecutive stamps of one phase
        counted once."""
        intervals = self.intervals()
        if intervals is None:
            return None
        out: Dict[str, int] = {}
        for _, _, _, phases in intervals:
            last = None
            for phase, _, _ in phases:
                if phase != last:
                    out[phase] = out.get(phase, 0) + 1
                last = phase
        return out

    def skipped_replays_ms(self) -> Optional[float]:
        """Device milliseconds of the fused loop's replays that ran no
        phase (their IF node skipped); None where no replay ran."""
        intervals = self.intervals()
        replays = [i for i in intervals or () if i[0] == "replay"]
        if not replays:
            return None
        return sum((end - start) * 1e-6 for _, start, end, phases in replays if len(phases) == 1)

    def outside_device_ms(self) -> Optional[float]:
        """Milliseconds of the root span that no device interval covers: the
        card's idle time in the solve, the intervals on the host clock."""
        intervals = self.intervals()
        if not intervals:
            return None
        lo, hi = self.root.start_ns, self.root.end_ns
        covered, reach = 0, lo
        for _, start, end, _ in sorted(intervals, key=lambda i: i[1]):
            start, end = max(start, reach), min(end, hi)
            if end > start:
                covered += end - start
                reach = end
        return (hi - lo - covered) * 1e-6


class _Records:
    """The spans and stamps of a solve while it runs, or those outside any."""

    def __init__(self, solve_id: Optional[int]):
        self.solve_id = solve_id
        self.spans: List[Span] = []
        self.stamps: List[Tuple[str, int]] = []
        self.dropped_spans = 0
        self.dropped_stamps = 0
        self.width_ns = 0


class _Tracer:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.held = 0  # spans and stamps held
        self.outside = _Records(None)
        self.solves: List[_Records] = []  # the solves under way, innermost last
        self.stack: List[int] = []  # the open spans' ids, innermost last
        self.next_id = 0
        self.calibrations: Dict[str, List[Calibration]] = {}

    def new_id(self) -> int:
        self.next_id += 1
        return self.next_id

    def records(self) -> _Records:
        return self.solves[-1] if self.solves else self.outside

    def add(self, s: Span) -> None:
        records = self.records()
        if self.held >= self.capacity:
            records.dropped_spans += 1
            return
        records.spans.append(s)
        self.held += 1


class _OpenSpan:
    __slots__ = ("tracer", "name", "span_id", "parent_id", "solve_id", "start_ns", "end_ns",
                 "_profiled")

    def __init__(self, tracer: _Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        self.parent_id = t.stack[-1] if t.stack else None
        self.span_id = t.new_id()
        self.solve_id = t.solves[-1].solve_id if t.solves else None
        t.stack.append(self.span_id)
        self._profiled = None
        if torch.autograd._profiler_enabled():
            self._profiled = torch.profiler.record_function(f"ceres.{self.name}")
            self._profiled.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self, *exc) -> Span:
        self.end_ns = time.perf_counter_ns()
        if self._profiled is not None:
            self._profiled.__exit__(*exc)
        stack = self.tracer.stack
        if stack and stack[-1] == self.span_id:
            stack.pop()
        return Span(self.name, self.start_ns, self.end_ns, self.span_id, self.parent_id,
                    self.solve_id)

    def __exit__(self, *exc):
        self.tracer.add(self.close(*exc))
        return False


class _SolveScope:
    """A solve: its root span, and its records, taken at the end into
    ``trace``."""

    def __init__(self, tracer: _Tracer, name: str):
        self.tracer, self.root = tracer, _OpenSpan(tracer, name)
        self.trace: Optional[SolveTrace] = None

    def __enter__(self):
        self.evaluations = dict(evaluations)
        self.root.__enter__()
        self.root.solve_id = self.root.span_id
        self.tracer.solves.append(_Records(self.root.span_id))
        return self

    def __exit__(self, *exc):
        t = self.tracer
        root = self.root.close(*exc)
        r = t.solves.pop()
        t.held -= len(r.spans) + len(r.stamps)
        self.trace = SolveTrace([root] + r.spans, r.stamps, r.dropped_spans, r.dropped_stamps,
                                r.width_ns,
                                {k: n - self.evaluations[k] for k, n in evaluations.items()})
        return False


def tracing_enabled() -> bool:
    return _tracer is not None


def enable_tracing(capacity: int = CAPACITY) -> None:
    """Turn the tracer on (a no-op when it is on), holding at most
    ``capacity`` spans and stamps outside the solves' summaries; calibrates
    the current CUDA device where CUDA is initialized."""
    global _tracer
    if _tracer is not None:
        return
    _tracer = _Tracer(capacity)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        calibrate(torch.device("cuda", torch.cuda.current_device()))


def disable_tracing() -> Optional[dict]:
    """Turn the tracer off; returns its last records (``take_records``)."""
    global _tracer
    records = take_records()
    _tracer = None
    return records


@contextlib.contextmanager
def tracing(capacity: int = CAPACITY):
    """The tracer on inside the with-body (off again after it, its records
    dropped unless taken)."""
    enable_tracing(capacity)
    try:
        yield
    finally:
        disable_tracing()


def take_records() -> Optional[dict]:
    """The tracer's records outside any solve, which it drops: "spans",
    "stamps", "dropped_spans", "dropped_stamps"; and "calibrations" ({device:
    [Calibration, ...]}, each device read again now) with "drift" ({device:
    (device ns - host ns elapsed between its first and last reading, host ns
    elapsed)}). None with the tracer off."""
    t = _tracer
    if t is None:
        return None
    for device in list(t.calibrations):
        calibrate(device)
    r, t.outside = t.outside, _Records(None)
    t.held -= len(r.spans) + len(r.stamps)
    drift = {}
    for device, cals in t.calibrations.items():
        first, last = cals[0], cals[-1]
        host = last.host_ns - first.host_ns
        drift[device] = (last.device_ns - first.device_ns - host, host)
    return {"spans": r.spans, "stamps": r.stamps, "dropped_spans": r.dropped_spans,
            "dropped_stamps": r.dropped_stamps,
            "calibrations": {d: list(c) for d, c in t.calibrations.items()}, "drift": drift}


def span(name: str):
    """A host span around the with-body (see the module's docstring): with
    the tracer off, a shared null context."""
    if _tracer is None:
        return _NULL
    return _OpenSpan(_tracer, name)


def record_span(name: str, start_ns: int, end_ns: int) -> None:
    """A span already closed, inside the innermost open one."""
    t = _tracer
    if t is None:
        return
    solve_id = t.solves[-1].solve_id if t.solves else None
    t.add(Span(name, start_ns, end_ns, t.new_id(), t.stack[-1] if t.stack else None, solve_id))


def solve_scope(name: str):
    """A solve's root span: the spans and stamps inside it go to its
    ``trace`` (a ``SolveTrace``) at its end; with the tracer off, a shared
    null context, whose value is None."""
    if _tracer is None:
        return _NULL
    return _SolveScope(_tracer, name)


def calibrate(device) -> Optional[Calibration]:
    """Read ``device``'s clock against the host's (kept by the tracer: the
    latest reading maps the device's stamps, and the first and last show
    its drift):
    an eager stamp between two host clock reads, the device drained before
    and synchronized after, the narrowest of ``CALIBRATION_TRIES``. None for
    a CPU, whose stamps read the host clock, or with the tracer off."""
    t = _tracer
    device = torch.device(device)
    if t is None or device.type != "cuda":
        return None
    from ceres_tpu_torch.utils.cuda_graph import DeviceLog

    log = DeviceLog(device, 1)
    best = None
    with torch.cuda.device(log.device):
        for _ in range(CALIBRATION_TRIES):
            log.reset()
            torch.cuda.synchronize(log.device)
            t0 = time.perf_counter_ns()
            log.stamp(0)
            torch.cuda.synchronize(log.device)
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, int(log.buf[0, 1]))
    t0, t1, device_ns = best
    cal = Calibration(str(log.device), (t0 + t1) // 2, device_ns, t1 - t0)
    t.calibrations.setdefault(cal.device, []).append(cal)
    return cal


def ensure_calibrated(device) -> None:
    """Calibrate ``device`` unless the tracer has a reading of it already
    (a loop that makes its log calls it, in its set-up)."""
    t = _tracer
    device = torch.device(device)
    if t is not None and device.type == "cuda" and str(device) not in t.calibrations:
        calibrate(device)


def device_stamps(device, rows: np.ndarray, dropped: int) -> None:
    """Hand the tracer the stamps a loop read from its log: ``rows`` (n, 2)
    int64 (phase code, device ns) in the order written, ``dropped`` those
    the log had no room for. They go to the solve under way, mapped onto
    the host clock by the device's latest calibration."""
    t = _tracer
    if t is None:
        return
    device = torch.device(device)
    offset = width = 0
    if device.type == "cuda":
        ensure_calibrated(device)
        cal = t.calibrations[str(device)][-1]
        offset, width = cal.host_ns - cal.device_ns, cal.width_ns
    records = t.records()
    keep = rows[: max(t.capacity - t.held, 0)]
    records.stamps.extend((PHASES[int(code)], int(ns) + offset) for code, ns in keep)
    t.held += len(keep)
    records.dropped_stamps += int(dropped) + len(rows) - len(keep)
    records.width_ns = max(records.width_ns, width)


class _Stamping:
    __slots__ = ("log", "outer")

    def __init__(self, log):
        self.log = log

    def __enter__(self):
        global _log
        self.outer, _log = _log, self.log

    def __exit__(self, *exc):
        global _log
        _log = self.outer
        return False


def device_log(log):
    """``phase`` stamps into ``log`` (a ``cuda_graph.DeviceLog``) inside the
    with-body; for None, a shared null context."""
    return _NULL if log is None else _Stamping(log)


def count_evaluation(n: int, route: str) -> None:
    """Add n residual-family evaluations by ``route`` (a
    ``utils.cuda_graph.counted`` credit)."""
    evaluations[route] += n


def phase(name: str) -> None:
    """Stamp the start of device phase ``name`` (``PHASES``) into the
    running loop's log; nothing where no loop with a log runs."""
    if _log is None:
        return
    _log.stamp(_CODES[name])
