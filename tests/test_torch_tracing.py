"""The port's tracer (``ceres_tpu_torch/utils/observability.py``): host spans
and the device's phase stamps of a solve, on one clock.

On the CPU: with the tracer off nothing is recorded and a span is the shared
null context; a solve's results are the same bits on and off, on the host
loop and on the fused loop (run eagerly here); a traced solve has one root
span, every span closed and nested inside its parent; its phases come in the
order each loop runs them, one ``linear_solve`` an LM iteration; an
overflowing log counts what it drops; ``EventLogger``'s and
``ScopedExecutionTimer``'s phases are spans; the figures a ``SolveTrace``
gives, on stamps made by hand. Marked ``cuda`` (the card only): the captured
fused loop and host loop give the same bits and host reads with the tracer on
as off, and in a profiled DENSE_SCHUR solve K4's kernel time falls inside
the ``assemble`` phases once the profiler's clock is mapped onto the
tracer's. This file imports neither jax nor ceres_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import fused_lm, host_loop_graphs
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.utils import cuda_graph
from ceres_tpu_torch.utils import observability as obs

# One LM iteration's phases, as each loop runs them. The fused loop
# evaluates at the iterate and tests the candidate's cost; the host loop's
# fused iteration evaluates the candidate's Jacobian after its step.
FUSED_ITERATION = ["replay", "evaluate", "assemble", "linear_solve", "candidate", "update", "end"]
FUSED_START = ["replay", "evaluate", "update", "end"]
SKIPPED_REPLAY = ["replay", "end"]
HOST_ITERATION = ["region", "assemble", "linear_solve", "candidate", "evaluate", "end"]
HOST_START = [["region", "evaluate", "end"], ["region", "assemble", "end"]]  # full, jacobi_scaling
HOST_ACCEPT = ["region", "update", "end"]


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable_tracing()
    yield
    obs.disable_tracing()


def _problem(seed=3, cameras=4, points=60, observations=240):
    inst = bal.synthesize_bal(num_cameras=cameras, num_points=points,
                              num_observations=observations, seed=seed)
    return bal.build_problem(inst)[0]


def _options(loop: str, iterative: bool = False):
    opts = bal.default_options(iterative=iterative)
    if loop == "host":
        opts.callbacks = [lambda it: ctt.CallbackReturnType.SOLVER_CONTINUE]
    return opts


def _records_key(summary) -> list:
    """The IterationSummary records but their three times, to the bit."""
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]


def _solve_on_and_off(loop, iterative, device="cpu"):
    problem = _problem()
    opts = _options(loop, iterative)
    start = problem.state().copy()
    off = ctt.solve(opts, problem, device=device)
    x_off = problem.state().copy()
    problem.write_back(start)
    with obs.tracing():
        on = ctt.solve(opts, problem, device=device)
    return off, on, x_off, problem.state().copy()


def _runs(stamps) -> list:
    """The stamps' phase names cut at each ``end``."""
    runs, current = [], []
    for name, _ in stamps:
        current.append(name)
        if name == "end":
            runs.append(current)
            current = []
    assert not current
    return runs


# -- with the tracer off ---------------------------------------------------------------


def test_off_records_nothing_and_spans_are_the_shared_null_context():
    assert not obs.tracing_enabled()
    assert obs.span("a") is obs.span("b") is obs.solve_scope("solve")
    assert obs.take_records() is None
    obs.record_span("never", 0, 1)
    obs.phase("evaluate")  # no loop with a log runs: nothing happens
    problem = _problem()
    summary = ctt.solve(_options("fused"), problem, device="cpu")
    assert summary.spans is None
    program = problem.program("cpu")
    assert all(loop.log is None for loop in fused_lm.device_loops(program))
    assert obs.take_records() is None


@pytest.mark.parametrize("loop", ["fused", "host"])
def test_loops_keep_a_traced_and_an_untraced_copy(loop):
    """The loops' caches key on the tracer's state: a solve with it on makes
    (and keeps) its own loop with a device log, one with it off never sees
    it."""
    problem = _problem()
    opts = _options(loop)
    ctt.solve(opts, problem, device="cpu")
    with obs.tracing():
        ctt.solve(opts, problem, device="cpu")
    ctt.solve(opts, problem, device="cpu")
    program = problem.program("cpu")
    kept = (fused_lm.device_loops(program) if loop == "fused"
            else host_loop_graphs.host_loop_graph_sets(program))
    assert sorted(k.log is not None for k in kept) == [False, True]


# -- the same bits on and off ----------------------------------------------------------


@pytest.mark.parametrize("iterative", [False, True], ids=["dense_schur", "iterative_schur"])
@pytest.mark.parametrize("loop", ["fused", "host"])
def test_results_are_the_same_bits_on_and_off(loop, iterative):
    off, on, x_off, x_on = _solve_on_and_off(loop, iterative)
    assert off.spans is None and on.spans is not None
    assert off.final_cost == on.final_cost and off.num_iterations == on.num_iterations
    assert _records_key(off) == _records_key(on)
    assert np.array_equal(x_off, x_on)


# -- the records of a traced solve -----------------------------------------------------


@pytest.mark.parametrize("loop", ["fused", "host"])
def test_one_root_and_every_span_closed_and_nested(loop):
    _, on, _, _ = _solve_on_and_off(loop, False)
    trace = on.spans
    root = trace.root
    assert root.name == "solve" and root.parent_id is None and root.solve_id == root.span_id
    assert [s for s in trace.spans if s.parent_id is None] == [root]
    by_id = {s.span_id: s for s in trace.spans}
    assert len(by_id) == len(trace.spans)
    for s in trace.spans:
        assert s.solve_id == root.span_id and s.end_ns >= s.start_ns
        if s is not root:
            parent = by_id[s.parent_id]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (s, parent)
    names = {s.name for s in trace.spans}
    assert {"program", "initial_state", "x_to_host", "records", "write_back"} <= names
    if loop == "fused":
        assert {"prepare_loop", "fused.enqueue", "fused.read"} <= names
    else:
        assert {"minimizer_setup", "region.full", "region.iteration", "read.start",
                "read.iteration", "read.credit", "callback"} <= names
    # the device's stamps on the host clock lie inside the solve
    assert all(root.start_ns <= t <= root.end_ns for _, t in trace.stamps)
    assert trace.dropped_spans == trace.dropped_stamps == trace.calibration_width_ns == 0
    assert obs.take_records() is None  # the tracer is off again


def test_fused_loop_phases_come_in_its_order():
    _, on, _, _ = _solve_on_and_off("fused", True)
    runs = _runs(on.spans.stamps)
    T = on.num_iterations
    assert runs[0] == FUSED_START
    assert runs[1 : 1 + T] == [FUSED_ITERATION] * T
    # the replay that finds the loop stopped: its IF node's body does not run
    assert runs[1 + T :] == [SKIPPED_REPLAY]


def test_host_loop_phases_come_in_its_order():
    _, on, _, _ = _solve_on_and_off("host", True)
    runs = _runs(on.spans.stamps)
    assert runs[:2] == HOST_START
    accepted = sum(1 for r in on.iterations[1:] if r.step_is_successful)
    assert runs.count(HOST_ITERATION) == on.num_iterations
    assert runs.count(HOST_ACCEPT) <= accepted
    assert all(r in (HOST_ITERATION, HOST_ACCEPT) for r in runs[2:])
    # an accepted step's candidate becomes the current point before the next step
    for before, after in zip(runs[2:], runs[3:]):
        assert not (before == after == HOST_ACCEPT)


@pytest.mark.parametrize("iterative", [False, True], ids=["dense_schur", "iterative_schur"])
@pytest.mark.parametrize("loop", ["fused", "host"])
def test_one_linear_solve_an_lm_iteration(loop, iterative):
    _, on, _, _ = _solve_on_and_off(loop, iterative)
    counts = on.spans.phase_counts()
    assert on.num_iterations > 1
    assert counts["linear_solve"] == counts["candidate"] == on.num_iterations
    ms = on.spans.phase_ms()
    assert set(obs.LM_PHASES) <= set(ms) and all(v >= 0.0 for v in ms.values())


def test_fused_solve_is_a_root_of_its_own():
    problem = _problem()
    with obs.tracing():
        summary = ctt.fused_solve(_options("fused"), problem, device="cpu")
    trace = summary.spans
    assert trace.root.name == "fused_solve"
    assert trace.phase_counts()["linear_solve"] == summary.num_iterations
    assert trace.skipped_replays_ms() is not None


def test_nested_spans_outside_a_solve_are_kept_and_taken():
    obs.enable_tracing()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    records = obs.take_records()
    inner, outer = records["spans"]
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.solve_id is None and records["calibrations"] == {} == records["drift"]
    assert obs.take_records()["spans"] == []


def test_span_capacity_counts_what_it_drops():
    obs.enable_tracing(capacity=3)
    for k in range(5):
        with obs.span(f"s{k}"):
            pass
    records = obs.take_records()
    assert [s.name for s in records["spans"]] == ["s0", "s1", "s2"]
    assert records["dropped_spans"] == 2
    with obs.span("again"):  # taking the records made room
        pass
    assert [s.name for s in obs.take_records()["spans"]] == ["again"]


# -- the device log ---------------------------------------------------------------------


def test_an_overflowing_log_counts_its_drops_and_writes_nothing_past_capacity():
    log = cuda_graph.DeviceLog("cpu", 4)
    with obs.device_log(log):
        for name in ("replay", "evaluate", "assemble", "linear_solve", "candidate", "update",
                     "end"):
            obs.phase(name)
    assert int(log.cursor[0]) == 7 and log.issued == 7
    assert log.buf[:, 0].tolist() == [0, 3, 4, 5]
    host = torch.cat(log.read_parts()).numpy()
    assert host.shape == (2 * 4 + 1,)
    obs.enable_tracing()
    with obs.solve_scope("solve") as scope:
        log.deliver(host)
    trace = scope.trace
    assert [n for n, _ in trace.stamps] == ["replay", "evaluate", "assemble", "linear_solve"]
    assert trace.dropped_stamps == 3
    # an overflowed log gives no figures, never a partial one
    assert trace.intervals() is None and trace.phase_ms() is None
    assert trace.skipped_replays_ms() is None and trace.outside_device_ms() is None
    log.reset()
    assert int(log.cursor[0]) == 0 and log.issued == 0


def test_a_solve_whose_log_overflows_reports_no_device_figures(monkeypatch):
    monkeypatch.setattr(fused_lm, "_LOG_ROWS", 10)
    problem = _problem()
    with obs.tracing():
        summary = ctt.solve(_options("fused"), problem, device="cpu")
    trace = summary.spans
    assert len(trace.stamps) == 10 and trace.dropped_stamps > 0
    assert trace.phase_ms() is None and trace.outside_device_ms() is None


def test_phase_outside_a_loop_stamps_nothing():
    log = cuda_graph.DeviceLog("cpu", 4)
    obs.phase("evaluate")
    with obs.device_log(log):
        with obs.device_log(None):  # the shared null context: the outer log stays
            obs.phase("evaluate")
    obs.phase("evaluate")
    assert int(log.cursor[0]) == 1


# -- EventLogger and ScopedExecutionTimer -----------------------------------------------


def test_event_logger_and_timer_phases_are_spans():
    obs.enable_tracing()
    log = obs.EventLogger("Solver::Solve")
    es = obs.ExecutionSummary()
    with obs.ScopedExecutionTimer("Evaluator::Residual", es):
        pass
    log.add_event("Preprocess")
    log.finish()
    spans = {s.name: s for s in obs.take_records()["spans"]}
    assert set(spans) == {"Evaluator::Residual", "Solver::Solve:Preprocess",
                          "Solver::Solve:total"}
    timed = spans["Evaluator::Residual"]
    # one record of host time: the timer's seconds are its span's
    assert es.times["Evaluator::Residual"] == (timed.end_ns - timed.start_ns) * 1e-9
    pre, total = spans["Solver::Solve:Preprocess"], spans["Solver::Solve:total"]
    assert pre.end_ns == total.start_ns
    assert log.events[0][1] == (pre.end_ns - pre.start_ns) * 1e-9
    assert pre.start_ns <= timed.start_ns <= timed.end_ns <= pre.end_ns


def test_a_host_loop_solve_holds_its_evaluator_spans():
    _, on, _, _ = _solve_on_and_off("host", False)
    names = [s.name for s in on.spans.spans]
    assert "Solver::Solve:Preprocess" in names and "Solver::Solve:Minimize" in names
    assert names.count("Evaluator::Jacobian") == on.evaluator_statistics.calls[
        "Evaluator::Jacobian"]


def test_spans_enter_the_profiler_as_ceres_functions():
    from torch.profiler import ProfilerActivity, profile

    problem = _problem()
    # the card's activities too where there is one: a process whose first
    # profiler left CUDA out records no kernel in a later one
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    with obs.tracing():
        with profile(activities=activities) as prof:
            summary = ctt.solve(_options("fused"), problem, device="cpu")
    profiled = [e.name for e in prof.events() if e.name.startswith("ceres.")]
    ours = ["ceres." + s.name for s in summary.spans.spans
            if not s.name.startswith("Solver::Solve:")]  # those are recorded after the fact
    assert sorted(profiled) == sorted(ours)


# -- a SolveTrace's figures, on stamps made by hand ----------------------------------------


def _trace(stamps, root=(0, 100_000_000), **kw):
    root_span = obs.Span("solve", root[0], root[1], 1, None, 1)
    return obs.SolveTrace([root_span], stamps, **kw)


def test_solve_trace_figures():
    ms = 1_000_000
    stamps = [("replay", 10 * ms), ("evaluate", 11 * ms), ("update", 14 * ms), ("end", 15 * ms),
              ("replay", 20 * ms), ("evaluate", 21 * ms), ("assemble", 23 * ms),
              ("linear_solve", 26 * ms), ("candidate", 30 * ms), ("update", 31 * ms),
              ("end", 32 * ms),
              ("replay", 40 * ms), ("end", 40 * ms + ms // 2),
              ("replay", 41 * ms), ("end", 42 * ms)]
    trace = _trace(stamps)
    assert trace.phase_ms() == pytest.approx({"replay": 3.5, "evaluate": 5.0, "update": 2.0,
                                              "assemble": 3.0, "linear_solve": 4.0,
                                              "candidate": 1.0})
    assert trace.skipped_replays_ms() == pytest.approx(1.5)
    # 100 ms of root, 5 + 12 + 0.5 + 1 ms covered
    assert trace.outside_device_ms() == pytest.approx(100 - 18.5)
    assert trace.phase_counts() == {"replay": 4, "evaluate": 2, "update": 2, "assemble": 1,
                                    "linear_solve": 1, "candidate": 1}


def test_solve_trace_clips_intervals_to_the_root_and_merges_overlaps():
    ms = 1_000_000
    stamps = [("region", -5 * ms), ("evaluate", -4 * ms), ("end", 5 * ms),
              ("region", 3 * ms), ("update", 4 * ms), ("end", 8 * ms),
              ("region", 95 * ms), ("assemble", 96 * ms), ("end", 120 * ms)]
    trace = _trace(stamps)
    assert trace.outside_device_ms() == pytest.approx(100 - 8 - 5)
    assert trace.skipped_replays_ms() is None  # no fused-loop replay: nothing to read


@pytest.mark.parametrize("stamps", [
    [],
    [("evaluate", 1), ("end", 2)],  # a phase before any replay
    [("replay", 1), ("evaluate", 2)],  # a replay never ended
    [("replay", 1), ("region", 2), ("end", 3)],  # a replay inside another
], ids=["none", "no_begin", "no_end", "nested"])
def test_incomplete_stamps_give_no_figures(stamps):
    trace = _trace(stamps)
    assert trace.intervals() is None and trace.phase_ms() is None
    assert trace.phase_counts() is None and trace.outside_device_ms() is None
    assert trace.skipped_replays_ms() is None


def test_dropped_stamps_give_no_figures():
    trace = _trace([("replay", 1), ("end", 2)], dropped_stamps=1)
    assert trace.intervals() is None and trace.skipped_replays_ms() is None


def test_calibration_is_none_on_the_cpu():
    obs.enable_tracing()
    assert obs.calibrate("cpu") is None
    obs.ensure_calibrated("cpu")
    assert "cpu" not in obs.take_records()["calibrations"]


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamp kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _card_case(loop: str):
    """The 4400-observation BAL of the card's captured-loop tests
    (deterministic reductions), ITERATIVE_SCHUR + SCHUR_JACOBI."""
    inst = bal.synthesize_bal(num_cameras=4, num_points=1100, num_observations=4400, seed=42)
    problem = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))[0]
    return problem, _options(loop, iterative=True)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["fused", "host"])
def test_captured_loops_give_the_same_bits_and_reads_on_and_off(device, loop):
    """Captured (and captured again with the stamps), the solves equal each
    other to the bit, and a repeat solve reads the host as often with the
    tracer on as off: the log is read with the reads the loop makes."""
    from ceres_tpu_torch.tools.profile_solve import _host_reads

    problem, opts = _card_case(loop)
    start = problem.state().copy()
    runs = {}
    for traced in (False, True):
        if traced:
            obs.enable_tracing()
        problem.write_back(start)
        first = ctt.solve(opts, problem, device=device)
        problem.write_back(start)
        repeat, reads = _host_reads(lambda: ctt.solve(opts, problem, device=device))
        runs[traced] = (first, repeat, reads, problem.state().copy())
    (off, off_again, off_reads, x_off), (on, on_again, on_reads, x_on) = runs[False], runs[True]
    assert off.captured_loop and on.captured_loop
    assert on.graph_capture_time_in_seconds > 0.0 == on_again.graph_capture_time_in_seconds
    for s in (off_again, on, on_again):
        assert s.final_cost == off.final_cost and _records_key(s) == _records_key(off)
    assert np.array_equal(x_on, x_off)
    assert sum(on_reads.values()) == sum(off_reads.values()), (dict(on_reads), dict(off_reads))
    trace = on_again.spans
    assert trace.dropped_stamps == 0 and 0 < trace.calibration_width_ns < 10_000_000
    counts = trace.phase_counts()
    assert counts["linear_solve"] == on_again.num_iterations
    root = trace.root
    assert all(root.start_ns - 1_000_000 <= t <= root.end_ns + 1_000_000
               for _, t in trace.stamps)
    if loop == "fused":
        assert trace.skipped_replays_ms() > 0.0
        assert _runs(trace.stamps)[-1] == SKIPPED_REPLAY
    assert 0.0 < trace.outside_device_ms() < (root.end_ns - root.start_ns) * 1e-6
    records = obs.disable_tracing()
    drift, elapsed = records["drift"][str(device)]
    assert elapsed > 0 and abs(drift) < 1e-3 * elapsed + 1_000_000


# The kernels of csrc/outer_segment_sum.cu (K4), as the profiler names them.
K4_KERNEL = re.compile(r"\b(tiled_kernel|general_kernel)<")


def _k4_in_assemble() -> dict:
    """A DENSE_SCHUR solve whose S assembly runs K4, captured with the
    stamps and then solved again under ``torch.profiler``: K4's kernel time
    and the part of it inside ``assemble`` intervals, the profiler's clock
    mapped onto the tracer's by the ``ceres.*`` spans both hold (their
    starts, in order, name by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ceres_tpu_torch.ops import outer_segment_sum

    inst = bal.synthesize_bal(num_cameras=300, num_points=8000, num_observations=48000,
                              noise=2.0, perturb=0.7, seed=5)
    problem = bal.build_problem(inst)[0]
    opts = bal.default_options(iterative=False)
    opts.max_num_iterations = 6
    start = problem.state().copy()
    obs.enable_tracing()
    ctt.solve(opts, problem, device="cuda")  # set-up: the capture, with the stamps
    problem.write_back(start)
    torch.cuda.synchronize()
    launches = outer_segment_sum.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        summary = ctt.solve(opts, problem, device="cuda")
        torch.cuda.synchronize()
    trace = summary.spans
    events = list(prof.events())
    ours, theirs = {}, {}
    for s in trace.spans:
        ours.setdefault("ceres." + s.name, []).append(s.start_ns)
    for e in events:
        if e.name in ours and e.device_type == DeviceType.CPU:
            theirs.setdefault(e.name, []).append(e.time_range.start)
    offsets = [t - 1e3 * p for name in theirs
               for t, p in zip(sorted(ours[name]), sorted(theirs[name]))]
    offset = float(np.median(offsets))
    k4 = [(1e3 * e.time_range.start + offset, 1e3 * e.time_range.end + offset)
          for e in events if e.device_type == DeviceType.CUDA and K4_KERNEL.search(e.name)]
    assemble = [(a, b) for _, _, _, phases in trace.intervals()
                for name, a, b in phases if name == "assemble"]
    return {"launches": outer_segment_sum.launches - launches, "calls": len(k4),
            "offsets": len(offsets), "offset_spread_ns": max(offsets) - min(offsets),
            "total_ns": sum(b - a for a, b in k4),
            "inside_ns": sum(max(0.0, min(b, hi) - max(a, lo))
                             for a, b in k4 for lo, hi in assemble),
            "calibration_width_ns": trace.calibration_width_ns}


@pytest.mark.cuda
def test_k4_runs_inside_the_assemble_phases(device):
    """In a profiled DENSE_SCHUR solve whose S assembly runs K4, at least 95%
    of K4's kernel time lies inside ``assemble`` intervals once both are on
    the tracer's clock. Profiled in a process of its own: in one that had
    run a profiler before, the card's later profile lacked the kernels
    inside conditional nodes' bodies (torch 2.11 on the H100)."""
    code = ("import importlib.util as u, json; "
            f"s = u.spec_from_file_location('tracing_case', {__file__!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "print(json.dumps(m._k4_in_assemble()))")
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["launches"] > 0 and r["calls"] > 0, r  # K4 ran, and the profiler saw it
    assert r["offsets"] >= 5 and r["offset_spread_ns"] < 1e6, r  # the clocks agree to 1 ms
    assert r["inside_ns"] >= 0.95 * r["total_ns"], r
