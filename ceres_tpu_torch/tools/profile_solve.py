"""Where the time of one solve goes on the card.

    python3 -m ceres_tpu_torch.tools.profile_solve [CASE] [float32|float64]...

For each dtype (default: both), on the named case (default: large: 464
cameras / 200 000 points / 1 200 000 observations, DENSE_SCHUR;
large_iterative: the same at ``bal.default_options(iterative=True)``,
ITERATIVE_SCHUR + SCHUR_JACOBI on the implicit S; flagship: 16 / 22106 /
83718, ITERATIVE_SCHUR; robust_large and robust_flagship: the large and
flagship cases with HuberLoss(1.0); pose_graph: the 2500-pose sphere, CGNR +
block Jacobi, cut to its first 6 LM iterations because the whole solve runs
tens of thousands of CG iterations; host_loop_large: the large case through
``ctt.solve`` with progress output and an iteration callback, i.e. the
host-loop minimizer's fused iteration), after a 2-iteration warm-up solve.
``ctt.fused_solve`` runs the fused loop as CUDA graphs where
``fused_lm.captured_loop_eligible`` says so, and ``ctt.solve`` the host
loop's device work where ``fused_lm.host_loop_capturable`` does; the same
loop run eagerly (``eager_loop``, ``eager_host_loop``: every ``run_if``
reads its predicate, one host read per LM and per CG iteration) is
measured beside it:

1. ``stages``: one eager loop with every stage bracketed by
   ``torch.cuda.synchronize()`` and timed on the host clock, so a stage's
   seconds hold its host work and its device work (a captured loop runs
   its stages inside the graph, where nothing can be bracketed). Stages
   nest: the kernels' wrappers (K1, K3, K4) are inside the evaluation and
   the S assembly or the S x products, S x and the preconditioner's
   applications inside CG, and all are listed on their own. The
   synchronizing makes this loop slower than a plain one; the plain
   solve's loop seconds (captured), the eager loop's, the synchronized
   ones and the seconds per CG iteration of each are printed.
   host_loop_large's stages are those of ``eager_host_loop``.
2. ``device``: one plain solve under ``torch.profiler``, and the eager
   loop under it, on a problem whose host set-up (program, plans, copies to
   the card, the graphs' capture) was done beforehand by a 0-iteration
   solve: the device's busy time (union of its kernels' intervals), its
   idle share of the LM loop, the number of device operations, and the ten
   kernels with the most time; and each loop's seconds between two CUDA
   events (``loop_device_seconds_cuda_events``), which holds where the
   profiler sees no kernel of a graph's replay.
3. ``host_reads``: the host reads of one plain solve and of the eager loop
   on a problem set up beforehand, as for ``device`` (every operation that
   waits for the device, as ``torch.cuda.set_sync_debug_mode`` reports
   them: reads, and copies from the host, which wait too), in all and per
   LM iteration, by the line of the port that made them, and the device
   operations per LM iteration; for host_loop_large also the speculative
   evaluations the rejected steps wasted, with their seconds (the full
   evaluation's synchronized time per call, from ``stages``).

One JSON line per result on standard output, each with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
import time
import warnings

import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import (
    evaluator,
    fused_lm,
    gradient_problem,
    host_loop_graphs,
    line_search,
    trust_region,
)
from ceres_tpu_torch.linear import cgnr, schur, schur_explicit
from ceres_tpu_torch.models import bal, pose_graph
from ceres_tpu_torch.ops import reduce
from ceres_tpu_torch.solver import initial_state, preprocess, summarize_records

_LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7)
_FLAGSHIP = dict(num_cameras=16, num_points=22106, num_observations=83718, seed=16)
# case -> (BAL sizes or None for the pose graph, ITERATIVE_SCHUR?, Huber
# loss?, the model's default function tolerance (else 1e-9 for an
# iterative solve, as chip_smoke.py's flagship)?)
CASES = {
    "large": (_LARGE, False, False, False),
    "large_iterative": (_LARGE, True, False, True),
    "flagship": (_FLAGSHIP, True, False, False),
    "robust_large": (_LARGE, False, True, True),
    "robust_flagship": (_FLAGSHIP, True, True, True),
    "pose_graph": (None, None, False, True),
    "host_loop_large": (_LARGE, False, False, False),
}
POSE_GRAPH_LM_ITERATIONS = 6


class _Stages:
    """Synchronized host-clock timers patched over the stage functions."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._undo = []

    def _timed(self, fn, label):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out

        return timed

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)
        setattr(owner, attr, self._timed(fn, label))
        self._undo.append((owner, attr, fn))

    def wrap_returned(self, owner, attr, label):
        """Time the calls of the function that ``owner.attr`` returns."""
        make = getattr(owner, attr)
        setattr(owner, attr, lambda *a, **k: self._timed(make(*a, **k), label))
        self._undo.append((owner, attr, make))

    def __enter__(self):
        # the evaluations' call sites: the fused loop, the host loop's fused
        # iteration and candidate, and the Evaluator
        for mod in (fused_lm, trust_region, evaluator, host_loop_graphs):
            self.wrap(mod, "_full_impl", "full evaluation (residuals, Jacobians, gradient)")
            self.wrap(mod, "_cost_impl", "cost-only evaluation")
        self.wrap(trust_region, "_linear_solve", "linear solve")
        self.wrap(schur.SchurOperator, "rhs", "- reduced rhs")
        self.wrap(schur.SchurOperator, "back_substitute", "- back substitution")
        self.wrap(schur.SchurOperator, "s_times", "- S x (implicit, inside CG)")
        self.wrap(schur.SchurOperator, "schur_jacobi_blocks", "- SCHUR_JACOBI blocks (implicit)")
        self.wrap_returned(schur.SchurOperator, "_block_diag_apply",
                           "- preconditioner applications (inside CG)")
        self.wrap(schur, "SchurOperator", "- point blocks (E'E+D^2)^-1")
        self.wrap(schur, "assemble_reduced_system", "- S assembly")
        self.wrap(torch.linalg, "cholesky_ex", "- Cholesky factorization of S")
        self.wrap(torch, "cholesky_solve", "- Cholesky solve")
        self.wrap(schur, "conjugate_gradients", "- CG")
        self.wrap(cgnr, "conjugate_gradients", "- CG on the normal equations")
        self.wrap(reduce, "segment_sum_sorted", "K1 launches (all sites)")
        self.wrap(reduce, "segment_sum_unsorted", "K3 launches (all sites)")
        self.wrap(schur_explicit, "outer_segment_sum", "K4 launches")
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)


def _options(dtype, iterative, max_iters=50):
    opts = bal.default_options(iterative=iterative)
    opts.max_num_iterations = max_iters
    if iterative:
        opts.function_tolerance = 1e-9
    opts.evaluation_dtype = dtype
    return opts


def _device_profile(run):
    """(summary, busy seconds, device operations, top kernels) of run()
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        summary = run()
        torch.cuda.synchronize()
    spans, by_name = [], collections.defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] += (ev.time_range.end - ev.time_range.start) * 1e-6
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return summary, busy * 1e-6, len(spans), top


def eager_loop(problem, opts, device="cuda", revert_on_tolerance: bool = True):
    """The fused loop of ``ctt.solve`` (revert_on_tolerance, with its trace)
    or of ``ctt.fused_solve`` (without), on the problem's program and the
    options, run eagerly (``fused_lm._device_loop`` with captured=False:
    every run_if reads its predicate), its summary filled by the functions
    that solve fills its own with: a captured solve's baseline (it writes
    nothing back; its final x is the loop's ``state.x``). Returns (the
    summary, the loop's seconds)."""
    summary = ctt.SolverSummary()
    program, resolved = preprocess(opts, problem, device, summary)
    x0 = initial_state(program, opts.mesh)
    loop = fused_lm._device_loop(program, trust_region._build_solve_aux(resolved, program),
                                 fused_lm._fused_config(resolved, revert_on_tolerance),
                                 revert_on_tolerance, False, x0)
    if program.device.type == "cuda":
        torch.cuda.synchronize(program.device)
    t0 = time.perf_counter()
    if revert_on_tolerance:
        fused_lm.minimize_fused_traced(resolved, loop, x0, summary)
        summarize_records(summary)
    else:
        loop.run(x0, resolved.max_num_iterations)
        final, _ = loop.read(resolved.max_num_iterations)
        fused_lm.summarize_final_state(summary, final, program.fixed_cost)
    seconds = time.perf_counter() - t0
    summary.minimizer_time_in_seconds = seconds
    return summary, seconds


def eager_host_loop(problem, opts, device="cuda"):
    """``ctt.solve``'s host loop (``trust_region.TrustRegionMinimizer``, for
    options ``fused_lm.fused_traced_eligible`` refuses, or with
    ``minimizer_type`` LINE_SEARCH ``line_search.LineSearchMinimizer``) on
    the problem's program and the options, its regions run eagerly (no
    graph; every run_if reads its predicate), its summary filled as
    ``solve`` fills its own and the solution written back: a captured host
    loop's or line search's baseline. Returns (the summary, the loop's
    seconds)."""
    summary = ctt.SolverSummary()
    program, resolved = preprocess(opts, problem, device, summary)
    x0 = initial_state(program, opts.mesh)
    if program.device.type == "cuda":
        torch.cuda.synchronize(program.device)
    t0 = time.perf_counter()  # as solve's minimizer time: the minimizer's set-up too
    if resolved.minimizer_type == ctt.MinimizerType.LINE_SEARCH:
        minimizer = line_search.LineSearchMinimizer(program, resolved, summary, captured=False)
    else:
        minimizer = trust_region.TrustRegionMinimizer(program, resolved, summary, captured=False)
    x = minimizer.minimize(x0).to(torch.float64).cpu().numpy()
    seconds = time.perf_counter() - t0
    summary.minimizer_time_in_seconds = seconds
    summarize_records(summary)
    if summary.is_solution_usable():
        problem.write_back(x)
    return summary, seconds


def eager_gradient_problem(options, problem, parameters, device="cuda"):
    """``ctt.solve_gradient_problem`` with its regions run eagerly: a
    captured GradientProblem solve's baseline. Returns the summary."""
    return gradient_problem._solve(options, problem, parameters, device, captured=False)


def _event_seconds(run):
    """(run(), the device's seconds between a CUDA event before it and one
    after it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) * 1e-3


def _host_reads(run):
    """(run(), {"file:line": count}) of the operations in run() that waited
    for the device, as torch.cuda.set_sync_debug_mode("warn") reports them
    (it names the Python line that made each)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message)
    )


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    case = argv[0] if argv else "large"
    dtypes = argv[1:] or ["float32", "float64"]
    sizes, iterative, robust, default_tolerance = CASES[case]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(**fields):
        print(json.dumps({"case": case, **fields, "card": smi}), flush=True)

    if sizes is None:
        graph = pose_graph.synthesize_sphere(2500, seed=0)[:3]
        full = POSE_GRAPH_LM_ITERATIONS

        def build():
            return pose_graph.build_problem_3d(*graph)[0]

        def options(dtype, max_iters):
            opts = pose_graph.default_options()
            opts.max_num_iterations = max_iters
            opts.evaluation_dtype = dtype
            return opts
    else:
        inst = bal.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
        full = 50

        def build():
            return bal.build_problem(inst, loss=ctt.HuberLoss(1.0) if robust else None)[0]

        def options(dtype, max_iters):
            opts = _options(dtype, iterative, max_iters)
            if default_tolerance:
                opts.function_tolerance = 1e-6  # the model's default
            return opts

    host_loop = case == "host_loop_large"

    def host_options(dtype, max_iters):
        opts = options(dtype, max_iters)
        opts.minimizer_progress_to_stdout = True
        opts.callbacks = [lambda it: ctt.CallbackReturnType.SOLVER_CONTINUE]
        return opts

    def solve(dtype, max_iters=None, problem=None):
        if problem is None:
            problem = build()
        max_iters = full if max_iters is None else max_iters
        if not host_loop:
            return ctt.fused_solve(options(dtype, max_iters), problem)
        with contextlib.redirect_stdout(io.StringIO()):
            return ctt.solve(host_options(dtype, max_iters), problem)

    def eager(dtype, problem):
        if host_loop:
            with contextlib.redirect_stdout(io.StringIO()):
                return eager_host_loop(problem, host_options(dtype, full))[0]
        return eager_loop(problem, options(dtype, full), revert_on_tolerance=False)[0]

    def prepared(dtype, run):
        """run on a problem set up (and captured) beforehand, from its
        start every time (a solve writes its solution back)."""
        problem = build()
        start = problem.state().copy()
        # set-up and capture, kept with the problem (the host loop captures
        # its regions at their first call: two iterations meet them)
        solve(dtype, max_iters=2 if host_loop else 0, problem=problem)

        def from_start():
            problem.write_back(start)
            return run(problem)

        return from_start

    for dtype in dtypes:
        solve(dtype, max_iters=2)
        plain = solve(dtype)
        problem = build()
        eager_plain = eager(dtype, problem)
        with _Stages() as stages:
            timed = eager(dtype, build())
        emit(
            result="stages", dtype=dtype, lm_iterations=timed.num_iterations,
            linear_solver_iterations=timed.num_linear_solver_iterations,
            final_cost=timed.final_cost, captured=plain.captured_loop,
            loop_seconds_plain=plain.minimizer_time_in_seconds,
            loop_seconds_eager=eager_plain.minimizer_time_in_seconds,
            loop_seconds_synchronized=timed.minimizer_time_in_seconds,
            seconds_per_cg_iteration_plain=plain.minimizer_time_in_seconds
            / max(plain.num_linear_solver_iterations, 1),
            seconds_per_cg_iteration_eager=eager_plain.minimizer_time_in_seconds
            / max(eager_plain.num_linear_solver_iterations, 1),
            seconds_per_cg_iteration_synchronized=timed.minimizer_time_in_seconds
            / max(timed.num_linear_solver_iterations, 1),
            setup_seconds=plain.preprocessor_time_in_seconds,
            capture_seconds=plain.graph_capture_time_in_seconds,
            stages={k: {"seconds": v, "calls": stages.calls[k]} for k, v in stages.seconds.items()},
        )
        loops = {"plain": lambda p: solve(dtype, problem=p), "eager": lambda p: eager(dtype, p)}
        for name, run in loops.items():
            again = prepared(dtype, run)
            summary, busy, ops, top = _device_profile(again)
            _, event_seconds = _event_seconds(again)
            loop = summary.minimizer_time_in_seconds
            emit(
                result="device", dtype=dtype, loop=name, captured=name == "plain",
                lm_iterations=summary.num_iterations,
                linear_solver_iterations=summary.num_linear_solver_iterations,
                loop_seconds_profiled=loop, device_busy_seconds=busy,
                device_idle_share_of_loop=(1.0 - busy / loop) if busy else None,
                device_operations=ops,
                device_operations_per_lm_iteration=ops / max(summary.num_iterations, 1),
                loop_device_seconds_cuda_events=event_seconds,
                top_kernels=[{"name": n[:80], "seconds": s} for n, s in top],
            )
        for name, run in loops.items():
            summary, reads = _host_reads(prepared(dtype, run))
            n = max(summary.num_iterations, 1)
            fields = {}
            if host_loop:
                wasted = sum(1 for r in summary.iterations[1:]
                             if r.step_is_valid and not r.step_is_successful)
                label = "full evaluation (residuals, Jacobians, gradient)"
                per_eval = stages.seconds[label] / max(stages.calls[label], 1)
                fields = dict(
                    records=len(summary.iterations), rejected_steps=summary.num_unsuccessful_steps,
                    wasted_speculative_evaluations=wasted,
                    full_evaluation_seconds_synchronized=per_eval, wasted_seconds=wasted * per_eval,
                )
            emit(
                result="host_reads", dtype=dtype, loop=name, lm_iterations=summary.num_iterations,
                linear_solver_iterations=summary.num_linear_solver_iterations,
                host_reads=sum(reads.values()),
                host_reads_per_lm_iteration=sum(reads.values()) / n,
                host_reads_by_site=dict(reads.most_common(12)),
                loop_seconds=summary.minimizer_time_in_seconds, **fields,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
