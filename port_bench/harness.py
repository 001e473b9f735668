"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by name under the benchmark's root:

- ``BENCHMARK.json``: the cells, the configurations' files, the metrics;
- ``port_bench/configs/<config>.json``: the scene's counts, its pixel
  noise and its ``scene_seed`` (one fixed scene, as a BAL file is one
  problem), its ``solver_options`` (``SolverOptions`` fields; enum values by
  name), its ``dtype`` and the ``limits`` of the check;
- ``port_bench/traffic/<mix>.json``: the starts' perturbation and whether
  every solve carries an iteration callback;
- ``port_bench/metrics/<metric>.py``: ``read(records) -> float | None``.

The window is a closed loop with one caller, as a structure-from-motion or
SLAM back end waits on its solver: each request draws a start from (seed,
request), the seed of the run, writes it into the problem (``Problem.write_back``: the program
and its CUDA graphs stay), solves with ``ceres_tpu_torch.solve`` and reads
the solution back (``Problem.state``).
"""

from __future__ import annotations

import dataclasses
import enum
import gc
import importlib.util
import json
import sys
import time
import typing
from pathlib import Path

import numpy as np
import torch

from port_bench import scene as scenes
from port_bench import yardstick
from port_bench.check import judge

ROOT = Path(__file__).resolve().parent.parent
HARNESS_DIR = "port_bench"
# The set-up solves until one captures no graph: the first captures the
# fused loop or the host loop's regions, a later one those of branches the
# first did not take.
MAX_SETUP_SOLVES = 3
# A traced run profiles the window's last seconds, at most these: reading the
# profiler's events takes seconds for every second traced.
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "ceres_tpu")


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / HARNESS_DIR / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: the end-to-end ones
        with ``trace`` off, the per-layer ones with it on."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """``read`` of ``port_bench/metrics/<metric>.py``."""
        path = self.root / HARNESS_DIR / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def solver_options(config: dict, traffic: dict, evaluation_dtype=None, callbacks=()):
    """``SolverOptions`` of the configuration, enum fields given by member
    name; the configuration's dtype, or ``evaluation_dtype`` in its place."""
    from ceres_tpu_torch.solver import SolverOptions

    hints = typing.get_type_hints(SolverOptions)
    fields = {}
    for key, value in config["solver_options"].items():
        kind = hints[key]
        for arg in typing.get_args(kind) or (kind,):
            if isinstance(arg, type) and issubclass(arg, enum.Enum):
                value = arg[value]
                break
        fields[key] = value
    dtype = evaluation_dtype or config["dtype"]
    fields["evaluation_dtype"] = None if dtype == "float64" else dtype
    fields["callbacks"] = list(callbacks)
    return SolverOptions(**fields)


class CostRecorder:
    """The mixes' iteration callback: keeps each iteration's cost and lets
    the solve go on."""

    def __init__(self):
        self.costs = []

    def __call__(self, iteration):
        from ceres_tpu_torch.types import CallbackReturnType

        self.costs.append(iteration.cost)
        return CallbackReturnType.SOLVER_CONTINUE


@dataclasses.dataclass
class Solve:
    """One request: the summary's counts and times, and (traced runs) its
    host reads from ``write_back`` to ``state``."""

    iterations: int
    linear_iterations: int
    minimizer_s: float
    capture_s: float
    final_cost: float
    termination: str
    usable: bool
    host_reads: typing.Optional[int] = None


def _record(summary, host_reads=None) -> Solve:
    return Solve(iterations=summary.num_iterations,
                 linear_iterations=summary.num_linear_solver_iterations,
                 minimizer_s=summary.minimizer_time_in_seconds,
                 capture_s=summary.graph_capture_time_in_seconds,
                 final_cost=summary.final_cost,
                 termination=summary.termination_type.name,
                 usable=summary.is_solution_usable(), host_reads=host_reads)


def solve_seconds(ends, seconds: float):
    """The window's seconds a solve: from its start to the end of the last
    solve completed in it, over the solves completed in it (``ends``:
    seconds from the window's start to each solve's end, in order)."""
    done = [e for e in ends if e <= seconds]
    return done[-1] / len(done) if done else None


def _build_kernels() -> None:
    """The port's CUDA kernels and its graph library, built (or loaded from
    ``ceres_tpu_torch/_build/``) at once, one nvcc each."""
    from ceres_tpu_torch.ops import cuda_build, outer_segment_sum, segment_sum, unsorted_segment_sum
    from ceres_tpu_torch.utils import cuda_graph

    cuda_build.build_in_parallel([segment_sum.build_kernel, unsorted_segment_sum.build_kernel,
                                  outer_segment_sum.build_kernel, cuda_graph.build_library])


def _span(name: str):
    return torch.profiler.record_function(f"port_bench.{name}")


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, evaluation_dtype=None, log=print) -> dict:
    """Run ``workload`` once and return its result (the line's keys, then
    ``checks``). ``t0``: the process's start on ``time.perf_counter``.
    ``evaluation_dtype`` replaces the configuration's (the control)."""
    import ceres_tpu_torch
    from ceres_tpu_torch.models import bal

    cell = bench.workload(workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        _build_kernels()

    # -- set-up: the scene, the Problem, the solves that capture ------------
    sc = scenes.make_scene(config["num_cameras"], config["num_points"],
                           config["num_observations"], config["pixel_noise"],
                           config["scene_seed"], device)
    sigma = (traffic["points_sigma"], traffic["translation_sigma"])
    setup_starts = scenes.Starts(sc, *sigma, seed, device, stream=scenes.Starts.SETUP,
                                 batch=MAX_SETUP_SOLVES)
    first = setup_starts[0]
    C = sc.num_cameras
    problem, _, _ = bal.build_problem(bal.BALProblem(
        first[: 9 * C].reshape(C, 9), first[9 * C:].reshape(-1, 3),
        sc.camera_index, sc.point_index, sc.observations))
    recorder = CostRecorder()
    options = solver_options(config, traffic, evaluation_dtype,
                             [recorder] if traffic["iteration_callback"] else [])
    setup_solves = []
    for k in range(MAX_SETUP_SOLVES):
        if k:
            problem.write_back(setup_starts[k])
        summary = ceres_tpu_torch.solve(options, problem, device=device)
        setup_solves.append(summary)
        if summary.graph_capture_time_in_seconds == 0.0:
            break
    if on_card:
        torch.cuda.synchronize()

    # -- the window -----------------------------------------------------------
    # Traced: the window counts the host reads (the solves' counters are read
    # there) until its last half or last TRACE_SECONDS, which run under the
    # profiler (the device's).
    starts = scenes.Starts(sc, *sigma, seed, device)
    solves, states, ends = [], [], []
    tracing = trace and on_card
    reads = yardstick.HostReads().__enter__() if tracing else None
    tracer = None
    traced_from = seconds - min(seconds / 2, TRACE_SECONDS)
    window_start = time.perf_counter()
    setup_s = window_start - t0
    counted = None  # solves in the counted part, traced runs
    k = 0
    while time.perf_counter() - window_start < seconds:
        if tracing and tracer is None and time.perf_counter() - window_start >= traced_from:
            reads.__exit__(None, None, None)
            reads, counted = None, len(solves)
            from port_bench.trace import DeviceTracer

            tracer = DeviceTracer().__enter__()
        with _span("start"):
            start = starts[k]
        recorder.costs.clear()
        if reads is not None:
            reads.take()
        with _span("write_back"):
            problem.write_back(start)
        with _span("solve"):
            summary = ceres_tpu_torch.solve(options, problem, device=device)
        with _span("state"):
            x = problem.state()
        ends.append(time.perf_counter() - window_start)
        solves.append(_record(summary, reads.take() if reads is not None else None))
        states.append(x)
        k += 1
    if reads is not None:
        reads.__exit__(None, None, None)
    device_trace = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        device_trace = tracer.read()

    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    captured_in_window = sum(1 for s in solves if s.capture_s > 0.0)
    # The program's state goes before the reference runs.
    del problem, options, summary
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------------
    t_check = time.perf_counter()
    checks = judge(sc, solves, states, config["limits"], seed, device)
    check_s = time.perf_counter() - t_check
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    in_window = sum(1 for e in ends if e <= seconds)
    window, traced = solves[:in_window], []
    if counted is not None:  # traced: the counted part, and the traced part
        window, traced = solves[:counted], solves[counted:]
    records = {
        "setup": {"preprocess_s": setup_solves[0].preprocessor_time_in_seconds,
                  "capture_s": setup_solves[0].graph_capture_time_in_seconds},
        "solves": window,
        "trace": device_trace, "traced": traced,
        "scene": sc, "element_bytes": 8 if (evaluation_dtype or config["dtype"]) == "float64" else 4,
    }
    metrics = {}
    for m in bench.metrics(workload, trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "solve_s":
            value = solve_seconds(ends, seconds)
        else:
            value = bench.reader(m["name"])(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(solves),
              "failed": sum(1 for s in solves if not s.usable), "metrics": metrics}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if device_trace is not None:
        dev.update(busy_s=device_trace.busy_s, window_s=device_trace.window_s)
    result["device"] = dev
    if device_trace is not None:
        result["breakdown"] = device_trace.breakdown()
    log(f"setup solves {len(setup_solves)}, capture s {[s.graph_capture_time_in_seconds for s in setup_solves]}; "
        f"window solves {in_window} of {len(solves)}, iterations "
        f"{sum(s.iterations for s in window)}, solves that captured in the window "
        f"{captured_in_window}, terminations "
        f"{sorted({s.termination for s in solves})}; setup s {setup_s:.3f}, check s {check_s:.3f}")
    if device_trace is not None:
        log(f"traced solves {len(traced)}, iterations {sum(s.iterations for s in traced)}; "
            f"device busy s {device_trace.busy_s!r} of {device_trace.window_s!r}, outside "
            f"port_bench.start {device_trace.busy_s_outside('port_bench.start')!r}")
    result["checks"] = checks
    return result
