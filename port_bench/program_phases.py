"""A cell run as ``port_bench.run`` runs it, with the program's tracer on from
before the set-up (``ceres_tpu_torch.utils.observability``), and the phase
figures of the window's solves read from their ``SolverSummary.spans``.

    python3 -m port_bench.program_phases --workload <name> --seed <n> --seconds <s> [--trace 1]

From the root of a checkout whose program has the tracer, on a machine with a
CUDA card. With ``--trace 0`` (the default) the run is untraced (no
profiler, no host-read counting), so each solve's records are the
program's alone, and the last line of standard output is the run's result
line with a ``program`` object added, per LM iteration
(``*_device_ms``: the device milliseconds of the phases, over the window's
LM iterations) or per solve (``*_per_solve``):

- ``evaluate_device_ms``: phases ``evaluate`` and ``candidate``;
- ``assembly_device_ms``: ``assemble``; ``linear_solve_device_ms``:
  ``linear_solve``; ``update_device_ms``: ``update``; ``control_device_ms``:
  a replay's or region's own time before its first phase;
- ``device_ms_per_iteration``: all of the above;
- ``outside_graphs_ms_per_solve``: the ms of a solve's root span that no
  device interval (a replay or a region, begin to end) covers;
- ``skipped_replays_ms_per_solve``: the device ms of the fused loop's
  replays whose IF node was skipped (None on the host loop);
- ``root_ms_per_solve`` and ``host_spans_ms_per_solve`` (each span name's
  host ms a solve); the calibrations' brackets and the drift between the
  first and the last (``calibration``).

A figure is None where a solve's log overflowed or its stamps are missing.
With ``--trace 1`` the run is a traced run of ``port_bench.run`` with the
program's stamps in its graphs: its result line as that gives it, the
``program`` object left out (its last seconds run under the profiler).
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from port_bench.run import ROOT, use_checkout_caches  # noqa: E402


def program_figures(traces, iterations) -> dict:
    """The ``program`` object of the docstring from the window's solves'
    ``SolveTrace``s and LM iterations."""
    split = [t.phase_ms() for t in traces]
    out = {}
    total = sum(iterations)
    if traces and total and all(s is not None for s in split):
        def per_iteration(*names):
            return sum(s.get(n, 0.0) for s in split for n in names) / total

        out.update(evaluate_device_ms=per_iteration("evaluate", "candidate"),
                   assembly_device_ms=per_iteration("assemble"),
                   linear_solve_device_ms=per_iteration("linear_solve"),
                   update_device_ms=per_iteration("update"),
                   control_device_ms=per_iteration("replay", "region"))
        out["device_ms_per_iteration"] = sum(out.values())
    outside = [t.outside_device_ms() for t in traces]
    if traces and all(o is not None for o in outside):
        out["outside_graphs_ms_per_solve"] = sum(outside) / len(outside)
    skipped = [t.skipped_replays_ms() for t in traces]
    if traces and all(s is not None for s in skipped):
        out["skipped_replays_ms_per_solve"] = sum(skipped) / len(skipped)
    if traces:
        out["root_ms_per_solve"] = sum((t.root.end_ns - t.root.start_ns) * 1e-6
                                       for t in traces) / len(traces)
        host = {}
        for t in traces:
            for s in t.spans[1:]:
                host[s.name] = host.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
        out["host_spans_ms_per_solve"] = {k: v / len(traces) for k, v in sorted(host.items())}
        out["dropped_stamps"] = sum(t.dropped_stamps for t in traces)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    use_checkout_caches()

    import torch

    import ceres_tpu_torch
    from ceres_tpu_torch.utils import observability
    from port_bench.harness import Bench, run_cell

    if not torch.cuda.is_available():
        print("program_phases needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    solve, kept = ceres_tpu_torch.solve, []

    def traced_solve(*a, **k):
        summary = solve(*a, **k)
        kept.append((summary.spans, summary.num_iterations))
        return summary

    def log(line):
        print(line, file=sys.stderr, flush=True)

    ceres_tpu_torch.solve = traced_solve
    torch.cuda.init()
    observability.enable_tracing()
    try:
        result = run_cell(Bench(ROOT), args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T0, log=log)
    finally:
        ceres_tpu_torch.solve = solve
        records = observability.disable_tracing()
    if args.trace:
        print(json.dumps(result), flush=True)
        return 0
    window = kept[len(kept) - result["attempted"]:]
    figures = program_figures([t for t, _ in window], [n for _, n in window])
    figures["calibration"] = {
        "width_ns": {d: [c.width_ns for c in cs] for d, cs in records["calibrations"].items()},
        "drift_ns_over_ns": records["drift"]}
    result["program"] = figures
    log(f"program {json.dumps(figures)}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
