"""Where the time of one solve goes on the card.

    python3 -m ceres_tpu_torch.tools.profile_solve [large|flagship] [float32|float64]...

For each dtype (default: both), on the named case (default: large: 464
cameras / 200 000 points / 1 200 000 observations, DENSE_SCHUR; flagship:
16 / 22106 / 83718, ITERATIVE_SCHUR), after a 2-iteration warm-up solve:

1. ``stages``: one solve with every stage bracketed by
   ``torch.cuda.synchronize()`` and timed on the host clock, so a stage's
   seconds hold its host work and its device work. Stages nest: the
   kernels' wrappers (K1, K3, K4) are inside the evaluation and the S
   assembly, and are listed on their own. The synchronizing makes this solve
   slower than a plain one; both loop times are printed.
2. ``device``: one plain solve under ``torch.profiler``, on a problem whose
   host set-up (program, plans, copies to the card) was done beforehand by
   a 0-iteration solve: the device's busy time (union of its kernels'
   intervals), its idle share of the LM loop, the number of device
   operations, and the ten kernels with the most time.

One JSON line per result on standard output, each with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import fused_lm
from ceres_tpu_torch.linear import schur, schur_explicit
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.ops import reduce

CASES = {
    "large": (dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7), False),
    "flagship": (dict(num_cameras=16, num_points=22106, num_observations=83718, seed=16), True),
}


class _Stages:
    """Synchronized host-clock timers patched over the stage functions."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def __enter__(self):
        self.wrap(fused_lm, "_full_impl", "full evaluation (residuals, Jacobians, gradient)")
        self.wrap(fused_lm, "_cost_impl", "cost-only evaluation")
        self.wrap(fused_lm, "_linear_solve", "linear solve")
        self.wrap(schur.SchurOperator, "rhs", "- reduced rhs")
        self.wrap(schur.SchurOperator, "back_substitute", "- back substitution")
        self.wrap(schur, "SchurOperator", "- point blocks (E'E+D^2)^-1")
        self.wrap(schur, "assemble_reduced_system", "- S assembly")
        self.wrap(torch.linalg, "cholesky_ex", "- Cholesky factorization of S")
        self.wrap(torch, "cholesky_solve", "- Cholesky solve")
        self.wrap(schur, "conjugate_gradients", "- CG")
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    case = argv[0] if argv else "large"
    dtypes = argv[1:] or ["float32", "float64"]
    sizes, iterative = CASES[case]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(**fields):
        print(json.dumps({"case": case, **fields, "card": smi}), flush=True)

    inst = bal.synthesize_bal(noise=2.0, perturb=0.7, **sizes)

    def solve(dtype, max_iters=50, problem=None):
        if problem is None:
            problem = bal.build_problem(inst)[0]
        return ctt.fused_solve(_options(dtype, iterative, max_iters), problem)

    for dtype in dtypes:
        solve(dtype, max_iters=2)
        plain = solve(dtype)
        with _Stages() as stages:
            timed = solve(dtype)
        emit(
            result="stages", dtype=dtype, lm_iterations=timed.num_iterations,
            final_cost=timed.final_cost,
            loop_seconds_plain=plain.minimizer_time_in_seconds,
            loop_seconds_synchronized=timed.minimizer_time_in_seconds,
            setup_seconds=plain.preprocessor_time_in_seconds,
            stages={k: {"seconds": v, "calls": stages.calls[k]} for k, v in stages.seconds.items()},
        )
        prepared = bal.build_problem(inst)[0]
        solve(dtype, max_iters=0, problem=prepared)  # set-up only; cached on the problem
        summary, busy, ops, top = _device_profile(lambda: solve(dtype, problem=prepared))
        loop = summary.minimizer_time_in_seconds
        emit(
            result="device", dtype=dtype, lm_iterations=summary.num_iterations,
            loop_seconds_profiled=loop, device_busy_seconds=busy,
            device_idle_share_of_loop=(1.0 - busy / loop) if busy else None,
            device_operations=ops,
            top_kernels=[{"name": n[:80], "seconds": s} for n, s in top],
        )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
