"""Tracing, profiling, problem dumps and checkpointing (port of
``ceres_tpu/utils/observability.py``; host only).

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
- ``profiler_trace`` — a ``torch.profiler`` capture of the enclosed solve.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class EventLogger:
    """Scoped phase timer (event_logger.h:41-75)."""

    def __init__(self, name: str, verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.start = time.time()
        self.last = self.start
        self.events = []

    def add_event(self, event: str) -> None:
        now = time.time()
        self.events.append((event, now - self.last, now - self.start))
        self.last = now
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
    (execution_summary.h ScopedExecutionTimer)."""

    def __init__(self, name: str, summary: ExecutionSummary):
        self.name = name
        self.summary = summary

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.summary.update_time(self.name, time.time() - self.t0)
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


class profiler_trace:
    """Context manager: a ``torch.profiler`` trace of the enclosed solve,
    CPU and (where there is a card) CUDA activity, written as a Chrome
    trace to ``path`` on exit; ``.profile`` is the profiler object."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        self.profile.export_chrome_trace(self.path)
        return False
