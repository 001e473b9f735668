"""The comparison that decides ``correct``.

Each request's answer is a state and the cost the program reports there.
Once the window has closed and the program's state is freed, the plain
reference (``reference.py``) judges them:

- ``cost_gap``: for every solve the run made, |reported final cost -
  reference cost at the returned state| / reference cost; the largest. It
  holds the evaluator (residuals, the cost's reduction) at the state the
  solve returns; float32 evaluation, the control, fails it.
- ``gn_decrease``: for a sample of the solves (the one with the most LM
  iterations, and ``SAMPLE`` more drawn from the seed, all where the run
  made fewer), the cost decrease one exact Gauss-Newton step from the
  returned state predicts, as a share of the cost there; the largest. It
  holds the Schur solve and the LM loop to their answer being a minimum; a
  fault that stops one solve in ten early is in a sample of 32 with
  probability 0.97.
- ``failed_solves``: solves whose termination is not usable (limit 0).

Each limit is the configuration's (its ``limits``); ``PERF.md`` gives the
readings each was set from.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import Reference
from port_bench.scene import stream_seed

SAMPLE = 31


def sample(solves, seed: int) -> list:
    """Indices of the solves the Gauss-Newton check reads: the one with the
    most iterations, then up to SAMPLE others drawn from the seed."""
    if not solves:
        return []
    longest = max(range(len(solves)), key=lambda i: solves[i].iterations)
    rest = [i for i in range(len(solves)) if i != longest]
    rng = np.random.default_rng(stream_seed(seed, 2))
    picked = rng.choice(len(rest), size=min(SAMPLE, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in picked)


def judge(scene, solves, states, limits: dict, seed: int, device) -> dict:
    """{name: {"value", "limit"}} of the run's solves and returned states."""
    ref = Reference(scene, device)
    def worst(values):  # NaN reads as inf: it never passes a limit
        return max((v if np.isfinite(v) else float("inf") for v in values),
                   default=float("inf"))

    gap = worst(abs(s.final_cost - c) / c
                for s, c in ((s, ref.cost(x)) for s, x in zip(solves, states)))
    decrease = worst(ref.gauss_newton_decrease(states[i]) for i in sample(solves, seed))
    failed = sum(1 for s in solves if not s.usable)
    return {
        "cost_gap": {"value": gap, "limit": limits["cost_gap"]},
        "gn_decrease": {"value": decrease, "limit": limits["gn_decrease"]},
        "failed_solves": {"value": failed, "limit": 0},
    }
