"""The check fails what it should: the control (float32 evaluation, the
program's lower-precision path) and the faults a solve can have, each
planted under a run that skips only the look for a card. At a tiny size on
the CPU; the readings the limits were set from are the card's, at the
cells' sizes (``python3 -m port_bench.control``, ``PERF.md``)."""

import time

import numpy as np
import pytest

import ceres_tpu_torch
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.problem import Problem
from port_bench.harness import Bench, run_cell

SEED = 2**34 + 77


def _run(root, workload="bal_dubrovnik_16.restarts", dtype=None, device="cpu"):
    return run_cell(Bench(root), workload, SEED, 0.4, False, device, time.perf_counter(),
                    evaluation_dtype=dtype, log=lambda line: None)


@pytest.mark.parametrize("workload", ["bal_dubrovnik_16.restarts", "bal_dubrovnik_16.callback",
                                      "bal_dubrovnik_356.restarts"])
def test_the_program_passes_and_the_control_fails(tiny_root, workload):
    sound = _run(tiny_root, workload)
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    control = _run(tiny_root, workload, dtype="float32")
    assert not control["correct"]
    assert control["checks"]["cost_gap"]["value"] > control["checks"]["cost_gap"]["limit"]


def test_a_solve_that_returns_its_state_unchanged_fails(tiny_root, monkeypatch):
    real = ceres_tpu_torch.solve

    def unchanged(options, problem, device="cuda"):
        start = problem.state()
        summary = real(options, problem, device=device)
        problem.write_back(start)
        summary.final_cost = summary.initial_cost
        return summary

    monkeypatch.setattr(ceres_tpu_torch, "solve", unchanged)
    r = _run(tiny_root)
    assert not r["correct"]
    assert r["checks"]["gn_decrease"]["value"] > 0.5


def test_half_the_observations_left_out_fails(tiny_root, monkeypatch):
    real = bal.build_problem

    def half(b, loss=None):  # every other observation, their cost doubled
        keep = np.arange(b.num_observations) % 2 == 0
        return real(bal.BALProblem(b.cameras, b.points, b.camera_index[keep],
                                   b.point_index[keep], b.observations[keep]),
                    loss=ceres_tpu_torch.loss.ScaledLoss(None, 2.0))

    monkeypatch.setattr(bal, "build_problem", half)
    r = _run(tiny_root)
    assert not r["correct"]
    assert r["checks"]["cost_gap"]["value"] > r["checks"]["cost_gap"]["limit"]


def test_an_answer_altered_where_it_is_produced_fails(tiny_root, monkeypatch):
    real = Problem.state

    def altered(self):
        x = real(self).copy()
        x[-1] += 0.5  # the last point's depth
        return x

    monkeypatch.setattr(Problem, "state", altered)
    r = _run(tiny_root)
    assert not r["correct"]
    assert r["checks"]["cost_gap"]["value"] > r["checks"]["cost_gap"]["limit"]


@pytest.mark.cuda
def test_on_the_card_the_program_passes_and_the_control_fails(tiny_root, cuda):
    assert _run(tiny_root, device="cuda")["correct"]
    assert not _run(tiny_root, dtype="float32", device="cuda")["correct"]
