"""General unconstrained minimization of f(x), optionally on a manifold
(port of ``ceres_tpu/gradient_problem.py``; analog of
``include/ceres/gradient_problem.h:92``,
``gradient_problem_solver.{h,cc}:99-150`` and
``internal/ceres/gradient_problem_evaluator.h``).

The function goes into an oracle for the line-search minimizer. Its
gradient is reverse mode of f(plus(x, delta)) at delta = 0, which maps it
into the tangent space through the manifold's chart; a user gradient in the
ambient space (FirstOrderFunction::Evaluate) is mapped by the plus
Jacobian instead. ``fn`` and ``gradient_fn`` are written on torch tensors.

The evaluations run as the line search's regions
(``host_loop_graphs.LineSearchGraphs``), on the card as CUDA graphs, as the
JAX package jits ``_plus`` and ``_cost_grad``: ``fn`` and ``gradient_fn``
must then be capturable (pure tensor work, their constants already on the
card), as the JAX package's must be traceable. A function marked
``runs_on_host`` runs the same regions eagerly
(``fused_lm.regions_capturable``). The graphs are captured at a problem's
first solve on a device and kept with it for its later solves.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ceres_tpu_torch.fused_lm import regions_capturable
from ceres_tpu_torch.host_loop_graphs import LineSearchGraphs
from ceres_tpu_torch.line_search import LineSearchMinimizer, Oracle
from ceres_tpu_torch.manifold import Manifold
from ceres_tpu_torch.solver import SolverOptions, SolverSummary
from ceres_tpu_torch.types import MinimizerType


class GradientProblem:
    """min f(x), x in R^n or on a manifold (gradient_problem.h:92)."""

    def __init__(
        self,
        fn: Callable,
        num_parameters: int,
        manifold: Optional[Manifold] = None,
        gradient_fn: Optional[Callable] = None,
    ):
        self.fn = fn
        self.num_parameters = int(num_parameters)
        self.manifold = manifold
        if manifold is not None and manifold.ambient_size != num_parameters:
            raise ValueError("manifold ambient size mismatch")
        self.gradient_fn = gradient_fn
        self._graphs: dict = {}  # _GradientProblemGraphs by what they were made for

    @property
    def num_tangent(self) -> int:
        return self.manifold.tangent_size if self.manifold is not None else self.num_parameters


class _GradientProblemGraphs(LineSearchGraphs):
    """A GradientProblem's evaluations (gradient_problem_evaluator.h) as the
    line search's regions."""

    def __init__(self, gp: GradientProblem, device: torch.device, captured: bool):
        super().__init__(device, captured)
        self.fn, self.gradient_fn, self.manifold = gp.fn, gp.gradient_fn, gp.manifold
        self.num_tangent = gp.num_tangent

    def plus(self, x, delta):
        return x + delta if self.manifold is None else self.manifold.plus(x, delta)

    def evaluate(self, x):
        if self.gradient_fn is not None:
            c, g_amb = self.fn(x), self.gradient_fn(x)
            if self.manifold is None:
                return c, g_amb
            return c, self.manifold.plus_jacobian(x).T @ g_amb
        zero = x.new_zeros((self.num_tangent,))
        g, c = torch.func.grad_and_value(lambda d: self.fn(self.plus(x, d)))(zero)
        return c, g


class _GradientProblemOracle(Oracle):
    """Analog of GradientProblemEvaluator (gradient_problem_evaluator.h):
    the problem's regions on ``device``, captured where ``captured``
    (by default ``fused_lm.regions_capturable``), kept on the problem."""

    def __init__(self, gp: GradientProblem, device, captured: Optional[bool] = None):
        device = torch.device(device)
        if captured is None:
            captured = regions_capturable(device, None, (gp.fn, gp.gradient_fn))
        key = (device, captured, id(gp.fn), id(gp.gradient_fn), id(gp.manifold))
        graphs = gp._graphs.get(key)
        if graphs is None:
            graphs = gp._graphs[key] = _GradientProblemGraphs(gp, device, captured)
        self.graphs = graphs
        self.num_tangent = gp.num_tangent


@dataclasses.dataclass
class GradientProblemOptions(SolverOptions):
    """Analog of GradientProblemSolver::Options: the line-search subset."""


def solve_gradient_problem(
    options: GradientProblemOptions,
    problem: GradientProblem,
    parameters: np.ndarray,
    device="cuda",
) -> SolverSummary:
    """Analog of GradientProblemSolver::Solve (gradient_problem_solver.cc:99)
    in float64 on ``device`` (the card by default; without one that raises,
    it does not move to the CPU). Writes the solution into ``parameters``
    and returns the summary."""
    return _solve(options, problem, parameters, device, None)


def _solve(options, problem: GradientProblem, parameters: np.ndarray, device,
           captured: Optional[bool]) -> SolverSummary:
    """``solve_gradient_problem`` with its evaluations captured where
    ``captured`` (None: ``fused_lm.regions_capturable``; False: the same
    regions eagerly, the captured solve's baseline,
    ``tools/profile_solve.eager_gradient_problem``)."""
    t0 = time.perf_counter()
    summary = SolverSummary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.device = str(torch.device(device))
    summary.num_parameters = problem.num_parameters
    summary.num_effective_parameters = problem.num_tangent
    oracle = _GradientProblemOracle(problem, device, captured)
    minimizer = LineSearchMinimizer(oracle, options, summary)
    x0 = torch.as_tensor(np.asarray(parameters, dtype=np.float64)).to(device)
    x_final = minimizer.minimize(x0)
    parameters[...] = x_final.detach().cpu().numpy()
    if summary.iterations:
        summary.initial_cost = summary.iterations[0].cost
        summary.final_cost = min(i.cost for i in summary.iterations)
    summary.total_time_in_seconds = time.perf_counter() - t0
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    return summary
