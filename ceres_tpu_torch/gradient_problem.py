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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

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

    @property
    def num_tangent(self) -> int:
        return self.manifold.tangent_size if self.manifold is not None else self.num_parameters


class _GradientProblemOracle(Oracle):
    """Analog of GradientProblemEvaluator (gradient_problem_evaluator.h)."""

    def __init__(self, gp: GradientProblem):
        self.gp = gp
        self.num_tangent = gp.num_tangent

    def plus(self, x, delta):
        m = self.gp.manifold
        return x + delta if m is None else m.plus(x, delta)

    def cost_and_gradient(self, x):
        gp = self.gp
        if gp.gradient_fn is not None:
            c, g_amb = gp.fn(x), gp.gradient_fn(x)
            if gp.manifold is None:
                return c, g_amb
            return c, gp.manifold.plus_jacobian(x).T @ g_amb
        zero = x.new_zeros((self.num_tangent,))
        g, c = torch.func.grad_and_value(lambda d: gp.fn(self.plus(x, d)))(zero)
        return c, g


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
    t0 = time.perf_counter()
    summary = SolverSummary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.device = str(torch.device(device))
    summary.num_parameters = problem.num_parameters
    summary.num_effective_parameters = problem.num_tangent
    minimizer = LineSearchMinimizer(_GradientProblemOracle(problem), options, summary)
    x0 = torch.as_tensor(np.asarray(parameters, dtype=np.float64)).to(device)
    x_final = minimizer.minimize(x0)
    parameters[...] = x_final.detach().cpu().numpy()
    if summary.iterations:
        summary.initial_cost = summary.iterations[0].cost
        summary.final_cost = min(i.cost for i in summary.iterations)
        summary.num_iterations = len(summary.iterations) - 1
    summary.total_time_in_seconds = time.perf_counter() - t0
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    return summary
