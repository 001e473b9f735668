"""Line-search minimizer: L-BFGS, BFGS, nonlinear CG and steepest descent
(port of ``ceres_tpu/line_search.py``; analog of
``internal/ceres/line_search_minimizer.cc:87-481``,
``line_search_direction.cc:44-230``, ``line_search.{h,cc}`` (Armijo and
strong-Wolfe searches with polynomial interpolation) and
``low_rank_inverse_hessian.{h,cc}`` (the L-BFGS two-loop recursion)).

The minimizer is generic over an *oracle*, so one loop serves nonlinear
least squares (the gradient by reverse mode, ``Evaluator.cost_and_gradient``)
and ``GradientProblem`` (gradient_problem_solver.cc:99-150). An oracle's
evaluations are the regions of its ``graphs``
(``host_loop_graphs.LineSearchGraphs``): the cost and gradient at the start,
and phi(a) = f(x [+] a d), each device work on static buffers, on the card
one CUDA graph replayed per call where ``fused_lm.regions_capturable`` says
so (as the JAX package jits them), else the same regions run eagerly. The
bracketing logic stays on the host like the reference's; the vectors (x, g,
the direction, L-BFGS's s and y, BFGS's matrix) stay on the device, and the
directions are computed eagerly (the JAX package computes them in numpy).
The host reads once per evaluation of phi (its value and phi'(a)
together), once per direction (d'g and g'g, for the descent test and a
restart) and once after each step (the iteration's norms and the curvature
pair's s'y and y'y); the two-loop recursion's dot products stay on the
device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ceres_tpu_torch.ops.polynomial import cubic_minimizer_two_points
from ceres_tpu_torch.trust_region import IterationSummary, _grad_norms, _to_host
from ceres_tpu_torch.types import (
    CallbackReturnType,
    LineSearchDirectionType,
    LineSearchType,
    NonlinearConjugateGradientType,
    TerminationType,
)
from ceres_tpu_torch.utils.observability import ScopedExecutionTimer

_F64 = torch.float64


class Oracle:
    """Evaluation interface for line-search minimization: tensors in,
    tensors out (the cost an f64 scalar on the device), from the regions
    ``graphs`` (``host_loop_graphs.LineSearchGraphs``). ``comm``: the
    collectives of a sharded program (parallel/sharding.py), or None."""

    num_tangent: int
    comm = None
    graphs = None

    def cost_and_gradient(self, x: torch.Tensor):
        """(cost, tangent gradient) at x, copies."""
        return self.graphs.cost_and_gradient(x)

    def line(self, x: torch.Tensor, d: torch.Tensor) -> None:
        """Search from x along d."""
        self.graphs.line(x, d)

    def phi(self, a: float):
        """((phi(a), phi'(a)) as an f64 device vector, x [+] a d, its
        gradient) along :meth:`line`'s."""
        return self.graphs.phi(a)


class ProgramOracle(Oracle):
    """A Program's cost and tangent gradient on its line-search regions
    (``host_loop_graphs.line_search_graphs``), captured where ``captured``
    (by default ``fused_lm.regions_capturable``; the eager baseline sets
    False). Every evaluation is an ``Evaluator::Gradient`` call of the
    evaluator's statistics."""

    def __init__(self, program, captured: Optional[bool] = None):
        from ceres_tpu_torch.evaluator import Evaluator
        from ceres_tpu_torch.fused_lm import program_functions, regions_capturable
        from ceres_tpu_torch.host_loop_graphs import line_search_graphs

        if captured is None:
            captured = regions_capturable(program.device, program.comm,
                                          program_functions(program))
        self.graphs = line_search_graphs(program, captured)
        self._ev = Evaluator(program, graphs=self.graphs)
        self.num_tangent = program.num_tangent
        self.comm = program.comm

    def cost_and_gradient(self, x):
        return self._ev.cost_and_gradient(x)

    def phi(self, a):
        with ScopedExecutionTimer("Evaluator::Gradient", self._ev.execution_summary):
            return self.graphs.phi(a)


# -- line searches -----------------------------------------------------------


@dataclasses.dataclass
class _PhiEval:
    a: float
    value: float
    gradient: float  # directional derivative phi'(a)
    x: object = None
    g: object = None  # full gradient at x (tangent), for reuse


def _interpolate_cubic(lo: _PhiEval, hi: _PhiEval) -> float:
    """Cubic minimizer of phi on [lo.a, hi.a] from values and derivatives
    (polynomial.cc MinimizeInterpolatingPolynomial)."""
    return cubic_minimizer_two_points(lo.a, lo.value, lo.gradient, hi.a, hi.value, hi.gradient)


class _LineSearchFunction:
    """phi(a) = f(plus(x, a d)) (line_search.h:213 LineSearchFunction): one
    run of the oracle's ``phi`` region and one host read per call."""

    def __init__(self, oracle: Oracle, x, direction):
        self.oracle = oracle
        oracle.line(x, direction)
        self.evals = 0

    def __call__(self, a: float) -> _PhiEval:
        self.evals += 1
        scalars, xa, g = self.oracle.phi(a)
        value, dg = _to_host(*scalars)
        return _PhiEval(a=a, value=value, gradient=dg, x=xa, g=g)


def armijo_search(phi: _LineSearchFunction, phi0: _PhiEval, initial_step: float,
                  options) -> Optional[_PhiEval]:
    """Backtracking Armijo with cubic interpolation (line_search.cc
    ArmijoLineSearch::DoSearch)."""
    c1 = options.line_search_sufficient_function_decrease
    a = initial_step
    prev = None
    for _ in range(options.max_num_line_search_step_size_iterations):
        cur = phi(a)
        if np.isfinite(cur.value) and cur.value <= phi0.value + c1 * a * phi0.gradient:
            return cur
        # Contract: cubic with two points, else bisection.
        if prev is not None and np.isfinite(cur.value):
            a_new = _interpolate_cubic(prev, cur)
        else:
            a_new = 0.5 * a
        lo = options.max_line_search_step_contraction * a
        hi = options.min_line_search_step_contraction * a
        a = float(np.clip(a_new, lo, hi))
        if a < options.min_line_search_step_size:
            return None
        prev = cur if np.isfinite(cur.value) else prev
    return None


def wolfe_search(phi: _LineSearchFunction, phi0: _PhiEval, initial_step: float,
                 options) -> Optional[_PhiEval]:
    """Strong Wolfe search: bracketing and zoom with cubic interpolation
    (line_search.cc WolfeLineSearch, Nocedal & Wright Alg 3.5/3.6)."""
    c1 = options.line_search_sufficient_function_decrease
    c2 = options.line_search_sufficient_curvature_decrease
    max_iter = options.max_num_line_search_step_size_iterations

    def sufficient_decrease(e: _PhiEval) -> bool:
        return e.value <= phi0.value + c1 * e.a * phi0.gradient

    def curvature_ok(e: _PhiEval) -> bool:
        return abs(e.gradient) <= c2 * abs(phi0.gradient)

    prev = phi0
    a = initial_step
    bracket_lo = bracket_hi = None
    for i in range(max_iter):
        cur = phi(a)
        if not np.isfinite(cur.value):
            # Shrink into the known-good region.
            a = 0.5 * (prev.a + a) if prev.a < a else 0.5 * a
            continue
        if (not sufficient_decrease(cur)) or (i > 0 and cur.value >= prev.value):
            bracket_lo, bracket_hi = prev, cur
            break
        if curvature_ok(cur):
            return cur
        if cur.gradient >= 0:
            bracket_lo, bracket_hi = cur, prev
            break
        prev_a = 0.0 if i == 0 else prev.a
        prev = cur
        a = min(options.max_line_search_step_expansion * a, a + (a - prev_a) * 4.0)
    if bracket_lo is None:
        return prev if prev is not phi0 and sufficient_decrease(prev) else None

    # Zoom.
    lo, hi = bracket_lo, bracket_hi
    best = None
    for _ in range(max_iter):
        a = _interpolate_cubic(lo, hi)
        if abs(hi.a - lo.a) < options.min_line_search_step_size or not np.isfinite(a):
            break
        cur = phi(a)
        if not np.isfinite(cur.value):
            hi = _PhiEval(a=a, value=np.inf, gradient=0.0)
            continue
        if (not sufficient_decrease(cur)) or cur.value >= lo.value:
            hi = cur
        else:
            if curvature_ok(cur):
                return cur
            best = cur
            if cur.gradient * (hi.a - lo.a) >= 0:
                hi = lo
            lo = cur
    if best is not None:
        return best
    if lo is not phi0 and np.isfinite(lo.value) and sufficient_decrease(lo):
        return lo
    return None


# -- search directions -------------------------------------------------------


class _LBFGS:
    """Two-loop recursion (low_rank_inverse_hessian.{h,cc}) over device
    vectors; s'y and y'y of each pair come from the host read after its
    step."""

    def __init__(self, rank: int):
        self.rank = rank
        self.pairs: List[tuple] = []  # (s, y, s'y, y'y)

    def update(self, s, y, sy: float, yy: float) -> bool:
        if sy <= 1e-14:
            return False  # skip the update: the curvature condition fails
        if len(self.pairs) >= self.rank:
            self.pairs.pop(0)
        self.pairs.append((s, y, sy, yy))
        return True

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        q = g.clone()
        alphas = []
        for s, y, sy, _ in reversed(self.pairs):
            rho = 1.0 / sy
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self.pairs:
            _, _, sy, yy = self.pairs[-1]
            q = q * (sy / yy)
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q


class _BFGS:
    """Dense inverse-Hessian BFGS (line_search_direction.cc:145-230): an
    n x n matrix, right for GradientProblem sizes and not for bundle
    adjustment, as in Ceres."""

    def __init__(self, n: int, like: torch.Tensor):
        self.H = torch.eye(n, dtype=like.dtype, device=like.device)
        self.initialized = False

    def update(self, s, y, sy: float, yy: float) -> bool:
        if sy <= 1e-14:
            return False
        if not self.initialized:
            self.H = self.H * (sy / yy)
            self.initialized = True
        rho = 1.0 / sy
        eye = torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
        V = eye - rho * torch.outer(s, y)
        self.H = V @ self.H @ V.T + rho * torch.outer(s, s)
        return True

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        return self.H @ g


def _ncg_direction(g, prev_g, prev_d, kind: NonlinearConjugateGradientType):
    """-g + beta prev_d with beta on the device (line_search_direction.cc
    NonlinearConjugateGradient)."""
    gg0 = torch.dot(prev_g, prev_g)
    if kind == NonlinearConjugateGradientType.FLETCHER_REEVES:
        beta = torch.dot(g, g) / gg0
    elif kind == NonlinearConjugateGradientType.POLAK_RIBIERE:
        beta = torch.clamp(torch.dot(g, g - prev_g) / gg0, min=0.0)
    else:  # HESTENES_STIEFEL
        dy = torch.dot(prev_d, g - prev_g)
        beta = torch.where(dy != 0.0, torch.dot(g, g - prev_g) / dy, torch.zeros_like(dy))
    return -g + beta * prev_d


class LineSearchMinimizer:
    """Analog of LineSearchMinimizer::Minimize (line_search_minimizer.cc:87),
    over an oracle or a Program's (``ProgramOracle(program, captured)``)."""

    def __init__(self, program_or_oracle, options, summary, captured: Optional[bool] = None):
        if isinstance(program_or_oracle, Oracle):
            self.oracle = program_or_oracle
        else:
            self.oracle = ProgramOracle(program_or_oracle, captured)
        self.options = options
        self.summary = summary
        # The Evaluator's statistics (``solve`` folds them into the
        # summary); a GradientProblem's oracle has none.
        self.evaluator = getattr(self.oracle, "_ev", None)

    def minimize(self, x0: torch.Tensor) -> torch.Tensor:
        """The solution from x0. The graphs captured in this call count
        their seconds in the summary's ``graph_capture_time_in_seconds``;
        each replay credits its launches as it runs (no read)."""
        graphs = self.oracle.graphs
        capture0 = graphs.capture_seconds
        try:
            return self._minimize(x0)
        finally:
            self.summary.captured_loop = graphs.captured
            self.summary.graph_capture_time_in_seconds += graphs.capture_seconds - capture0
            self.summary.num_iterations = max(len(self.summary.iterations) - 1, 0)

    def _minimize(self, x0: torch.Tensor) -> torch.Tensor:
        opts = self.options
        oracle = self.oracle
        summary = self.summary
        start = time.perf_counter()
        direction_type = opts.line_search_direction_type

        x = x0
        c, g = oracle.cost_and_gradient(x)
        cost, gmax, gnorm = _to_host(c, *_grad_norms(g))
        if not np.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost is not finite."
            return x

        lbfgs = _LBFGS(opts.max_lbfgs_rank)
        bfgs = (
            _BFGS(oracle.num_tangent, g)
            if direction_type == LineSearchDirectionType.BFGS else None
        )
        prev_g = prev_d = None
        restarts = 0

        it = IterationSummary(
            iteration=0,
            cost=cost,
            gradient_max_norm=gmax,
            gradient_norm=gnorm,
            cumulative_time_in_seconds=time.perf_counter() - start,
            step_is_valid=True,
            step_is_successful=True,
        )
        summary.iterations.append(it)
        if it.gradient_max_norm <= opts.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Gradient tolerance reached."
            return x

        prev_cost_change = 0.0
        for iteration in range(1, opts.max_num_iterations + 1):
            iter_t0 = time.perf_counter()

            # Direction (line_search_direction.cc:44-230).
            if direction_type == LineSearchDirectionType.STEEPEST_DESCENT:
                d = -g
            elif direction_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
                d = -g if prev_g is None else _ncg_direction(
                    g, prev_g, prev_d, opts.nonlinear_conjugate_gradient_type
                )
            elif direction_type == LineSearchDirectionType.LBFGS:
                d = -lbfgs.apply(g)
            else:
                d = -bfgs.apply(g)

            dg, gg = _to_host(torch.dot(d, g), torch.dot(g, g))
            if dg >= 0:
                # Not a descent direction: restart from steepest descent
                # (line_search_minimizer.cc direction restart logic).
                restarts += 1
                if restarts > opts.max_num_line_search_direction_restarts:
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = (
                        "Line search direction failure: exceeded "
                        "max_num_line_search_direction_restarts."
                    )
                    return x
                lbfgs = _LBFGS(opts.max_lbfgs_rank)
                if bfgs is not None:
                    bfgs = _BFGS(oracle.num_tangent, g)
                d = -g
                dg = -gg

            # Initial step size (line_search_minimizer.cc:200-230).
            if direction_type in (
                LineSearchDirectionType.LBFGS, LineSearchDirectionType.BFGS
            ) and iteration > 1:
                initial_step = 1.0
            elif iteration == 1:
                initial_step = min(1.0, 1.0 / gmax) if gmax > 0 else 1.0
            else:
                initial_step = (
                    min(1.0, 2.0 * abs(prev_cost_change) / abs(dg)) if dg != 0 else 1.0
                )
            if initial_step <= 0 or not np.isfinite(initial_step):
                initial_step = 1.0

            phi = _LineSearchFunction(oracle, x, d)
            phi0 = _PhiEval(a=0.0, value=cost, gradient=dg, x=x, g=g)
            if opts.line_search_type == LineSearchType.ARMIJO:
                result = armijo_search(phi, phi0, initial_step, opts)
            else:
                result = wolfe_search(phi, phi0, initial_step, opts)

            if result is None:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = (
                    f"Line search failed at iteration {iteration}; "
                    "no step satisfying the search conditions found."
                )
                return x

            new_x, new_cost, new_g = result.x, result.value, result.g
            s = result.a * d
            y = new_g - g
            gmax, gnorm, step_norm, x_norm, sy, yy = _to_host(
                *_grad_norms(new_g),
                torch.linalg.norm((new_x - x).to(_F64)),
                torch.linalg.norm(x.to(_F64)),
                torch.dot(s, y),
                torch.dot(y, y),
            )
            if direction_type == LineSearchDirectionType.LBFGS:
                lbfgs.update(s, y, sy, yy)
            elif direction_type == LineSearchDirectionType.BFGS:
                bfgs.update(s, y, sy, yy)

            prev_g, prev_d = g, d
            cost_change = cost - new_cost
            prev_cost_change = cost_change
            x, cost, g = new_x, new_cost, new_g

            it = IterationSummary(
                iteration=iteration,
                cost=cost,
                cost_change=cost_change,
                gradient_max_norm=gmax,
                gradient_norm=gnorm,
                step_norm=step_norm,
                step_size=result.a,
                line_search_function_evaluations=phi.evals,
                step_is_valid=True,
                step_is_successful=True,
                iteration_time_in_seconds=time.perf_counter() - iter_t0,
                cumulative_time_in_seconds=time.perf_counter() - start,
            )
            summary.iterations.append(it)

            for cb in opts.callbacks:
                ret = cb(it)
                if ret == CallbackReturnType.SOLVER_ABORT:
                    summary.termination_type = TerminationType.USER_FAILURE
                    summary.message = "User callback returned SOLVER_ABORT."
                    return x
                if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    summary.termination_type = TerminationType.USER_SUCCESS
                    summary.message = "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                    return x

            if it.gradient_max_norm <= opts.gradient_tolerance:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Gradient tolerance reached. Gradient max norm: "
                    f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
                )
                return x
            if abs(cost_change) <= opts.function_tolerance * (cost + cost_change):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost_change) / max(cost, 1e-300):e} <= "
                    f"{opts.function_tolerance:e}"
                )
                return x
            tol = opts.parameter_tolerance * (x_norm + opts.parameter_tolerance)
            if step_norm <= tol:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                return x
            over = time.perf_counter() - start > opts.max_solver_time_in_seconds
            if self.oracle.comm is not None:  # rank 0's clock
                over = self.oracle.comm.over_budget(over, opts.max_solver_time_in_seconds,
                                                    x.device)
            if over:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = "Maximum solver time reached."
                return x

        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = (
            "Maximum number of iterations reached. "
            f"Number of iterations: {opts.max_num_iterations}."
        )
        return x
