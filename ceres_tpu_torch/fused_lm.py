"""The Levenberg-Marquardt loop with every tensor on the device (port of
``ceres_tpu/fused_lm.py``).

Each iteration evaluates residuals and Jacobian blocks, applies Jacobi
column scaling and LM damping, solves for the step (ITERATIVE_SCHUR or
DENSE_SCHUR), takes
the model cost change in f64, evaluates the candidate cost, and updates the
radius and the invalid-step ladder with the four convergence tests of
trust_region_minimizer.cc:640-764 — the semantics of the JAX package's
``lax.while_loop`` body. The loop itself runs on the host and reads one
value from the device per iteration: the termination code.

Scalars kept in f64 whatever the evaluation dtype, as the JAX package does
under its global x64 switch: the costs, the model cost change, rho, the
radius and decrease factor, and the x/step/gradient norms.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ceres_tpu_torch.evaluator import _cost_impl, _full_impl
from ceres_tpu_torch.linear.cg import CG_FAILURE
from ceres_tpu_torch.problem import cast_program, plus_apply
from ceres_tpu_torch.solver import SolverSummary, check_supported
from ceres_tpu_torch.trust_region import (
    _SolveConfig,
    _build_solve_aux,
    _config_from_options,
    _linear_solve,
    _lm_damping,
)
from ceres_tpu_torch.types import TerminationType

# Termination codes of the loop (the JAX package's values).
_RUNNING = 0
_CONVERGENCE = 1
_FAILURE = 3

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    solve: _SolveConfig
    function_tolerance: float
    gradient_tolerance: float
    parameter_tolerance: float
    min_relative_decrease: float
    initial_trust_region_radius: float
    max_trust_region_radius: float
    min_trust_region_radius: float
    max_invalid_steps: int
    jacobi_scaling: bool
    # Host-loop parity (the JAX package's traced mode, which ct.solve
    # runs): a step meeting the parameter/function tolerance is not
    # applied and the pre-step iterate is returned.
    revert_on_tolerance: bool


@dataclasses.dataclass
class _FusedState:
    x: torch.Tensor
    cost: torch.Tensor  # f64 scalar
    radius: torch.Tensor  # f64
    decrease_factor: torch.Tensor  # f64
    iteration: int
    successful_steps: torch.Tensor  # int32 scalars from here on
    unsuccessful_steps: torch.Tensor
    invalid_in_a_row: torch.Tensor
    termination: torch.Tensor
    linear_iterations: torch.Tensor
    gmax: torch.Tensor  # f64 gradient norms of the current iterate
    gnorm: torch.Tensor
    # whether the previous iteration accepted its step: the gradient test
    # only fires on an iterate an accepted step produced
    # (trust_region_minimizer.cc:826-837)
    last_accept: torch.Tensor


def _body(s: _FusedState, program, solve_aux, config: _FusedConfig) -> _FusedState:
    sc = config.solve
    families = program.families
    cost, grad, ctx = _full_impl(s.x, families, program.num_tangent, program.groups)

    scaling = None
    if config.jacobi_scaling:
        # One column-norm pass: the scaled norms are scaling^2 * norms.
        norms0 = ctx.squared_column_norms()
        scaling = 1.0 / (1.0 + torch.sqrt(norms0))
        ctx = ctx.scale_columns(scaling)
        scaled_norms = scaling * scaling * norms0
    else:
        scaled_norms = ctx.squared_column_norms()
    diag = torch.clamp(scaled_norms, sc.min_lm_diagonal, sc.max_lm_diagonal)
    D = _lm_damping(diag, s.radius)
    y, lin_iters, lin_term = _linear_solve(ctx, D, solve_aux, sc)
    step_scaled = -y.to(diag.dtype)
    Js = ctx.matvec(step_scaled)
    mcc = torch.zeros((), dtype=_F64, device=s.x.device)
    for fi in range(len(ctx.families)):
        # f64 accumulation: f32 cancellation here makes tiny steps near
        # the optimum look invalid (mcc <= 0 noise).
        j64 = Js[fi].to(_F64)
        mcc = mcc - torch.sum(j64 * (ctx.residuals[fi].to(_F64) + j64 / 2.0))
    step = step_scaled * scaling if config.jacobi_scaling else step_scaled
    # A linear-solver FAILURE invalidates the step (linear_solver.h:57).
    step_is_valid = torch.isfinite(mcc) & (mcc > 0.0) & (lin_term < CG_FAILURE)

    candidate = plus_apply(program.plus_struct, s.x, step)
    cand_cost = _cost_impl(candidate, families, program.groups)
    cand_cost = torch.where(torch.isfinite(cand_cost), cand_cost, torch.inf)
    rho = (cost - cand_cost) / mcc
    accept = step_is_valid & (rho > config.min_relative_decrease)

    # LM radius update (levenberg_marquardt_strategy.cc:158-171).
    r_acc = s.radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    r_acc = torch.clamp(r_acc, max=config.max_trust_region_radius)
    r_rej = s.radius / s.decrease_factor
    radius = torch.where(accept, r_acc, r_rej)
    decrease_factor = torch.where(accept, 2.0, s.decrease_factor * 2.0)
    invalid_in_a_row = torch.where(step_is_valid, 0, s.invalid_in_a_row + 1)

    # Convergence tests (trust_region_minimizer.cc:640-764).
    x_norm = torch.linalg.norm(s.x.to(_F64))
    step_norm = torch.linalg.norm((candidate - s.x).to(_F64))
    cost_change = torch.abs(cost - cand_cost)
    g64 = grad.to(_F64)
    gmax = torch.max(torch.abs(g64))
    gnorm = torch.linalg.norm(g64)
    ptol = config.parameter_tolerance
    param_tol = (
        step_is_valid
        & (step_norm <= ptol * (x_norm + ptol))
        & (s.successful_steps > 0)
    )
    func_tol = step_is_valid & (cost_change <= config.function_tolerance * cost)
    keep = accept
    if config.revert_on_tolerance:
        keep = accept & ~(param_tol | func_tol)
    grad_tol = s.last_accept & (gmax <= config.gradient_tolerance)
    radius_tol = radius <= config.min_trust_region_radius
    too_invalid = invalid_in_a_row >= config.max_invalid_steps
    termination = torch.where(
        param_tol | func_tol | grad_tol | radius_tol,
        _CONVERGENCE,
        torch.where(too_invalid, _FAILURE, _RUNNING),
    ).to(torch.int32)
    acc = accept.to(torch.int32)
    return _FusedState(
        x=torch.where(keep, candidate, s.x),
        cost=torch.where(keep, cand_cost, cost),
        radius=radius,
        decrease_factor=decrease_factor,
        iteration=s.iteration + 1,
        successful_steps=s.successful_steps + acc,
        unsuccessful_steps=s.unsuccessful_steps + (1 - acc),
        invalid_in_a_row=invalid_in_a_row.to(torch.int32),
        termination=termination,
        linear_iterations=s.linear_iterations + lin_iters.to(torch.int32),
        gmax=gmax,
        gnorm=gnorm,
        last_accept=accept,
    )


def _fused_minimize(x0, program, solve_aux, max_num_iterations: int,
                    config: _FusedConfig):
    """Run the LM loop from x0; returns (final state, initial cost)."""
    dev = x0.device
    cost0, grad0, _ = _full_impl(x0, program.families, program.num_tangent, program.groups)
    g0 = grad0.to(_F64)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    s = _FusedState(
        x=x0,
        cost=cost0,
        radius=torch.tensor(config.initial_trust_region_radius, dtype=_F64, device=dev),
        decrease_factor=torch.tensor(2.0, dtype=_F64, device=dev),
        iteration=0,
        successful_steps=i32(0),
        unsuccessful_steps=i32(0),
        invalid_in_a_row=i32(0),
        termination=torch.where(
            torch.max(torch.abs(g0)) <= config.gradient_tolerance,
            _CONVERGENCE,
            _RUNNING,
        ).to(torch.int32),
        linear_iterations=i32(0),
        gmax=torch.max(torch.abs(g0)),
        gnorm=torch.linalg.norm(g0),
        last_accept=torch.tensor(True, device=dev),
    )
    while s.iteration < max_num_iterations and int(s.termination) == _RUNNING:
        s = _body(s, program, solve_aux, config)
    return s, cost0


def run_fused(options, problem, device="cuda", *, host_loop_parity: bool):
    """Shared body of :func:`fused_solve` and ``solver.solve``."""
    t0 = time.perf_counter()
    device = torch.device(device)
    program = problem.program(device)
    if options.evaluation_dtype is not None:
        cast_program(program, options.evaluation_dtype)
    resolved = dataclasses.replace(
        options,
        linear_solver_type=options.resolved_linear_solver_type(program.num_tangent),
    )
    check_supported(resolved)
    config = _FusedConfig(
        solve=_config_from_options(resolved),
        function_tolerance=resolved.function_tolerance,
        gradient_tolerance=resolved.gradient_tolerance,
        parameter_tolerance=resolved.parameter_tolerance,
        min_relative_decrease=resolved.min_relative_decrease,
        initial_trust_region_radius=resolved.initial_trust_region_radius,
        max_trust_region_radius=resolved.max_trust_region_radius,
        min_trust_region_radius=resolved.min_trust_region_radius,
        max_invalid_steps=resolved.max_num_consecutive_invalid_steps,
        jacobi_scaling=resolved.jacobi_scaling,
        revert_on_tolerance=host_loop_parity,
    )
    solve_aux = _build_solve_aux(resolved, program)
    x0 = torch.from_numpy(program.initial_ambient()).to(device, program.eval_dtype)
    t1 = time.perf_counter()
    final, cost0 = _fused_minimize(
        x0, program, solve_aux, resolved.max_num_iterations, config
    )
    term = int(final.termination)  # waits for the device
    t2 = time.perf_counter()

    summary = SolverSummary()
    summary.fixed_cost = program.fixed_cost
    summary.initial_cost = float(cost0) + program.fixed_cost
    summary.final_cost = float(final.cost) + program.fixed_cost
    summary.num_iterations = final.iteration
    summary.num_successful_steps = int(final.successful_steps)
    summary.num_unsuccessful_steps = int(final.unsuccessful_steps)
    summary.minimizer_type = resolved.minimizer_type
    summary.linear_solver_type_used = resolved.linear_solver_type
    if term == _CONVERGENCE:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Fused minimizer converged."
    elif term == _FAILURE:
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Too many consecutive invalid steps."
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = f"Maximum iterations reached ({final.iteration})."
    summary.num_linear_solver_iterations = int(final.linear_iterations)
    summary.num_parameter_blocks = program.num_parameter_blocks()
    summary.num_parameters = program.num_ambient
    summary.num_effective_parameters = program.num_tangent
    summary.num_residuals = program.num_residuals()
    if summary.is_solution_usable():
        problem.write_back(final.x.to(_F64).cpu().numpy())
    summary.preprocessor_time_in_seconds = t1 - t0
    summary.minimizer_time_in_seconds = t2 - t1
    summary.total_time_in_seconds = time.perf_counter() - t0
    return summary


def fused_solve(options, problem, device="cuda") -> SolverSummary:
    """Solve on ``device`` (the card by default; without one that raises, it
    does not move to the CPU) with the fused LM loop; returns a SolverSummary
    and writes the solution back (the entry point bench.py drives in the
    JAX package). A step that meets the function/parameter tolerance is
    kept, as in the JAX package's fused_solve."""
    return run_fused(options, problem, device, host_loop_parity=False)
