"""The Levenberg-Marquardt loop with every tensor on the device (port of
``ceres_tpu/fused_lm.py``).

Each iteration evaluates residuals and Jacobian blocks (loss-corrected,
in the tangent space of the blocks' manifolds), applies Jacobi column
scaling and LM damping, solves for the step (``trust_region._linear_solve``),
takes the model cost change in f64, evaluates the candidate cost, and updates the
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
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.trust_region import (
    IterationSummary,
    _SolveConfig,
    _build_solve_aux,
    _config_from_options,
    candidate_point,
    lm_step,
)
from ceres_tpu_torch.types import MinimizerType, TerminationType, TrustRegionStrategyType

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


# Columns of one iteration's trace row (all f64): the iterate entering the
# iteration (cost, gradient norms, radius, ||x||) and the step taken in it.
_TRACE_FIELDS = (
    "state_cost", "state_gmax", "state_gnorm", "state_radius", "step_norm",
    "step_rho", "step_cost_change", "step_lin_iters", "step_valid",
    "step_accept", "step_xnorm",
)


def _body(s: _FusedState, program, solve_aux, config: _FusedConfig, trace: bool):
    """One LM iteration: (next state, trace row or None)."""
    sc = config.solve
    families = program.families
    cost, grad, ctx = _full_impl(s.x, families, program.num_tangent, program.groups,
                                 comm=program.comm)

    scaling = norms0 = None
    if config.jacobi_scaling:
        # The scaling of this iterate's Jacobian (the host loop fixes it at
        # iteration 0; the step does not depend on it but for rounding and
        # the clipped LM diagonal).
        norms0 = ctx.squared_column_norms()
        scaling = 1.0 / (1.0 + torch.sqrt(norms0))
    _, step_scaled, mcc, lin_iters, lin_term = lm_step(ctx, s.radius, solve_aux, sc, scaling, norms0)
    # A linear-solver FAILURE invalidates the step (linear_solver.h:57).
    step_is_valid = torch.isfinite(mcc) & (mcc > 0.0) & (lin_term < CG_FAILURE)

    candidate = candidate_point(program.plus_struct, s.x, step_scaled, scaling)
    cand_cost = _cost_impl(candidate, families, comm=program.comm)
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
    row = None
    if trace:
        row = torch.stack(
            [cost, gmax, gnorm, s.radius, step_norm, rho, cost - cand_cost,
             lin_iters.to(_F64), step_is_valid.to(_F64), accept.to(_F64), x_norm]
        )
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
    ), row


def _fused_minimize(x0, program, solve_aux, max_num_iterations: int,
                    config: _FusedConfig, trace: bool = False):
    """Run the LM loop from x0; returns (final state, initial cost, trace),
    the trace a (iterations, len(_TRACE_FIELDS)) f64 device tensor or None."""
    dev = x0.device
    cost0, grad0, _ = _full_impl(x0, program.families, program.num_tangent, program.groups,
                                 comm=program.comm)
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
    rows = []
    while s.iteration < max_num_iterations and int(s.termination) == _RUNNING:
        s, row = _body(s, program, solve_aux, config, trace)
        rows.append(row)
    return s, cost0, (torch.stack(rows) if trace and rows else None)


def _fill_records(summary, opts, final, cost0: float, tr):
    """Fill ``summary`` with the IterationSummary records, termination type
    and message the JAX package's solve reports (its host loop's
    bookkeeping, rebuilt from the trace as ``minimize_fused_traced`` does).
    ``final``: host scalars of the final state; ``tr``: {field: (T,) numpy}."""
    T = final["iteration"]
    fixed = summary.fixed_cost
    last = max(T - 1, 0)
    term_code = final["termination"]
    if T == 0:
        reason = "grad" if term_code == _CONVERGENCE else "max_iters"
    elif term_code == _CONVERGENCE:
        snorm = float(tr["step_norm"][last])
        xnorm = float(tr["step_xnorm"][last])
        cchange = abs(float(tr["step_cost_change"][last]))
        prev_cost = float(tr["state_cost"][last])
        valid = bool(tr["step_valid"][last])
        had_success = final["successful_steps"] - int(bool(tr["step_accept"][last])) > 0
        if (
            valid
            and had_success
            and snorm <= opts.parameter_tolerance * (xnorm + opts.parameter_tolerance)
        ):
            reason = "param"
        elif valid and cchange <= opts.function_tolerance * prev_cost:
            reason = "func"
        elif final["gmax"] <= opts.gradient_tolerance:
            reason = "grad"
        else:
            reason = "radius"
    elif term_code == _FAILURE:
        reason = "invalid"
    else:
        reason = "max_iters"

    # The host loop appends it_0 .. it_T, except the last trip's record
    # when it returned before appending (param/func/invalid).
    records = [
        IterationSummary(
            iteration=0,
            cost=(float(tr["state_cost"][0]) if T > 0 else cost0) + fixed,
            gradient_max_norm=float(tr["state_gmax"][0]) if T > 0 else final["gmax"],
            gradient_norm=float(tr["state_gnorm"][0]) if T > 0 else final["gnorm"],
            trust_region_radius=float(tr["state_radius"][0])
            if T > 0
            else opts.initial_trust_region_radius,
            eta=opts.eta,
            step_is_valid=True,
            step_is_successful=True,
        )
    ]
    n_emit = T if reason in ("grad", "radius", "max_iters") else max(T - 1, 0)
    for k in range(1, n_emit + 1):
        if k < T:
            state = tuple(
                float(tr[f][k])
                for f in ("state_cost", "state_gmax", "state_gnorm", "state_radius")
            )
        else:
            state = (final["cost"], final["gmax"], final["gnorm"], final["radius"])
        records.append(
            IterationSummary(
                iteration=k,
                cost=state[0] + fixed,
                cost_change=float(tr["step_cost_change"][k - 1]),
                gradient_max_norm=state[1],
                gradient_norm=state[2],
                step_norm=float(tr["step_norm"][k - 1]),
                relative_decrease=float(tr["step_rho"][k - 1]),
                trust_region_radius=state[3],
                eta=opts.eta,
                linear_solver_iterations=int(tr["step_lin_iters"][k - 1]),
                step_is_valid=bool(tr["step_valid"][k - 1]),
                step_is_successful=bool(tr["step_accept"][k - 1]),
            )
        )
    summary.iterations = records

    summary.termination_type = TerminationType.CONVERGENCE
    if reason == "param":
        snorm = float(tr["step_norm"][last])
        xnorm = float(tr["step_xnorm"][last])
        summary.message = (
            f"Parameter tolerance reached. Relative step_norm: "
            f"{snorm / (xnorm + opts.parameter_tolerance):e} <= "
            f"{opts.parameter_tolerance:e}."
        )
    elif reason == "func":
        cchange = abs(float(tr["step_cost_change"][last]))
        prev_cost = float(tr["state_cost"][last])
        summary.message = (
            f"Function tolerance reached. |cost_change|/cost: "
            f"{cchange / prev_cost if prev_cost else 0.0:e} <= "
            f"{opts.function_tolerance:e}"
        )
    elif reason == "grad":
        summary.message = (
            f"Gradient tolerance reached. Gradient max norm: "
            f"{final['gmax']:e} <= {opts.gradient_tolerance:e}"
        )
    elif reason == "radius":
        summary.message = (
            "Minimum trust region radius reached. Trust region radius: "
            f"{final['radius']:e} <= {opts.min_trust_region_radius:e}"
        )
    elif reason == "invalid":
        summary.termination_type = TerminationType.FAILURE
        summary.message = (
            "Number of consecutive invalid steps more than "
            "Solver::Options::max_num_consecutive_invalid_steps: "
            f"{opts.max_num_consecutive_invalid_steps}"
        )
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = (
            f"Maximum number of iterations reached. Number of iterations: {T}."
        )


def _fused_config(resolved, revert_on_tolerance: bool) -> _FusedConfig:
    return _FusedConfig(
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
        revert_on_tolerance=revert_on_tolerance,
    )


# The JAX package's trace lengths: the traced loop runs at most 2048
# iterations, and ``solve`` gives a longer budget to the host loop.
_MAX_TRACED_ITERATIONS = 2048


def fused_traced_eligible(options, program) -> bool:
    """Whether ``solve`` can run the fused loop and still give the complete
    Summary/IterationSummary records (the JAX package's condition). Any
    feature that needs host work between the step and the candidate
    (bounds, inner iterations, callbacks, gradient checks, dumps, live
    progress printing, non-monotonic step bookkeeping, a wall-clock budget)
    goes to the host loop, ``trust_region.TrustRegionMinimizer``."""
    return (
        options.minimizer_type == MinimizerType.TRUST_REGION
        and options.trust_region_strategy_type == TrustRegionStrategyType.LEVENBERG_MARQUARDT
        and not program.has_bounds
        and not options.use_inner_iterations
        and not options.callbacks
        and options.evaluation_callback is None
        and not options.check_gradients
        and not options.update_state_every_iteration
        and not options.use_nonmonotonic_steps
        and not options.minimizer_progress_to_stdout
        and not (
            options.trust_region_problem_dump_directory
            and options.trust_region_minimizer_iterations_to_dump
        )
        and options.max_solver_time_in_seconds >= 1e6
        and options.linear_solver_type is not None
        and options.linear_solver_type.name not in ("SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR")
        and 0 < options.max_num_iterations <= _MAX_TRACED_ITERATIONS
    )


def minimize_fused_traced(resolved, program, x0, summary) -> torch.Tensor:
    """Run the fused loop with a per-iteration trace and fill ``summary``
    with the records, termination and counters the host loop would give
    (a step meeting the parameter or function tolerance is not applied, as
    the host loop returns before it). Returns the final x (device)."""
    t0 = time.perf_counter()
    final, cost0, trace = _fused_minimize(
        x0, program, _build_solve_aux(resolved, program), resolved.max_num_iterations,
        _fused_config(resolved, revert_on_tolerance=True), trace=True,
    )
    # One batched read of the per-iteration trace and one of the final
    # scalars.
    tr_host = None if trace is None else trace.cpu().numpy()
    tr = {} if tr_host is None else {f: tr_host[:, i] for i, f in enumerate(_TRACE_FIELDS)}
    cost0, term, succ, cost, gmax, gnorm, radius = torch.stack([
        cost0, final.termination.to(_F64), final.successful_steps.to(_F64), final.cost,
        final.gmax, final.gnorm, final.radius,
    ]).cpu().tolist()
    T = final.iteration
    summary.num_iterations = T
    host_final = dict(
        iteration=T, termination=int(term), successful_steps=int(succ), cost=cost,
        gmax=gmax, gnorm=gnorm, radius=radius,
    )
    _fill_records(summary, resolved, host_final, cost0, tr)
    # The whole solve is one device computation.
    summary.linear_solver_time_in_seconds += time.perf_counter() - t0
    summary.num_linear_solves += T
    summary.num_residual_evaluations += T + 1
    summary.num_jacobian_evaluations += T + 1
    return final.x


# What the fused loop cannot honour and fused_solve refuses rather than drop.
_HOST_LOOP_OPTIONS = (
    "callbacks", "evaluation_callback", "minimizer_progress_to_stdout",
    "update_state_every_iteration", "use_nonmonotonic_steps", "use_inner_iterations",
    "check_gradients",
)


def fused_solve(options, problem, device="cuda") -> SolverSummary:
    """Solve on ``device`` (the card by default; without one that raises, it
    does not move to the CPU) with the fused LM loop; returns a SolverSummary
    and writes the solution back (the entry point bench.py drives in the
    JAX package). A step that meets the function/parameter tolerance is
    kept, as in the JAX package's fused_solve. Options only the host loop
    or the line search honours (DOGLEG, LINE_SEARCH, inner iterations,
    gradient checks, bounds, callbacks, progress output, non-monotonic
    steps, a time budget, dumps) raise ``ValueError``: ``solve`` runs
    them. With ``mesh`` the solve is sharded as ``solve``'s is (the JAX
    package's fused_lm.py:364-396)."""
    t0 = time.perf_counter()
    summary = SolverSummary()
    prep = preprocess(options, problem, device, summary)
    if prep is None:
        summary.total_time_in_seconds = time.perf_counter() - t0
        return summary
    program, resolved = prep
    refused = [f for f in _HOST_LOOP_OPTIONS if getattr(resolved, f)]
    if resolved.minimizer_type != MinimizerType.TRUST_REGION:
        refused.append(f"minimizer_type={resolved.minimizer_type}")
    if resolved.trust_region_strategy_type != TrustRegionStrategyType.LEVENBERG_MARQUARDT:
        refused.append(f"trust_region_strategy_type={resolved.trust_region_strategy_type}")
    if program.has_bounds:
        refused.append("parameter bounds")
    if resolved.max_solver_time_in_seconds < 1e6:
        refused.append("max_solver_time_in_seconds")
    if resolved.trust_region_problem_dump_directory and resolved.trust_region_minimizer_iterations_to_dump:
        refused.append("trust-region problem dumps")
    if refused:
        raise ValueError(
            f"fused_solve runs the fused loop, which cannot honour {', '.join(refused)}; "
            "ctt.solve runs them on the host-loop or line-search minimizer"
        )
    solve_aux = _build_solve_aux(resolved, program)
    x0 = initial_state(program, options.mesh)
    t1 = time.perf_counter()
    final, cost0, _ = _fused_minimize(
        x0, program, solve_aux, resolved.max_num_iterations,
        _fused_config(resolved, revert_on_tolerance=False),
    )
    term = int(final.termination)  # waits for the device
    t2 = time.perf_counter()
    summary.num_iterations = final.iteration
    summary.initial_cost = float(cost0) + program.fixed_cost
    summary.final_cost = float(final.cost) + program.fixed_cost
    summary.num_successful_steps = int(final.successful_steps)
    summary.num_unsuccessful_steps = int(final.unsuccessful_steps)
    summary.num_linear_solver_iterations = int(final.linear_iterations)
    if term == _CONVERGENCE:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Fused minimizer converged."
    elif term == _FAILURE:
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Too many consecutive invalid steps."
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = f"Maximum iterations reached ({final.iteration})."
    if summary.is_solution_usable():
        problem.write_back(final.x.to(_F64).cpu().numpy())
    summary.preprocessor_time_in_seconds = t1 - t0
    summary.minimizer_time_in_seconds = t2 - t1
    summary.total_time_in_seconds = time.perf_counter() - t0
    return summary
