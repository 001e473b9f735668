"""Levenberg-Marquardt core shared by the solve loop (port of the LM part
of ``ceres_tpu/trust_region.py``): the linear-solve configuration, the
preprocessor-built solve structures, the LM damping and the linear-solve
dispatch with its mixed-precision refinement."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ceres_tpu_torch.linear.cg import direct_termination
from ceres_tpu_torch.linear.cgnr import solve_cgnr
from ceres_tpu_torch.linear.dense import solve_dense_normal_cholesky, solve_dense_qr
from ceres_tpu_torch.linear.schur import (
    EXPLICIT_S_AUTO_MAX_NF,
    build_schur_structure,
    solve_schur,
)
from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
from ceres_tpu_torch.ordered_groups import normalize_ordering, validate_ordering_partition
from ceres_tpu_torch.types import LinearSolverType, PreconditionerType

@dataclasses.dataclass
class IterationSummary:
    """Analog of ceres::IterationSummary (iteration_callback.h): one record
    per LM iteration, record 0 being the starting point."""

    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


_SCHUR_TYPES = (
    LinearSolverType.DENSE_SCHUR,
    LinearSolverType.ITERATIVE_SCHUR,
    LinearSolverType.SPARSE_SCHUR,
)


@dataclasses.dataclass(frozen=True)
class _SolveConfig:
    """The scalar/enum subset of SolverOptions the linear solve reads."""

    linear_solver_type: LinearSolverType
    preconditioner_type: PreconditionerType
    eta: float
    max_linear_solver_iterations: int
    min_linear_solver_iterations: int
    max_num_spse_iterations: int
    spse_tolerance: float
    use_spse_initialization: bool
    use_explicit_schur_complement: bool
    min_lm_diagonal: float
    max_lm_diagonal: float
    use_mixed_precision_solves: bool
    num_refinement_iterations: int


def _config_from_options(options) -> _SolveConfig:
    return _SolveConfig(
        linear_solver_type=options.linear_solver_type,
        preconditioner_type=options.preconditioner_type,
        eta=options.eta,
        max_linear_solver_iterations=options.max_linear_solver_iterations,
        min_linear_solver_iterations=options.min_linear_solver_iterations,
        max_num_spse_iterations=options.max_num_spse_iterations,
        spse_tolerance=options.spse_tolerance,
        use_spse_initialization=options.use_spse_initialization,
        use_explicit_schur_complement=options.use_explicit_schur_complement,
        min_lm_diagonal=options.min_lm_diagonal,
        max_lm_diagonal=options.max_lm_diagonal,
        use_mixed_precision_solves=options.use_mixed_precision_solves,
        num_refinement_iterations=max(options.max_num_refinement_iterations, 1),
    )


def _build_solve_aux(options, program) -> dict:
    """Preprocessor-built index structures (the block-Jacobi groups, the
    Schur elimination structure with, for a small reduced system, the
    explicit-S assembly plan, and the SUBSET preconditioner's row masks),
    memoized on the program per structural option set."""
    subset = options.residual_blocks_for_subset_preconditioner
    groups = normalize_ordering(options.linear_solver_ordering)
    key = (
        options.linear_solver_type,
        options.preconditioner_type,
        options.use_explicit_schur_complement,
        tuple(tuple(sorted(int(p) for p in g)) for g in groups) if groups else None,
        tuple(sorted(int(r) for r in subset)) if subset else None,
    )
    hit = program.solve_aux_cache.get(key)
    if hit is not None:
        return hit
    ss = None
    if options.linear_solver_type in _SCHUR_TYPES:
        ordering = None
        if groups:
            # Group 0 is eliminated first; more groups must partition the
            # active blocks (ordered_groups.h) and order the reduced system,
            # which is inert for the dense and iterative reduced solves.
            if len(groups) > 1:
                validate_ordering_partition(program, groups)
            ordering = list(groups[0])
        ss = program.schur_structure
        if ss is None or ordering is not None:
            ss = build_schur_structure(program, ordering=ordering)
            program.schur_structure = ss
        # DENSE/SPARSE_SCHUR always assemble S; ITERATIVE_SCHUR does when
        # the reduced camera system is small (EXPLICIT_S_AUTO_MAX_NF).
        if ss.explicit is None and (
            options.linear_solver_type != LinearSolverType.ITERATIVE_SCHUR
            or options.use_explicit_schur_complement
            or int(ss.f_idx.shape[0]) <= EXPLICIT_S_AUTO_MAX_NF
        ):
            ss.explicit = build_explicit_plan(program, ss)
    subset_masks = None
    if options.preconditioner_type == PreconditionerType.SUBSET and subset:
        rids = np.asarray(sorted(int(r) for r in subset), dtype=np.int64)
        subset_masks = tuple(
            torch.from_numpy(np.isin(f.residual_ids, rids).astype(np.float64)).to(
                program.device, program.eval_dtype
            )
            for f in program.families
        )
    aux = {"bd_groups": program.groups, "ss": ss, "subset_masks": subset_masks}
    program.solve_aux_cache[key] = aux
    return aux


def _lm_damping(diag: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """LM damping D = sqrt(diag / radius)
    (levenberg_marquardt_strategy.cc:78-95), floored in f32 at
    sqrt(eps_f32) * sqrt(diag): below that D^2 adds nothing representable
    to the J'J diagonal and gauge-singular systems go undamped."""
    D = torch.sqrt(diag / radius.to(diag.dtype))
    if D.dtype == torch.float32:
        D = torch.maximum(D, torch.sqrt(diag) * 3.5e-4)
    return D


def _base_linear_solve(ctx, D, solve_aux, config: _SolveConfig, rhs=None):
    """LinearSolver::Solve dispatch (linear_solver.cc:75). Returns (y,
    num_iterations, termination) with linear/cg.py termination codes:
    iterative solvers report their CG termination (FAILURE on breakdown),
    direct solvers FAILURE on a non-finite result. ``rhs``: an explicit
    tangent right-hand side in place of J'f."""
    lst = config.linear_solver_type
    if lst in _SCHUR_TYPES:
        return solve_schur(ctx, D, config, solve_aux["ss"], rhs=rhs)
    one = torch.ones((), dtype=torch.int32, device=D.device)
    if lst == LinearSolverType.DENSE_QR:
        y = solve_dense_qr(ctx, D, rhs=rhs)
        return y, one, direct_termination(y)
    if lst == LinearSolverType.DENSE_NORMAL_CHOLESKY:
        y = solve_dense_normal_cholesky(ctx, D, rhs=rhs)
        return y, one, direct_termination(y)
    if lst == LinearSolverType.CGNR:
        jacobi = config.preconditioner_type == PreconditionerType.JACOBI
        res = solve_cgnr(
            ctx,
            D,
            preconditioner_type=config.preconditioner_type,
            bd_groups=solve_aux["bd_groups"] if jacobi else None,
            max_num_iterations=config.max_linear_solver_iterations,
            min_num_iterations=config.min_linear_solver_iterations,
            q_tolerance=config.eta,
            r_tolerance=-1.0,
            rhs=rhs,
            subset_masks=solve_aux.get("subset_masks"),
        )
        return res.x, res.num_iterations, res.termination
    raise NotImplementedError(
        f"linear solver {lst.name}: ROADMAP Queue 1 item 14b (host-driven "
        "sparse solvers)"
    )


def _solve_aux_as(solve_aux: dict, dtype: torch.dtype) -> dict:
    """The solve structures with their floating arrays in ``dtype``."""
    ss, masks = solve_aux["ss"], solve_aux.get("subset_masks")
    return dict(
        solve_aux,
        ss=None if ss is None else ss.to_dtype(dtype),
        subset_masks=None if masks is None else tuple(m.to(dtype) for m in masks),
    )


def _linear_solve(ctx, D, solve_aux, config: _SolveConfig, rhs=None):
    """The dispatch with the mixed-precision wrapper
    (``use_mixed_precision_solves``; dense_cholesky.h:104-246,
    iterative_refiner.{h,cc}): every solve in f32, the refinement residual
    rhs - (J'J + D^2) y and the accumulation of y in f64, with
    ``num_refinement_iterations`` refinement steps; the iteration counts
    add up and the termination is the worst of the solves'. The result is
    then f64 whatever the evaluation dtype."""
    if not config.use_mixed_precision_solves:
        return _base_linear_solve(ctx, D, solve_aux, config, rhs=rhs)
    f32, f64 = torch.float32, torch.float64
    ctx32, ctx64 = ctx.to_dtype(f32), ctx.to_dtype(f64)
    D32, D64 = D.to(f32), D.to(f64)
    aux32 = _solve_aux_as(solve_aux, f32)
    rhs64 = ctx64.gradient() if rhs is None else rhs.to(f64)
    y32, iters, term = _base_linear_solve(ctx32, D32, aux32, config, rhs=rhs64.to(f32))
    y = y32.to(f64)
    for _ in range(config.num_refinement_iterations):
        r = rhs64 - (ctx64.normal_matvec(y) + (D64 * D64) * y)
        dy32, it, t = _base_linear_solve(ctx32, D32, aux32, config, rhs=r.to(f32))
        y = y + dy32.to(f64)
        iters = iters + it
        term = torch.maximum(term, t)
    return y, iters, term
