"""Trust-region minimizer: the Levenberg-Marquardt core both loops share
and the host loop (port of ``ceres_tpu/trust_region.py``; analog of
``internal/ceres/trust_region_minimizer.{h,cc}:68-841``,
``levenberg_marquardt_strategy.cc`` and ``trust_region_step_evaluator.{h,cc}``).

The core: the linear-solve configuration, the preprocessor-built solve
structures, the LM damping, the linear-solve dispatch with its
mixed-precision refinement, and ``lm_step`` / ``candidate_point``, the step
and candidate that the fused loop (``fused_lm._body``) and this host loop
both take.

The host loop (``TrustRegionMinimizer``) keeps the data-dependent control
flow on the host as the reference does — accept or reject, the radius, the
four convergence tests, non-monotonic steps, callbacks, progress output,
bounds, the time budget, the DOGLEG strategy (``dogleg.py``), inner
iterations (``inner_iterations.py``) and the gradient check at each accepted
iterate (``gradient_checker.py``) — and reads the device where the JAX
package's loop reads it: once per iteration on the fused-iteration branch
(step, candidate and a speculative evaluation at the candidate, eight
scalars in one read), two or three times on the step-by-step branch, once
more per trial of the bounds line search, and, under DOGLEG, once per
Gauss-Newton solve and once for the step (twice more for a subspace step).
The device work between two reads runs from ``host_loop_graphs.py``: on
static buffers, and on the card as CUDA graphs, as the JAX package jits it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from ceres_tpu_torch.evaluator import Evaluator, _cost_impl, _full_impl
from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_FATAL_ERROR, CG_SUCCESS, direct_termination
from ceres_tpu_torch.linear.cgnr import solve_cgnr
from ceres_tpu_torch.linear.dense import solve_dense_normal_cholesky, solve_dense_qr
from ceres_tpu_torch.linear.preconditioners import build_subset_plan
from ceres_tpu_torch.linear.schur import (
    EXPLICIT_S_AUTO_MAX_NF,
    attach_clusters,
    build_schur_structure,
    solve_schur,
)
from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
from ceres_tpu_torch.linear.sparse_cholesky import solve_sparse_normal_cholesky
from ceres_tpu_torch.ordered_groups import normalize_ordering, validate_ordering_partition
from ceres_tpu_torch.problem import plus_apply
from ceres_tpu_torch.types import (
    CallbackReturnType,
    LinearSolverType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

_DBL_MAX = float(np.finfo(np.float64).max)
_F64 = torch.float64


class TrustRegionStepEvaluator:
    """Non-monotonic step acceptance (trust_region_step_evaluator.cc,
    Conn/Gould/Toint Algorithm 10.1.2)."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int):
        self.max_nonmonotonic = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        if cost >= _DBL_MAX:
            return -_DBL_MAX
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical)

    def step_accepted(self, cost: float, model_cost_change: float) -> None:
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if self.num_consecutive_nonmonotonic_steps == self.max_nonmonotonic:
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )


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


class LevenbergMarquardtStrategy:
    """Radius/damping state machine (levenberg_marquardt_strategy.cc)."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.decrease_factor = 2.0

    def step_accepted(self, step_quality: float) -> None:
        # levenberg_marquardt_strategy.cc:158-165
        self.radius = self.radius / max(1.0 / 3.0, 1.0 - (2.0 * step_quality - 1.0) ** 3)
        self.radius = min(self.max_radius, self.radius)
        self.decrease_factor = 2.0

    def step_rejected(self, step_quality: float) -> None:
        # levenberg_marquardt_strategy.cc:167-171
        del step_quality
        self.radius = self.radius / self.decrease_factor
        self.decrease_factor *= 2.0

    step_is_invalid = step_rejected


_SCHUR_TYPES = (
    LinearSolverType.DENSE_SCHUR,
    LinearSolverType.ITERATIVE_SCHUR,
    LinearSolverType.SPARSE_SCHUR,
)


_CLUSTER_TYPES = (PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL)
_SPARSE_TYPES = (LinearSolverType.SPARSE_NORMAL_CHOLESKY, LinearSolverType.SPARSE_SCHUR)
# The solvers that a sharded program runs in the gathered form: every rank
# gathers the whole Jacobian and runs the one-process solver, and rank 0's
# result is broadcast (parallel/sharding.py). The others are distributed,
# the sparse ones as the JAX package computes them: each rank's cells
# all-reduced before the host factor, rank 0's solution broadcast after it.
_GATHERED_TYPES = (LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY)


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
    # the host sparse factorizations (SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR)
    dynamic_sparsity: bool = False
    ordering_type: str = "AMD"  # LinearSolverOrderingType name
    use_postordering: bool = False


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
        dynamic_sparsity=options.dynamic_sparsity,
        ordering_type=options.linear_solver_ordering_type.name,
        use_postordering=options.use_postordering,
    )


def _build_solve_aux(options, program) -> dict:
    """Preprocessor-built index structures (the block-Jacobi groups, the
    Schur elimination structure with, for a small reduced system, the
    explicit-S assembly plan, and the SUBSET preconditioner's row masks),
    memoized on the program per structural option set. A sharded program's
    gathered-form solvers get those of the whole program."""
    if program.comm is not None and options.linear_solver_type in _GATHERED_TYPES:
        return _build_solve_aux(options, program.unsharded())
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
        # The cluster preconditioners' camera clusters (and, for
        # CLUSTER_TRIDIAGONAL, their chains), computed by the native core.
        with_forest = options.preconditioner_type == PreconditionerType.CLUSTER_TRIDIAGONAL
        if options.preconditioner_type in _CLUSTER_TYPES and (
            ss.cluster_groups is None or (with_forest and ss.chain_clusters is None)
        ):
            attach_clusters(program, ss, with_forest=with_forest)
        # DENSE/SPARSE_SCHUR always assemble S; ITERATIVE_SCHUR does when
        # the reduced camera system is small (EXPLICIT_S_AUTO_MAX_NF).
        if ss.explicit is None and (
            options.linear_solver_type != LinearSolverType.ITERATIVE_SCHUR
            or options.use_explicit_schur_complement
            or int(ss.f_idx.shape[0]) <= EXPLICIT_S_AUTO_MAX_NF
        ):
            ss.explicit = build_explicit_plan(program, ss)
    subset_masks = subset_plan = None
    if options.preconditioner_type == PreconditionerType.SUBSET and subset:
        rids = np.asarray(sorted(int(r) for r in subset), dtype=np.int64)
        subset_masks = tuple(
            torch.from_numpy(np.isin(f.residual_ids, rids).astype(np.float64)).to(
                program.device, program.eval_dtype
            )
            for f in program.families
        )
        subset_plan = build_subset_plan(program.families, program.groups, program.num_tangent,
                                        subset_masks)
    aux = {"bd_groups": program.groups, "ss": ss, "subset_masks": subset_masks,
           "subset_plan": subset_plan}
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
    tangent right-hand side in place of J'f. On a sharded ``ctx`` the
    gathered-form solvers solve the gathered context and take rank 0's
    result."""
    lst = config.linear_solver_type
    if ctx.comm is not None and lst in _GATHERED_TYPES:
        y, iters, term = _base_linear_solve(ctx.gathered(), D, solve_aux, config, rhs=rhs)
        y, iters, term = _broadcast_scalars(ctx.comm, y, iters, term)
        return y, iters.to(torch.int32), term.to(torch.int32)
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
            subset_plan=solve_aux.get("subset_plan"),
        )
        return res.x, res.num_iterations, res.termination
    if lst == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        # The exact host factorization, with the Jacobian sent to the host
        # (the whole problem's on a sharded ctx, ``evaluator.to_crs``): the
        # fused loop's solve and its refinement corrections (the host
        # loop's sparse steps and DOGLEG's Gauss-Newton solve reduce J'J's
        # cells on the card), what the JAX package computes in its graph
        # through a host callback.
        return solve_sparse_normal_cholesky(
            ctx, D, rhs=rhs, dynamic=config.dynamic_sparsity, ordering=config.ordering_type,
            use_postordering=config.use_postordering,
        )
    raise ValueError(f"unsupported linear solver {lst}")


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


# -- the step both loops take -------------------------------------------------


def _model_cost_change(ctx, step: torch.Tensor) -> torch.Tensor:
    """-(J step)'(f + J step / 2), accumulated in f64
    (trust_region_minimizer.cc:424-438): f32 cancellation here makes tiny
    steps near the optimum look invalid (mcc <= 0 noise)."""
    Js = ctx.matvec(step)
    mcc = torch.zeros((), dtype=_F64, device=step.device)
    for fi in range(len(ctx.families)):
        j64 = Js[fi].to(_F64)
        mcc = mcc - torch.sum(j64 * (ctx.residuals[fi].to(_F64) + j64 / 2.0))
    return ctx._sum(mcc)


def _broadcast_scalars(comm, vec: torch.Tensor, *scalars: torch.Tensor):
    """Rank 0's vector and scalars on every rank, in one broadcast: the
    vector in its dtype, the scalars as f64 (exact for the counts and
    codes)."""
    packed = torch.cat([vec.to(_F64)] + [s.to(_F64).reshape(1) for s in scalars])
    packed = comm.broadcast(packed)
    n = vec.numel()
    return (packed[:n].to(vec.dtype), *packed[n:].unbind())


def lm_step(ctx, radius: torch.Tensor, solve_aux, config: _SolveConfig, scaling=None,
            norms=None):
    """One LM step (levenberg_marquardt_strategy.cc:78-95): the Jacobi
    column scaling (``scaling``; None = none), the clipped LM diagonal, the
    damping, the linear solve and the model cost change. ``norms``: diag(J'J)
    of the unscaled ``ctx`` when the caller has it (the scaled norms are then
    scaling^2 * norms, one column-norm pass). Returns (the context the step
    was solved with, the scaled step, the model cost change f64, linear
    iterations, linear termination)."""
    if norms is None:
        norms = ctx.squared_column_norms()
    if scaling is not None:
        ctx = ctx.scale_columns(scaling)
        norms = scaling * scaling * norms
    diag = torch.clamp(norms, config.min_lm_diagonal, config.max_lm_diagonal)
    D = _lm_damping(diag, radius)
    y, lin_iters, lin_term = _linear_solve(ctx, D, solve_aux, config)
    # a mixed-precision solve returns an f64-refined y; the step is applied
    # to the evaluation-dtype state
    step_scaled = -y.to(diag.dtype)
    return ctx, step_scaled, _model_cost_change(ctx, step_scaled), lin_iters, lin_term


def candidate_point(plus_struct, x: torch.Tensor, step_scaled: torch.Tensor, scaling=None):
    """x [+] (scaling * step_scaled): the candidate point of a step."""
    delta = step_scaled if scaling is None else step_scaled * scaling
    return plus_apply(plus_struct, x, delta)


def _to_host(*scalars: torch.Tensor) -> List[float]:
    """The scalars as Python floats in ONE device read (a stack of f64
    scalars and one copy): each ``float()`` of a device tensor waits for the
    device on its own."""
    return torch.stack([s.to(_F64) for s in scalars]).cpu().tolist()


def _grad_norms(grad: torch.Tensor):
    """(max |g|, ||g||) in f64."""
    g = grad.to(_F64)
    gmax = torch.max(torch.abs(g)) if g.numel() else g.new_zeros(())
    return gmax, torch.linalg.norm(g)


def _candidate_impl(x, step_scaled, scaling, families, plus_struct, apply_loss: bool,
                    comm=None):
    """Candidate point, its cost and the x / step norms (f64) without a
    Jacobian: the step-by-step branch's candidate
    (trust_region_minimizer.cc:775-793), read by the host in one read."""
    cand = candidate_point(plus_struct, x, step_scaled, scaling)
    cost = _cost_impl(cand, families, apply_loss, comm)
    step_norm = torch.linalg.norm((x - cand).to(_F64))
    x_norm = torch.linalg.norm(x.to(_F64))
    return cand, cost, step_norm, x_norm


def _tr_iteration_impl(x, ctx, radius, scaling, program, solve_aux, config: _SolveConfig,
                       apply_loss: bool):
    """One COMPLETE trust-region iteration of device work: the LM step, the
    candidate point and a *speculative* full evaluation (cost, gradient,
    Jacobian) at the candidate, which the reference performs only on an
    accepted step (HandleSuccessfulStep). A rejected step wastes that
    evaluation; in return the host reads the device once per iteration.

    Returns (candidate x, candidate context, candidate gradient, scalars),
    ``scalars`` one f64 device vector (mcc, lin_iters, lin_term, cand_cost,
    step_norm, x_norm, cand_gmax, cand_gnorm) for one host read."""
    _, step_scaled, mcc, lin_iters, lin_term = lm_step(ctx, radius, solve_aux, config, scaling)
    cand = candidate_point(program.plus_struct, x, step_scaled, scaling)
    step_norm = torch.linalg.norm((x - cand).to(_F64))
    x_norm = torch.linalg.norm(x.to(_F64))
    cand_cost, cand_grad, cand_ctx = _full_impl(
        cand, ctx.families, program.num_tangent, ctx.groups, apply_loss, ctx.comm
    )
    gmax, gnorm = _grad_norms(cand_grad)
    scalars = torch.stack([
        mcc, lin_iters.to(_F64), lin_term.to(_F64), cand_cost, step_norm, x_norm, gmax, gnorm,
    ])
    return cand, cand_ctx, cand_grad, scalars


def _lm_step_impl(ctx, radius, solve_aux, config: _SolveConfig):
    """One LM step on an already scaled context: (step, mcc, lin_iters,
    lin_term)."""
    _, step, mcc, lin_iters, lin_term = lm_step(ctx, radius, solve_aux, config)
    return step, mcc, lin_iters, lin_term


def _make_linear_solve(options, program):
    """(linear_solve(ctx, D, solve_aux, rhs=None), solve_aux) bound to this
    options/program pair: the linear solve a strategy that damps for itself
    calls (DOGLEG, ``dogleg.py``)."""
    config = _config_from_options(options)
    solve_aux = _build_solve_aux(options, program)

    def linear_solve(ctx, D, solve_aux, rhs=None):
        return _linear_solve(ctx, D, solve_aux, config, rhs=rhs)

    return linear_solve, solve_aux


# -- the host-driven sparse steps ------------------------------------------------


def _sparse_prep_impl(ctx, radius: torch.Tensor, config: _SolveConfig):
    """The card's half before a host factorization: the LM damping and the
    right-hand side J'f (levenberg_marquardt_strategy.cc:78-95)."""
    diag = torch.clamp(ctx.squared_column_norms(), config.min_lm_diagonal,
                       config.max_lm_diagonal)
    return _lm_damping(diag, radius), ctx.gradient()


def _sparse_prep_radius_free_impl(ctx, config: _SolveConfig):
    """The radius-free half: the clipped LM diagonal and J'f. The damping
    is applied on the host (:func:`_damping_np`), so a rejected step damps
    the same host copy again."""
    diag = torch.clamp(ctx.squared_column_norms(), config.min_lm_diagonal,
                       config.max_lm_diagonal)
    return diag, ctx.gradient()


def _sparse_finish_impl(ctx, y: torch.Tensor):
    """The card's half after the host solve: the step and its model cost
    change (trust_region_minimizer.cc:424-438). On a sharded program rank
    0's solution ``y``, broadcast."""
    if ctx.comm is not None:
        y = ctx.comm.broadcast(y)
    step = -y
    return step, _model_cost_change(ctx, step)


def _damping_np(diag_h: np.ndarray, radius: float) -> np.ndarray:
    """:func:`_lm_damping` on host arrays, in their dtype (with the f32
    floor)."""
    D = np.sqrt(diag_h / radius)
    if diag_h.dtype == np.float32:
        D = np.maximum(D, np.sqrt(diag_h) * np.float32(3.5e-4))
    return D.astype(diag_h.dtype)


def _step_result(step: torch.Tensor, mcc: torch.Tensor, term: int):
    dev = step.device
    return (step, mcc, torch.ones((), dtype=torch.int32, device=dev),
            torch.full((), term, dtype=torch.int32, device=dev))


def _failed_step(nt: int, dtype, dev, term: int):
    return _step_result(torch.zeros((nt,), dtype=dtype, device=dev),
                        torch.zeros((), dtype=_F64, device=dev), term)


class _SparseNormalStep:
    """The host-driven SPARSE_NORMAL_CHOLESKY LM step (trust_region.py:689 of
    the JAX package; sparse_normal_cholesky_solver.cc:51-120):
    f(ctx, radius) -> (step, model cost change, linear iterations,
    termination), J'J factored on the host between two pieces of card work,
    its symbolic analysis kept across iterations (sparse_cholesky.h:71-112).

    Static sparsity (the default): J'J is reduced on the card into block
    cells (``linear/inner_product.py``) and only the cells, the diagonal and
    J'f cross to the host, in one read. Those are radius-free, so a rejected
    step (the same context, a smaller radius) skips the card's work and the
    transfer and only damps again on the host; inside a reject streak a
    one-worker thread pre-factors at the predicted next radius (the
    strategy's doubling decrease) while the card finishes the step.
    ``dynamic_sparsity`` sends the Jacobian instead, in the same one read,
    and analyzes its pattern every iteration
    (dynamic_sparse_normal_cholesky_solver.cc).

    On a sharded program the cells are the whole program's, each rank's
    rows' placed and all-reduced inside the prep (under
    ``dynamic_sparsity`` the prep gathers the rows), every rank factors the
    same system (so every rank takes the same branch), and the finish
    broadcasts rank 0's solution."""

    def __init__(self, config: _SolveConfig, program, regions=None):
        import concurrent.futures

        from ceres_tpu_torch.host_loop_graphs import SparseRegions
        from ceres_tpu_torch.linear.inner_product import host_tangent_idx, normal_assembly

        self.config = config
        self.program = program
        # the card's halves (host_loop_graphs.SparseRegions): the host
        # loop's, captured where it is, or eager ones of this step's own
        self.regions = regions or SparseRegions(program.device, False, config)
        self.plan = self.assembly = self._executor = None
        self._state: dict = {"ctx": None}
        if config.dynamic_sparsity:
            # the whole program's blocks as they reach the host
            whole = program.unsharded()
            self._families = whole.families
            self._tidx = [host_tangent_idx(whole, fam, j) for fam in whole.families
                          for j in range(fam.num_args)]
        else:
            self.plan, self.assembly = normal_assembly(program)
            self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None

    def _host_solve(self, D_h, cells_h, rhs_h):
        from ceres_tpu_torch.linear.inner_product import host_normal_factor_solve

        c = self.config
        return host_normal_factor_solve(
            self.assembly, cells_h, D_h, rhs_h, ordering=c.ordering_type,
            use_postordering=c.use_postordering, mixed_precision=c.use_mixed_precision_solves,
            num_refinement_iterations=c.num_refinement_iterations,
        )

    def __call__(self, ctx, radius: float):
        if self.config.dynamic_sparsity:
            return self._dynamic(ctx, radius)
        state, executor, regions = self._state, self._executor, self.regions
        in_streak = state["ctx"] is ctx
        if not in_streak:
            regions.sparse_normal_prep(ctx, self.plan)
            diag_h, rhs_h, *cells_h = regions.read_flat("sparse_normal_prep")
            spec = state.pop("spec", None)
            if spec is not None:
                spec[1].cancel()
            state.update(ctx=ctx, cells=cells_h, diag=diag_h, rhs=rhs_h, pred_factor=2.0,
                         prev_radius=None)
        else:
            prev = state.get("prev_radius")
            if prev and radius < prev:
                state["pred_factor"] = (prev / radius) * 2.0  # the doubling decrease
        diag_h, cells_h, rhs_h = state["diag"], state["cells"], state["rhs"]
        spec = state.pop("spec", None)
        if spec is not None and abs(spec[0] - radius) <= 1e-9 * max(radius, 1.0):
            y, term = spec[1].result()  # factored during the last step's finish
        else:
            if spec is not None:
                spec[1].cancel()
            y, term = executor.submit(
                self._host_solve, _damping_np(diag_h, radius), cells_h, rhs_h).result()
        if in_streak:
            r_pred = radius / state["pred_factor"]
            state["spec"] = (r_pred, executor.submit(
                self._host_solve, _damping_np(diag_h, r_pred), cells_h, rhs_h))
        state["prev_radius"] = radius
        if term != CG_SUCCESS:
            return _failed_step(ctx.num_tangent, ctx.dtype, ctx.residuals[0].device, term)
        return _step_result(*regions.sparse_finish(ctx, y), term)

    def _dynamic(self, ctx, radius: float):
        from ceres_tpu_torch.evaluator import crs_from_blocks
        from ceres_tpu_torch.linear.sparse_cholesky import host_sparse_normal_solve

        c, regions = self.config, self.regions
        regions.sparse_normal_damped(ctx, radius)
        D_h, rhs_h, *blocks = regions.read_flat("sparse_normal_damped")
        y, term = host_sparse_normal_solve(
            crs_from_blocks(self._families, blocks, self._tidx, ctx.num_tangent), True, D_h,
            rhs_h, ordering=c.ordering_type,
            use_postordering=c.use_postordering, mixed_precision=c.use_mixed_precision_solves,
            num_refinement_iterations=c.num_refinement_iterations,
        )
        if term != CG_SUCCESS:
            return _failed_step(ctx.num_tangent, ctx.dtype, ctx.residuals[0].device, term)
        return _step_result(*regions.sparse_finish(ctx, y), term)


def _make_lm_step_fn(options, program, regions=None):
    """f(ctx, radius) -> (step, model_cost_change, lin_iters, lin_termination)
    for a host radius: the host-driven sparse steps for SPARSE_NORMAL_CHOLESKY
    and SPARSE_SCHUR (their card halves on ``regions``, the host loop's
    ``HostLoopGraphs``, or on eager regions of their own; on a sharded
    program too), the card's step for every other solver."""
    config = _config_from_options(options)
    if config.linear_solver_type == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        return _SparseNormalStep(config, program, regions)
    solve_aux = _build_solve_aux(options, program)
    if config.linear_solver_type == LinearSolverType.SPARSE_SCHUR:
        from ceres_tpu_torch.linear.sparse_schur import SparseSchurStep

        return SparseSchurStep(config, solve_aux, program, regions)

    def step_fn(ctx, radius: float):
        r = torch.full((), radius, dtype=_F64, device=ctx.residuals[0].device)
        return _lm_step_impl(ctx, r, solve_aux, config)

    return step_fn


# -- the host loop -------------------------------------------------------------


class TrustRegionMinimizer:
    """The outer loop (trust_region_minimizer.cc:68-136), Levenberg-Marquardt
    or DOGLEG, with inner iterations and gradient checks. Its device work
    between the host's decisions, the sparse steps' card halves included,
    runs from ``host_loop_graphs`` (static buffers; CUDA graphs where
    ``fused_lm.host_loop_capturable`` says so, or ``captured`` when given,
    which the eager baseline sets False)."""

    def __init__(self, program, options, summary, captured=None):
        from ceres_tpu_torch.fused_lm import host_loop_capturable
        from ceres_tpu_torch.host_loop_graphs import host_loop_graphs

        self.program = program
        self.options = options
        self.summary = summary
        if captured is None:
            captured = host_loop_capturable(options, program)
        self.graphs = host_loop_graphs(program, options, _build_solve_aux(options, program),
                                       captured, program.eval_dtype)
        self.evaluator = Evaluator(program, evaluation_callback=options.evaluation_callback,
                                   graphs=self.graphs)
        self.use_dogleg = options.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
        if self.use_dogleg:
            from ceres_tpu_torch.dogleg import DoglegStrategy, SparseGaussNewton

            sparse = None
            if options.linear_solver_type == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
                sparse = SparseGaussNewton(_config_from_options(options), program, self.graphs)
            self.dogleg = DoglegStrategy(options, *_make_linear_solve(options, program),
                                         graphs=self.graphs, sparse=sparse)
            self.step_fn = None
        else:
            self.step_fn = _make_lm_step_fn(options, program, self.graphs)

        # The fused iteration (one host read per loop trip,
        # _tr_iteration_impl) stands down whenever a feature needs host work
        # between the step and the candidate evaluation: DOGLEG, the bounds
        # line search, inner iterations, gradient checks, dumps, callbacks
        # that read the state or every evaluation, a host-driven sparse
        # factorization.
        self._use_fused_iteration = (
            not self.use_dogleg
            and options.linear_solver_type not in _SPARSE_TYPES
            and not program.has_bounds
            and not options.use_inner_iterations
            and not options.check_gradients
            and options.evaluation_callback is None
            and not options.update_state_every_iteration
            and not (
                options.trust_region_problem_dump_directory
                and options.trust_region_minimizer_iterations_to_dump
            )
        )
        # The card's LM step for every solver but the sparse ones, whose
        # step (step_fn) factors on the host. A caller (a test) may swap
        # self.step_fn; the fused iteration and the LM step region then
        # stand down so the replacement is what runs.
        self._default_step_fn = self.step_fn
        self._step_region = options.linear_solver_type not in _SPARSE_TYPES

        # Inner iterations (solver.h:560-600, coordinate descent).
        self.inner_minimizer = None
        self._inner_enabled = options.use_inner_iterations
        if options.use_inner_iterations:
            # its sets and plans are the program's, its regions the host
            # loop's: a second solve neither colors nor captures again
            from ceres_tpu_torch.inner_iterations import CoordinateDescentMinimizer, _ordering_key

            self.inner_minimizer = CoordinateDescentMinimizer(
                program, options, self.evaluator,
                regions=self.graphs.inner_regions(_ordering_key(options.inner_iteration_ordering)))

    def minimize(self, x0: torch.Tensor) -> torch.Tensor:
        """The solution from x0 (the regions' current point: read it before
        the program's next solve). The graphs captured in this call count
        their seconds in the summary's ``graph_capture_time_in_seconds``;
        their launches are credited at the end (one host read)."""
        graphs = self.graphs
        capture0 = graphs.capture_seconds
        try:
            return self._minimize(x0)
        finally:
            close = getattr(self._default_step_fn, "close", None)
            if close is not None:
                close()  # the sparse step's factoring thread
            graphs.credit()
            self.summary.captured_loop = graphs.captured
            self.summary.graph_capture_time_in_seconds += graphs.capture_seconds - capture0

    def _minimize(self, x0: torch.Tensor) -> torch.Tensor:
        opts = self.options
        program = self.program
        summary = self.summary
        graphs = self.graphs
        start_time = time.perf_counter()

        x = program.clamp(x0)
        strategy = self.dogleg if self.use_dogleg else LevenbergMarquardtStrategy(opts)

        # Iteration zero (trust_region_minimizer.cc:196-283). From here on x
        # and grad are the regions' current buffers (graphs.x, ...), written
        # by an evaluation at an accepted point.
        t0 = time.perf_counter()
        full = self.evaluator.cost_gradient_jacobian(x)
        x, grad = graphs.x, full.gradient
        x_cost, gmax0, gnorm0 = _to_host(full.cost, *_grad_norms(grad))
        summary.jacobian_evaluation_time_in_seconds += time.perf_counter() - t0
        summary.num_jacobian_evaluations += 1
        if not np.isfinite(x_cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost evaluation failed (non-finite)."
            return x

        if opts.jacobi_scaling:
            # scale_i = 1 / (1 + sqrt(diag(J'J)_i)), fixed at iteration 0
            # (trust_region_minimizer.cc:263-279)
            graphs.jacobi_scaling()

        step_evaluator = TrustRegionStepEvaluator(
            x_cost,
            opts.max_consecutive_nonmonotonic_steps if opts.use_nonmonotonic_steps else 0,
        )

        it = IterationSummary(
            iteration=0,
            cost=x_cost + summary.fixed_cost,
            gradient_max_norm=gmax0,
            gradient_norm=gnorm0,
            trust_region_radius=strategy.radius,
            eta=opts.eta,
            step_is_valid=True,
            step_is_successful=True,
            cumulative_time_in_seconds=time.perf_counter() - start_time,
        )
        summary.iterations.append(it)
        self._log_progress(it)

        if it.gradient_max_norm <= opts.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm: "
                f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
            )
            return x

        num_consecutive_invalid_steps = 0
        atleast_one_successful_step = False

        while True:
            iter_start = time.perf_counter()
            prev = summary.iterations[-1]
            it = IterationSummary(
                iteration=prev.iteration + 1,
                trust_region_radius=strategy.radius,
                eta=opts.eta,
            )
            if self._check_termination_pre(it):
                return x
            summary.num_iterations += 1

            solver_t0 = time.perf_counter()
            default_step = self.step_fn is self._default_step_fn
            fused = self._use_fused_iteration and default_step
            if fused:
                # Step + candidate + speculative evaluation; one read.
                (model_cost_change, lin_iters, lin_term, f_cand_cost, f_step_norm,
                 f_x_norm, f_gmax, f_gnorm) = graphs.iteration(strategy.radius).cpu().tolist()
                step_scaled = True  # not None: validity checked below
            else:
                # The Jacobian scaled once per evaluation: a rejected
                # iteration keeps the same scaled context.
                ctx_used = graphs.scaled()
                if self.use_dogleg:
                    # host numbers, read by the strategy
                    step_scaled, model_cost_change, lin_iters, lin_term = (
                        strategy.compute_step(ctx_used)
                    )
                elif self._step_region and default_step:
                    step_scaled, scalars = graphs.lm_step(strategy.radius)
                    model_cost_change, lin_iters, lin_term = scalars.cpu().tolist()
                else:
                    step_scaled, mcc, lin_iters, lin_term = self.step_fn(
                        ctx_used, strategy.radius
                    )
                    model_cost_change, lin_iters, lin_term = _to_host(mcc, lin_iters, lin_term)
            lin_term = int(lin_term)
            it.linear_solver_iterations = int(lin_iters)
            it.step_solver_time_in_seconds = time.perf_counter() - solver_t0
            # On the fused iteration one call covers step, candidate and
            # re-evaluation: its whole time lands under "linear solver",
            # and the evaluation counters still tick.
            summary.linear_solver_time_in_seconds += it.step_solver_time_in_seconds
            summary.num_linear_solves += 1
            if fused:
                summary.num_residual_evaluations += 1
                summary.num_jacobian_evaluations += 1

            # Problem dumps (solver.h:725-735, trust_region_minimizer.cc:386-396).
            if (
                not fused
                and opts.trust_region_problem_dump_directory
                and it.iteration in opts.trust_region_minimizer_iterations_to_dump
            ):
                from ceres_tpu_torch.utils.observability import dump_trust_region_problem

                diag = torch.clamp(
                    ctx_used.squared_column_norms(), opts.min_lm_diagonal, opts.max_lm_diagonal
                )
                dump_trust_region_problem(
                    f"{opts.trust_region_problem_dump_directory}/lm_problem",
                    it.iteration, ctx_used, torch.sqrt(diag / strategy.radius), step_scaled,
                )

            if lin_term >= CG_FATAL_ERROR:
                # linear_solver.h:69-74: unrecoverable, abort the solve.
                summary.termination_type = TerminationType.FAILURE
                summary.message = "Terminating: linear solver reported FATAL_ERROR."
                return x
            # FAILURE -> invalid step (retry with a smaller trust region),
            # the reference's HandleInvalidStep path.
            it.step_is_valid = (
                step_scaled is not None
                and lin_term < CG_FAILURE
                and bool(np.isfinite(model_cost_change))
                and model_cost_change > 0.0
            )
            if lin_term >= CG_FAILURE:
                summary.num_linear_solver_failures += 1

            if not it.step_is_valid:
                # HandleInvalidStep (trust_region_minimizer.cc:466-500)
                num_consecutive_invalid_steps += 1
                if num_consecutive_invalid_steps >= opts.max_num_consecutive_invalid_steps:
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = (
                        "Number of consecutive invalid steps more than "
                        "Solver::Options::max_num_consecutive_invalid_steps: "
                        f"{opts.max_num_consecutive_invalid_steps}"
                    )
                    return x
                strategy.step_is_invalid(0.0)
                it.cost = x_cost + summary.fixed_cost
                it.gradient_max_norm = prev.gradient_max_norm
                it.gradient_norm = prev.gradient_norm
                it.iteration_time_in_seconds = time.perf_counter() - iter_start
                it.cumulative_time_in_seconds = time.perf_counter() - start_time
                summary.iterations.append(it)
                self._log_progress(it)
                if self._run_callbacks(it, x):
                    return x
                continue

            num_consecutive_invalid_steps = 0

            if fused:
                candidate_cost = f_cand_cost
                step_norm = f_step_norm
                x_norm = f_x_norm
            elif program.has_bounds:
                # Projected line search for bounds
                # (trust_region_minimizer.cc:103-108): its step along
                # scaling * step, then the candidate at that step evaluated
                # again with the norms, one read.
                alpha = self._projected_line_search(x_cost, step_scaled)
                t0 = time.perf_counter()
                candidate_x, scalars = self._bounded_trial(alpha)
                candidate_cost, step_norm, x_norm = scalars.cpu().tolist()
                summary.residual_evaluation_time_in_seconds += time.perf_counter() - t0
                summary.num_residual_evaluations += 1
            else:
                # Candidate, its cost and the norms: one read.
                t0 = time.perf_counter()
                self.evaluator._notify(None, False)
                candidate_x, scalars = graphs.candidate(step_scaled)
                candidate_cost, step_norm, x_norm = scalars.cpu().tolist()
                summary.residual_evaluation_time_in_seconds += time.perf_counter() - t0
                summary.num_residual_evaluations += 1
            if not np.isfinite(candidate_cost):
                candidate_cost = _DBL_MAX

            # DoInnerIterationsIfNeeded (trust_region_minimizer.cc:509-581):
            # polish the candidate by coordinate descent, and switch that
            # off once its relative progress falls to the tolerance.
            if self._inner_enabled and np.isfinite(candidate_cost) and candidate_cost > 0.0:
                t0 = time.perf_counter()
                inner_x, inner_cost = self.inner_minimizer.minimize(candidate_x)
                summary.inner_iteration_time_in_seconds += time.perf_counter() - t0
                summary.num_inner_iteration_steps += 1
                if np.isfinite(inner_cost) and inner_cost < candidate_cost:
                    rel_progress = (candidate_cost - inner_cost) / candidate_cost
                    candidate_x = program.clamp(inner_x)
                    (candidate_cost,) = _to_host(self.evaluator.cost(candidate_x))
                    if rel_progress <= opts.inner_iteration_tolerance:
                        self._inner_enabled = False
                else:
                    self._inner_enabled = False

            it.step_norm = step_norm
            it.cost_change = x_cost - candidate_cost

            # Parameter tolerance (trust_region_minimizer.cc:720-742).
            step_size_tolerance = opts.parameter_tolerance * (x_norm + opts.parameter_tolerance)
            if atleast_one_successful_step and it.step_norm <= step_size_tolerance:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Parameter tolerance reached. Relative step_norm: "
                    f"{it.step_norm / (x_norm + opts.parameter_tolerance):e} <= "
                    f"{opts.parameter_tolerance:e}."
                )
                return x

            # Function tolerance (trust_region_minimizer.cc:744-766).
            if abs(it.cost_change) <= opts.function_tolerance * x_cost:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(it.cost_change) / x_cost if x_cost else 0.0:e} <= "
                    f"{opts.function_tolerance:e}"
                )
                return x

            # Step quality (IsStepSuccessful, trust_region_minimizer.cc:795-821).
            it.relative_decrease = step_evaluator.step_quality(candidate_cost, model_cost_change)
            it.step_is_successful = it.relative_decrease > opts.min_relative_decrease
            it.step_is_nonmonotonic = (
                it.step_is_successful and candidate_cost > step_evaluator.minimum_cost
            )

            if it.step_is_successful:
                atleast_one_successful_step = True
                x_cost = candidate_cost
                if fused:
                    # The speculative evaluation is the reference's
                    # HandleSuccessfulStep re-evaluation (:826), done already:
                    # its candidate becomes the current point.
                    graphs.accept()
                    it.gradient_max_norm, it.gradient_norm = f_gmax, f_gnorm
                else:
                    if opts.check_gradients:
                        # The reference checks every evaluation and aborts
                        # at the first mismatch, at any iterate
                        # (gradient_checking_cost_function.h:105).
                        from ceres_tpu_torch.gradient_checker import check_program_gradients_at

                        ok, msg = check_program_gradients_at(
                            program.unsharded(), candidate_x,
                            opts.gradient_check_relative_precision,
                        )
                        if not ok:
                            summary.termination_type = TerminationType.FAILURE
                            summary.message = (
                                f"Gradient check failed at iteration {it.iteration}: {msg}"
                            )
                            return candidate_x
                    t0 = time.perf_counter()
                    full = self.evaluator.cost_gradient_jacobian(candidate_x)
                    x, grad = graphs.x, full.gradient
                    it.gradient_max_norm, it.gradient_norm = _to_host(*_grad_norms(grad))
                    summary.jacobian_evaluation_time_in_seconds += time.perf_counter() - t0
                    summary.num_jacobian_evaluations += 1
                strategy.step_accepted(it.relative_decrease)
                step_evaluator.step_accepted(candidate_cost, model_cost_change)
            else:
                strategy.step_rejected(it.relative_decrease)
                it.gradient_max_norm = prev.gradient_max_norm
                it.gradient_norm = prev.gradient_norm

            it.cost = x_cost + summary.fixed_cost
            it.trust_region_radius = strategy.radius
            it.iteration_time_in_seconds = time.perf_counter() - iter_start
            it.cumulative_time_in_seconds = time.perf_counter() - start_time
            summary.iterations.append(it)
            self._log_progress(it)
            if self._run_callbacks(it, x):
                return x

            if it.step_is_successful and it.gradient_max_norm <= opts.gradient_tolerance:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Gradient tolerance reached. Gradient max norm: "
                    f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
                )
                return x

            if strategy.radius <= opts.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    "Minimum trust region radius reached. Trust region radius: "
                    f"{strategy.radius:e} <= {opts.min_trust_region_radius:e}"
                )
                return x

    # -- helpers ------------------------------------------------------------

    def _check_termination_pre(self, it: IterationSummary) -> bool:
        opts = self.options
        summary = self.summary
        if it.iteration > opts.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = (
                "Maximum number of iterations reached. "
                f"Number of iterations: {it.iteration - 1}."
            )
            return True
        total = it.cumulative_time_in_seconds = summary.iterations[-1].cumulative_time_in_seconds
        over = total >= opts.max_solver_time_in_seconds
        if self.program.comm is not None:  # rank 0's clock
            over = self.program.comm.over_budget(over, opts.max_solver_time_in_seconds,
                                                 self.program.device)
        if over:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            return True
        return False

    def _bounded_trial(self, alpha: float):
        """The bounds line search's point at step ``alpha`` (a new point for
        the evaluation callback), its cost and norms (``graphs.bounded_trial``)."""
        evaluator = self.evaluator
        evaluator._notify(None, False, new_point=True)
        with evaluator._timer("Evaluator::Residual"):
            candidate_x, scalars = self.graphs.bounded_trial(alpha)
        evaluator._last_x = candidate_x  # the point it was told of
        return candidate_x, scalars

    def _projected_line_search(self, x_cost, step):
        """Projected Armijo backtracking with polynomial interpolation along
        delta = scaling * step from the current point; returns the step
        size to take (1, the full step, when the search fails).

        Analog of TrustRegionMinimizer::DoLineSearch
        (trust_region_minimizer.cc:290-379,590-635): sufficient-decrease
        condition phi(a) <= phi(0) + c*a*phi'(0) on the projected step,
        with the next trial step chosen by quadratic (first backtrack) then
        cubic (subsequent) interpolation of the sampled values, safeguarded
        to [0.1a, 0.5a] like line_search.cc's min/max_relative_step_size_change
        defaults. One host read per trial (its cost) and one for phi'(0);
        each trial is a run of the ``bounded_trial`` region.
        """
        from ceres_tpu_torch.ops.polynomial import (
            cubic_minimizer_from_samples,
            quadratic_minimizer,
        )

        opts = self.options
        c1 = opts.line_search_sufficient_function_decrease
        phi0 = x_cost
        dphi0 = float(self.graphs.bounded_line(step).cpu())
        if not np.isfinite(dphi0) or dphi0 >= 0.0:
            # Scaling/projection degraded descent: keep the full step and
            # let the step-quality test reject it (the reference treats a
            # non-descent direction as line search failure).
            return 1.0
        alpha = 1.0
        prev = None  # (alpha, phi) of the previous trial
        for _ in range(opts.max_num_line_search_step_size_iterations):
            if alpha < opts.min_line_search_step_size:
                # Degenerate step (ArmijoLineSearch's min_step_size abort): a
                # rounding-level alpha can satisfy the sufficient-decrease
                # test spuriously and trip the parameter-tolerance check.
                break
            phi = self._bounded_trial(alpha)[1].cpu().tolist()[0]
            if np.isfinite(phi) and phi <= phi0 + c1 * alpha * dphi0:
                return alpha
            if prev is None or not np.isfinite(phi):
                # Quadratic through phi(0), phi'(0), (alpha, phi).
                a_next = quadratic_minimizer(phi0, dphi0, alpha, phi)
            else:
                # Cubic through phi(0), phi'(0) and the last two samples
                # (Nocedal & Wright eq. 3.43).
                a0, f0 = prev
                a_next = cubic_minimizer_from_samples(phi0, dphi0, a0, f0, alpha, phi)
            if not np.isfinite(a_next):
                a_next = 0.5 * alpha
            a_next = min(max(a_next, 0.1 * alpha), 0.5 * alpha)
            if np.isfinite(phi):
                prev = (alpha, phi)
            alpha = a_next
        # Line search failed: keep the FULL step, like the reference
        # (line_search_summary.success == false leaves delta unscaled,
        # trust_region_minimizer.cc:633-635). The clamped candidate is then
        # rejected by the step-quality test and the radius shrinks until the
        # direction follows the projected gradient; returning the best tiny
        # step instead would trip the parameter-tolerance test and report
        # false convergence at an active bound.
        return 1.0

    def _run_callbacks(self, it: IterationSummary, x=None) -> bool:
        """Returns True if minimization should stop (callbacks.h:45-75)."""
        if self.options.update_state_every_iteration and x is not None and self.options.callbacks:
            # solver.h:786-815: expose the current parameters to callbacks.
            self.program._problem.write_back(x.to(_F64).cpu().numpy())
        for cb in self.options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                self.summary.termination_type = TerminationType.USER_FAILURE
                self.summary.message = "User callback returned SOLVER_ABORT."
                return True
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                self.summary.termination_type = TerminationType.USER_SUCCESS
                self.summary.message = "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                return True
        return False

    def _log_progress(self, it: IterationSummary) -> None:
        if not self.options.minimizer_progress_to_stdout:
            return
        if it.iteration == 0:
            print(
                "iter      cost      cost_change  |gradient|   |step|  "
                "  tr_ratio  tr_radius  ls_iter  iter_time  total_time"
            )
        print(
            f"{it.iteration:4d} {it.cost:.6e} {it.cost_change:.2e} "
            f"{it.gradient_max_norm:.2e} {it.step_norm:.2e} "
            f"{it.relative_decrease:.2e} {it.trust_region_radius:.2e} "
            f"{it.linear_solver_iterations:7d} {it.iteration_time_in_seconds:.2e} "
            f"{it.cumulative_time_in_seconds:.2e}"
        )
