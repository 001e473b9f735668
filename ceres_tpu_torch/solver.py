"""Solver entry point: options, summary and ``solve`` (port of
``ceres_tpu/solver.py``).

``solve`` chooses between the minimizers as the JAX package's does. A
TRUST_REGION solve takes the fused LM loop of ``fused_lm.py`` with its
per-iteration trace when no option needs host work inside the loop
(``fused_lm.fused_traced_eligible``), the host loop
``trust_region.TrustRegionMinimizer`` otherwise: DOGLEG (traditional or
subspace), inner iterations, gradient checks, parameter bounds, iteration
callbacks (with ``update_state_every_iteration``), an ``EvaluationCallback``,
progress output, non-monotonic steps, a time budget, trust-region problem
dumps, or more than 2048 (or 0) iterations. A LINE_SEARCH solve takes
``line_search.LineSearchMinimizer`` (L-BFGS, BFGS, nonlinear CG, steepest
descent; Armijo or Wolfe), its evaluations on the program's line-search
regions (``host_loop_graphs.line_search_graphs``). ``check_gradients`` checks every family's
Jacobian before the loop too. The trust-region loops run a loss, manifolds
and constant blocks, and one of the linear solvers DENSE_QR,
DENSE_NORMAL_CHOLESKY, SPARSE_NORMAL_CHOLESKY, CGNR (IDENTITY, JACOBI,
SUBSET), DENSE_SCHUR, SPARSE_SCHUR and ITERATIVE_SCHUR (IDENTITY, JACOBI,
SCHUR_JACOBI, SCHUR_POWER_SERIES_EXPANSION, CLUSTER_JACOBI,
CLUSTER_TRIDIAGONAL; explicit or implicit S), any of them with
mixed-precision refinement and, for the Schur solvers, a user elimination
ordering. The two sparse solvers factor on the host (the native core,
``utils/native.py``) and run in the host loop, as in the JAX package. With
``mesh`` (``parallel.make_mesh``) every rank of the process group calls
``solve`` on the same problem, the program is sharded over the ranks
(``parallel/sharding.py``) and every rank returns the same summary. A solve
runs on the card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

import torch

from ceres_tpu_torch.ordered_groups import OrderedGroups
from ceres_tpu_torch.types import (
    DoglegType,
    LinearSolverOrderingType,
    LinearSolverType,
    LineSearchDirectionType,
    LoggingType,
    LineSearchType,
    MinimizerType,
    NonlinearConjugateGradientType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

@dataclasses.dataclass
class SolverOptions:
    """Analog of Solver::Options (solver.h:61-816): the fields the port
    reads, with the reference's defaults."""

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG
    # Line search options (solver.h:114-306): the LINE_SEARCH minimizer's,
    # three of them also the projected search of a bounded trust-region
    # solve.
    line_search_direction_type: LineSearchDirectionType = LineSearchDirectionType.LBFGS
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES
    )
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e6
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    jacobi_scaling: bool = True
    linear_solver_type: Optional[LinearSolverType] = None  # None = auto
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1
    # Residual block ids whose rows form the SUBSET preconditioner
    # (subset_preconditioner.h:44-80).
    residual_blocks_for_subset_preconditioner: Optional[List[int]] = None
    use_explicit_schur_complement: bool = False
    # Drop numerically zero Jacobian entries and analyze the pattern of J'J
    # anew every iteration (solver.h:365-383; SPARSE_NORMAL_CHOLESKY only).
    dynamic_sparsity: bool = False
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0
    # Fill-reducing ordering of the host sparse factorizations
    # (SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR; solver.h:410-455), and whether
    # to post-order the elimination tree after it (reorder_program.cc:114-180).
    linear_solver_ordering_type: LinearSolverOrderingType = LinearSolverOrderingType.AMD
    use_postordering: bool = False
    # None keeps float64; "float32" evaluates residuals/Jacobians and runs
    # the linear solves in f32 (cost sums and LM scalars stay f64).
    evaluation_dtype: Optional[str] = None
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    # Elimination-order hint (ordered_groups.h): groups of parameter block
    # ids, group 0 eliminated first (the e-blocks of the Schur solvers).
    # None = automatic (greedy maximal independent set).
    linear_solver_ordering: Optional[Union[OrderedGroups, List[List[int]]]] = None
    # Inner iterations (solver.h:560-600).
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3
    # User coordinate-descent groups (Solver::Options::
    # inner_iteration_ordering): each group must be an independent set;
    # groups are optimized in increasing order. OrderedGroups or a list of
    # lists of parameter block ids; None = automatic greedy coloring.
    inner_iteration_ordering: Optional[Union[OrderedGroups, List[List[int]]]] = None
    # Trust region problem dumps (solver.h:725-735).
    trust_region_problem_dump_directory: str = ""
    trust_region_minimizer_iterations_to_dump: List[int] = dataclasses.field(
        default_factory=list
    )
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6
    callbacks: List[Callable] = dataclasses.field(default_factory=list)
    # Write the current parameter values back into the Problem's blocks
    # every iteration so IterationCallbacks can observe them
    # (solver.h:786-815).
    update_state_every_iteration: bool = False
    # Pre-evaluation hook (evaluation_callback.h:63): called with
    # (new_evaluation_point, evaluate_jacobians) before every residual /
    # Jacobian evaluation the minimizer performs.
    evaluation_callback: Optional[object] = None
    # Multi-device execution: ``mesh``, a DeviceMesh over the ranks of the
    # process group (parallel.make_mesh), shards the solve over them;
    # ``num_threads`` is accepted and ignored, as in the JAX package (the
    # card runs the evaluation).
    mesh: Optional[object] = None
    num_threads: int = 1

    def validate(self, num_tangent: int = 0) -> Optional[str]:
        """Cross-validation analog of Solver::Options::IsValid
        (solver.cc:714; CommonOptionsAreValid, TrustRegionOptionsAreValid,
        LineSearchOptionsAreValid, OptionsAreValidForLinearSolver,
        solver.cc:99-503) for the options the port has. Returns the first
        complaint, or None."""
        for name, lo in (
            ("max_num_iterations", 0),
            ("max_solver_time_in_seconds", 0.0),
            ("function_tolerance", 0.0),
            ("gradient_tolerance", 0.0),
            ("parameter_tolerance", 0.0),
        ):
            if getattr(self, name) < lo:
                return f"{name} must be >= {lo}, got {getattr(self, name)}"
        if self.num_threads <= 0:
            return "num_threads must be > 0"
        if self.check_gradients:
            if self.gradient_check_relative_precision <= 0:
                return "gradient_check_relative_precision must be > 0"
            if self.gradient_check_numeric_derivative_relative_step_size <= 0:
                return "gradient_check_numeric_derivative_relative_step_size must be > 0"
        if self.minimizer_type == MinimizerType.TRUST_REGION:
            err = self._validate_trust_region()
            if err is not None:
                return err
        # Line-search options are checked for BOTH minimizer types: a
        # bounded trust-region solve projects through the line search
        # (solver.cc:724-729).
        err = self._validate_line_search()
        if err is not None:
            return err
        if self.evaluation_dtype is not None and self.evaluation_dtype not in (
            "float32",
            "float64",
        ):
            return (
                "evaluation_dtype must be 'float32' or 'float64', got "
                f"{self.evaluation_dtype!r} (lower precisions lack the "
                "factorization kernels)"
            )
        return None

    def _validate_trust_region(self) -> Optional[str]:
        """TrustRegionOptionsAreValid (solver.cc:405-452)."""
        for name in (
            "initial_trust_region_radius",
            "min_trust_region_radius",
            "max_trust_region_radius",
            "eta",
        ):
            if getattr(self, name) <= 0:
                return f"{name} must be > 0, got {getattr(self, name)}"
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return "min_trust_region_radius > max_trust_region_radius"
        if self.min_trust_region_radius > self.initial_trust_region_radius:
            return "min_trust_region_radius > initial_trust_region_radius"
        if self.initial_trust_region_radius > self.max_trust_region_radius:
            return "initial_trust_region_radius > max_trust_region_radius"
        if self.min_relative_decrease < 0:
            return "min_relative_decrease must be >= 0"
        if self.min_lm_diagonal < 0 or self.max_lm_diagonal < 0:
            return "min/max_lm_diagonal must be >= 0"
        if self.min_lm_diagonal > self.max_lm_diagonal:
            return "min_lm_diagonal > max_lm_diagonal"
        if self.max_num_consecutive_invalid_steps < 0:
            return "max_num_consecutive_invalid_steps must be >= 0"
        if self.min_linear_solver_iterations < 0:
            return "min_linear_solver_iterations must be >= 0"
        if self.max_linear_solver_iterations < 0:
            return "max_linear_solver_iterations must be >= 0"
        if self.min_linear_solver_iterations > self.max_linear_solver_iterations:
            return "min_linear_solver_iterations > max_linear_solver_iterations"
        if self.use_inner_iterations and self.inner_iteration_tolerance < 0:
            return "inner_iteration_tolerance must be >= 0"
        if self.use_nonmonotonic_steps and self.max_consecutive_nonmonotonic_steps <= 0:
            return "max_consecutive_nonmonotonic_steps must be > 0"
        lst = self.linear_solver_type
        if (
            self.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
            and lst in (LinearSolverType.CGNR, LinearSolverType.ITERATIVE_SCHUR)
        ):
            return (
                "DOGLEG only supports exact factorization based linear "
                "solvers; use LEVENBERG_MARQUARDT with iterative solvers "
                "(solver.cc:431-438)"
            )
        if (
            self.trust_region_minimizer_iterations_to_dump
            and not self.trust_region_problem_dump_directory
        ):
            return "trust_region_problem_dump_directory is empty"
        return self._validate_linear_solver()

    def _validate_linear_solver(self) -> Optional[str]:
        """OptionsAreValidForLinearSolver (solver.cc:377-403)."""
        lst = self.linear_solver_type
        pt = self.preconditioner_type
        if self.dynamic_sparsity and lst not in (None, LinearSolverType.SPARSE_NORMAL_CHOLESKY):
            return "dynamic sparsity is only supported with SPARSE_NORMAL_CHOLESKY"
        if lst == LinearSolverType.CGNR and pt not in (
            PreconditionerType.IDENTITY,
            PreconditionerType.JACOBI,
            PreconditionerType.SUBSET,
        ):
            return f"Can't use CGNR with preconditioner_type = {pt.name}"
        if lst == LinearSolverType.ITERATIVE_SCHUR:
            if pt == PreconditionerType.SUBSET:
                return "Can't use SUBSET preconditioner with ITERATIVE_SCHUR"
            if self.use_explicit_schur_complement:
                if pt != PreconditionerType.SCHUR_JACOBI:
                    return (
                        "use_explicit_schur_complement only supports "
                        "SCHUR_JACOBI as the preconditioner"
                    )
                if self.use_spse_initialization:
                    return (
                        "use_explicit_schur_complement does not support "
                        "use_spse_initialization"
                    )
            if (
                self.use_spse_initialization
                or pt == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION
            ):
                if self.max_num_spse_iterations < 1:
                    return "max_num_spse_iterations must be >= 1"
                if self.spse_tolerance < 0:
                    return "spse_tolerance must be >= 0"
        if pt == PreconditionerType.SUBSET and not (
            self.residual_blocks_for_subset_preconditioner
        ):
            return (
                "When using SUBSET preconditioner, "
                "residual_blocks_for_subset_preconditioner cannot be empty"
            )
        return None

    def _validate_line_search(self) -> Optional[str]:
        """LineSearchOptionsAreValid (solver.cc:454-503)."""
        if self.max_lbfgs_rank <= 0:
            return "max_lbfgs_rank must be > 0"
        if self.min_line_search_step_size <= 0:
            return "min_line_search_step_size must be > 0"
        if not (0.0 < self.max_line_search_step_contraction < 1.0):
            return "max_line_search_step_contraction must be in (0, 1)"
        if not (
            self.max_line_search_step_contraction
            < self.min_line_search_step_contraction
            <= 1.0
        ):
            return (
                "require max_line_search_step_contraction < "
                "min_line_search_step_contraction <= 1"
            )
        min_ls_iters = 0 if self.minimizer_type == MinimizerType.TRUST_REGION else 1
        if self.max_num_line_search_step_size_iterations < min_ls_iters:
            return f"max_num_line_search_step_size_iterations must be >= {min_ls_iters}"
        if self.line_search_sufficient_function_decrease <= 0:
            return "line_search_sufficient_function_decrease must be > 0"
        if not (
            self.line_search_sufficient_function_decrease
            < self.line_search_sufficient_curvature_decrease
            < 1.0
        ):
            return (
                "require line_search_sufficient_function_decrease < "
                "line_search_sufficient_curvature_decrease < 1"
            )
        if self.max_line_search_step_expansion <= 1.0:
            return "max_line_search_step_expansion must be > 1"
        if (
            self.line_search_direction_type
            in (LineSearchDirectionType.BFGS, LineSearchDirectionType.LBFGS)
            and self.line_search_type != LineSearchType.WOLFE
        ):
            return "When using (L)BFGS, line_search_type must be WOLFE (solver.cc:471-484)"
        return None

    def resolved_linear_solver_type(self, num_tangent: int) -> LinearSolverType:
        if self.linear_solver_type is not None:
            return self.linear_solver_type
        # Auto: dense for small tangent spaces, CGNR otherwise.
        if num_tangent <= 1024:
            return LinearSolverType.DENSE_NORMAL_CHOLESKY
        return LinearSolverType.CGNR


def check_supported(options: SolverOptions) -> None:
    """Raise NotImplementedError for what the port does not run yet. Since
    the sharded evaluation (``mesh``) every option runs, so nothing raises;
    the check stays where a later option that the port lacks would go."""
    del options


@dataclasses.dataclass
class SolverSummary:
    """Analog of Solver::Summary (solver.h:818-1106)."""

    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    # IterationSummary records (trust_region.py), record 0 = the start.
    # ``solve`` fills them as the JAX package's solve does; ``fused_solve``
    # keeps only the count (``num_iterations``).
    iterations: List = dataclasses.field(default_factory=list)
    # LM iterations that computed a step
    num_iterations: int = 0
    # ranks of the mesh the solve was sharded over (1: no mesh), and this
    # rank's collectives: {"all_reduce" | "broadcast": {"calls", "bytes",
    # "seconds"}} (parallel.sharding.MeshComm.stats; None: no mesh)
    num_devices: int = 1
    collectives: Optional[dict] = None
    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    # Linear solves that terminated with FAILURE (each becomes an invalid
    # step), linear_solver.h:57-74.
    num_linear_solver_failures: int = 0
    num_linear_solver_iterations: int = 0
    # host set-up (program, dtype cast, Schur and explicit-S plans, the
    # fused loop's capture) and the LM loop itself, up to the last device
    # result
    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    # Whether the fused loop (fused_lm.py), or the host loop's or the line
    # search's device work (host_loop_graphs.py), ran as CUDA graphs, and the
    # seconds this solve spent capturing them (0 when the graphs were
    # captured by an earlier solve; the host loop and the line search
    # capture each region at its first call, inside the minimizer's time).
    captured_loop: bool = False
    graph_capture_time_in_seconds: float = 0.0
    # Per-phase minimizer times and counts (solver.h:967-1006, the
    # FullReport time table), host seconds. The host loop's fused iteration
    # and the traced loop evaluate inside the step computation, so their
    # time is under the linear solver and the evaluation counters still
    # tick.
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    inner_iteration_time_in_seconds: float = 0.0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    num_linear_solves: int = 0
    # Phase log (EventLogger) and the host loop's Evaluator statistics
    # (ExecutionSummary), attached by ``solve``.
    event_log: Optional[object] = None
    evaluator_statistics: Optional[object] = None
    linear_solver_type_used: Optional[LinearSolverType] = None
    preconditioner_type_used: Optional[PreconditionerType] = None
    trust_region_strategy_type_used: Optional[TrustRegionStrategyType] = None
    evaluation_dtype: Optional[str] = None
    device: str = ""
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION

    def is_solution_usable(self) -> bool:
        return self.termination_type in (
            TerminationType.CONVERGENCE,
            TerminationType.NO_CONVERGENCE,
            TerminationType.USER_SUCCESS,
        )

    def brief_report(self) -> str:
        return (
            # the records, start included, as the JAX package counts them
            # (fused_solve keeps only the count of steps)
            f"Ceres-TPU-torch Solver Report: Iterations: "
            f"{len(self.iterations) if self.iterations else self.num_iterations}, "
            f"Initial cost: {self.initial_cost:e}, "
            f"Final cost: {self.final_cost:e}, "
            f"Termination: {self.termination_type}"
        )

    def full_report(self) -> str:
        """Analog of Summary::FullReport (solver.cc:890-960)."""
        lines = [
            "",
            "Solver Summary (ceres_tpu_torch)",
            "",
            f"{'Parameter blocks':<30}{self.num_parameter_blocks:>12}",
            f"{'Parameters':<30}{self.num_parameters:>12}",
            f"{'Effective parameters':<30}{self.num_effective_parameters:>12}",
            f"{'Residual blocks':<30}{self.num_residual_blocks:>12}",
            f"{'Residuals':<30}{self.num_residuals:>12}",
            "",
            f"{'Minimizer type':<30}{str(self.minimizer_type):>12}",
            f"{'Trust region strategy':<30}"
            f"{str(self.trust_region_strategy_type_used):>12}",
            f"{'Linear solver':<30}{str(self.linear_solver_type_used):>12}",
            f"{'Preconditioner':<30}{str(self.preconditioner_type_used):>12}",
            f"{'Evaluation dtype':<30}{str(self.evaluation_dtype or 'float64'):>12}",
            f"{'Device':<30}{self.device:>12}",
            f"{'Devices':<30}{self.num_devices:>12}",
            "",
            f"{'Initial cost':<30}{self.initial_cost:>12.6e}",
            f"{'Final cost':<30}{self.final_cost:>12.6e}",
            f"{'Fixed cost':<30}{self.fixed_cost:>12.6e}",
            "",
            f"{'Iterations':<30}{self.num_iterations:>12}",
            f"{'Successful steps':<30}{self.num_successful_steps:>12}",
            f"{'Unsuccessful steps':<30}{self.num_unsuccessful_steps:>12}",
            f"{'Linear solver failures':<30}{self.num_linear_solver_failures:>12}",
            f"{'Linear solver iterations':<30}"
            f"{self.num_linear_solver_iterations:>12}",
            "",
            "Time (in seconds):",
            f"{'Preprocessor':<34}{self.preprocessor_time_in_seconds:>10.4f}",
            *([f"  {'Graph capture':<28}{self.graph_capture_time_in_seconds:>14.4f}"]
              if self.captured_loop else []),
            "",
            f"  {'Residual only evaluation':<28}"
            f"{self.residual_evaluation_time_in_seconds:>14.4f}"
            f" ({self.num_residual_evaluations})",
            f"  {'Jacobian & residual evaluation':<28}"
            f"{self.jacobian_evaluation_time_in_seconds:>14.4f}"
            f" ({self.num_jacobian_evaluations})",
            f"  {'Linear solver':<28}"
            f"{self.linear_solver_time_in_seconds:>14.4f}"
            f" ({self.num_linear_solves})",
            f"  {'Inner iterations':<28}"
            f"{self.inner_iteration_time_in_seconds:>14.4f}"
            f" ({self.num_inner_iteration_steps})",
            f"{'Minimizer':<34}{self.minimizer_time_in_seconds:>10.4f}",
            "",
            f"{'Postprocessor':<34}{self.postprocessor_time_in_seconds:>10.4f}",
            f"{'Total':<34}{self.total_time_in_seconds:>10.4f}",
            "",
            f"Termination: {self.termination_type} ({self.message})",
        ]
        return "\n".join(lines)


def preprocess(options: SolverOptions, problem, device, summary: SolverSummary):
    """The preprocessor both entry points share (solver.cc:789-812): freeze
    the program on ``device``, fill the summary's problem sizes, validate
    the options, and end a solve that has nothing to do (invalid options, no
    non-constant block, an infeasible start). Returns (program, resolved
    options) with the program cast to the evaluation dtype and, with a mesh,
    sharded over its ranks, or None when ``summary`` is final. Raises
    NotImplementedError for what the port does not run yet."""
    from ceres_tpu_torch.evaluator import _cost_impl
    from ceres_tpu_torch.problem import cast_program

    if options.mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(options.mesh, DeviceMesh):
            raise TypeError(
                "mesh must be a torch.distributed DeviceMesh over the ranks of the process "
                f"group (ceres_tpu_torch.parallel.make_mesh), got {type(options.mesh).__name__}"
            )
    device = torch.device(device)
    if options.mesh is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # this rank's card
    program = problem.program(device)
    summary.minimizer_type = options.minimizer_type
    summary.device = str(device)
    summary.num_parameter_blocks = program.num_parameter_blocks()
    summary.num_parameters = program.num_ambient
    summary.num_effective_parameters = program.num_tangent
    summary.num_residual_blocks = program.num_residual_blocks()
    summary.num_residuals = program.num_residuals()
    # Cost of the residual blocks the reduced program drops
    # (program.cc:291-415): constant for the whole solve.
    summary.fixed_cost = program.fixed_cost

    err = options.validate(program.num_tangent)
    if err is not None:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {err}"
        return None
    if program.num_tangent == 0 or program.num_residuals() == 0:
        # All blocks constant / no residual blocks: nothing to optimize
        # (solver.cc:795-812).
        c = program.fixed_cost
        if program.families:
            x = torch.from_numpy(program.initial_ambient()).to(device)
            c += float(_cost_impl(x, program.families))
        summary.initial_cost = summary.final_cost = c
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Function tolerance reached. No non-constant parameter blocks found."
        return None
    if not program.is_feasible():
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Initial point infeasible (violates bounds)."
        return None

    resolved = dataclasses.replace(
        options,
        linear_solver_type=options.resolved_linear_solver_type(program.num_tangent),
    )
    check_supported(resolved)
    summary.linear_solver_type_used = resolved.linear_solver_type
    summary.preconditioner_type_used = resolved.preconditioner_type
    summary.trust_region_strategy_type_used = resolved.trust_region_strategy_type
    summary.evaluation_dtype = options.evaluation_dtype
    if options.mesh is not None:
        # shard by the elimination ordering the solve will use
        # (the JAX package's shard_program call, solver.py:589-594)
        from ceres_tpu_torch.ordered_groups import normalize_ordering
        from ceres_tpu_torch.trust_region import _SCHUR_TYPES

        groups = normalize_ordering(resolved.linear_solver_ordering)
        e_blocks = None
        if groups and resolved.linear_solver_type in _SCHUR_TYPES:
            e_blocks = list(groups[0])
        program = problem.sharded_program(device, options.mesh, e_blocks)
        summary.num_devices = int(options.mesh.size())
        summary.collectives = program.comm.new_stats()  # filled in as the solve runs
    if options.evaluation_dtype is not None:
        cast_program(program, options.evaluation_dtype)
    return program, resolved


def initial_state(program, mesh=None) -> torch.Tensor:
    """The start x on the program's device in its evaluation dtype; with a
    mesh, rank 0's bits on every rank (``parallel.replicate``)."""
    x0 = torch.from_numpy(program.initial_ambient()).to(program.device, program.eval_dtype)
    if mesh is None:
        return x0
    from ceres_tpu_torch.parallel import replicate

    return replicate(x0, mesh, program.device)


def summarize_records(summary: SolverSummary) -> None:
    """``solve``'s postprocess from the records (solver.cc:834-855): the
    initial and final cost and the step and CG counts."""
    records = summary.iterations
    if records:
        summary.initial_cost = records[0].cost
        summary.final_cost = min(r.cost for r in records)
        summary.num_successful_steps = sum(1 for r in records if r.step_is_successful)
        summary.num_unsuccessful_steps = sum(1 for r in records if not r.step_is_successful)
        summary.num_linear_solver_iterations = sum(r.linear_solver_iterations for r in records)


def solve(options: SolverOptions, problem, device="cuda") -> SolverSummary:
    """Analog of ceres::Solve (solver.cc:857, Solver::Solve solver.cc:734):
    solves on ``device`` (the card by default; without one that raises, it
    does not move to the CPU) and writes the solution back into the problem.
    A step that meets the parameter or function tolerance ends the solve at
    the iterate BEFORE that step (trust_region_minimizer.cc:720-766)."""
    from ceres_tpu_torch.fused_lm import (
        fused_traced_eligible,
        minimize_fused_traced,
        prepare_fused_loop,
    )
    from ceres_tpu_torch.line_search import LineSearchMinimizer
    from ceres_tpu_torch.trust_region import TrustRegionMinimizer, _build_solve_aux
    from ceres_tpu_torch.utils.observability import EventLogger

    t0 = time.perf_counter()
    summary = SolverSummary()
    # Scoped phase log (event_logger.h:41-75).
    event_logger = EventLogger("Solver::Solve")
    summary.event_log = event_logger
    prep = preprocess(options, problem, device, summary)
    if prep is None:
        summary.total_time_in_seconds = time.perf_counter() - t0
        return summary
    program, resolved = prep
    trust_region = options.minimizer_type == MinimizerType.TRUST_REGION
    if options.check_gradients:
        from ceres_tpu_torch.gradient_checker import check_program_gradients_at

        ok, msg = check_program_gradients_at(
            program.unsharded(), program.initial_ambient(),
            options.gradient_check_relative_precision,
        )
        if not ok:
            summary.termination_type = TerminationType.FAILURE
            summary.message = f"Gradient check failed: {msg}"
            summary.total_time_in_seconds = time.perf_counter() - t0
            return summary
    if trust_region:
        _build_solve_aux(resolved, program)  # memoized on the program
    x0 = initial_state(program, options.mesh)
    fused = trust_region and fused_traced_eligible(resolved, program)
    if fused:
        loop = prepare_fused_loop(resolved, program, x0, summary, revert_on_tolerance=True,
                                  trace=True)
    t1 = time.perf_counter()
    summary.preprocessor_time_in_seconds = t1 - t0
    event_logger.add_event("Preprocess")

    if fused:
        x = minimize_fused_traced(resolved, loop, x0, summary)
    else:
        if trust_region:
            minimizer = TrustRegionMinimizer(program, resolved, summary)
        else:
            minimizer = LineSearchMinimizer(program, resolved, summary)
        x = minimizer.minimize(x0)
        stats = minimizer.evaluator.statistics()
        summary.evaluator_statistics = stats
        if not trust_region:
            # The line search evaluates through the Evaluator alone
            # (program_evaluator.h:143-147): its counts are the summary's.
            summary.num_residual_evaluations += stats.calls.get("Evaluator::Residual", 0)
            summary.residual_evaluation_time_in_seconds += stats.times.get(
                "Evaluator::Residual", 0.0
            )
            summary.num_jacobian_evaluations += stats.calls.get(
                "Evaluator::Gradient", 0
            ) + stats.calls.get("Evaluator::Jacobian", 0)
            summary.jacobian_evaluation_time_in_seconds += stats.times.get(
                "Evaluator::Gradient", 0.0
            ) + stats.times.get("Evaluator::Jacobian", 0.0)
    x = x.to(torch.float64).cpu().numpy()
    t2 = time.perf_counter()
    summary.minimizer_time_in_seconds = t2 - t1
    event_logger.add_event("Minimize")

    summarize_records(summary)
    if summary.is_solution_usable():
        problem.write_back(x)
    summary.postprocessor_time_in_seconds = time.perf_counter() - t2
    summary.total_time_in_seconds = time.perf_counter() - t0
    event_logger.finish()
    return summary
