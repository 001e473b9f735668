"""Solver entry point: options, summary and ``solve`` (port of the
TRUST_REGION subset of ``ceres_tpu/solver.py``).

Every configuration runs the fused LM loop of ``fused_lm.py``; options
that need another minimizer, host work inside the loop, or a linear solver
the port does not have yet (anything but ITERATIVE_SCHUR with SCHUR_JACOBI
and DENSE_SCHUR) raise ``NotImplementedError`` naming their ROADMAP item.
A solve runs on the card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from ceres_tpu_torch.types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

_MINIMIZERS = "ROADMAP Queue 1 item 16 (other minimizers)"
_LINEAR = "ROADMAP Queue 1 item 14 (other linear solvers and preconditioners)"


@dataclasses.dataclass
class SolverOptions:
    """Analog of Solver::Options (solver.h:61-816): the fields this slice
    reads, with the reference's defaults."""

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
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
    jacobi_scaling: bool = True
    linear_solver_type: Optional[LinearSolverType] = None  # None = auto
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1
    use_explicit_schur_complement: bool = False
    use_mixed_precision_solves: bool = False
    # None keeps float64; "float32" evaluates residuals/Jacobians and runs
    # the linear solves in f32 (cost sums and LM scalars stay f64).
    evaluation_dtype: Optional[str] = None
    use_inner_iterations: bool = False
    minimizer_progress_to_stdout: bool = False
    check_gradients: bool = False
    update_state_every_iteration: bool = False
    callbacks: List[Callable] = dataclasses.field(default_factory=list)

    def resolved_linear_solver_type(self, num_tangent: int) -> LinearSolverType:
        if self.linear_solver_type is not None:
            return self.linear_solver_type
        # Auto: dense for small tangent spaces, CGNR otherwise.
        if num_tangent <= 1024:
            return LinearSolverType.DENSE_NORMAL_CHOLESKY
        return LinearSolverType.CGNR


def check_supported(options: SolverOptions) -> None:
    """Raise NotImplementedError for what the fused LM loop of this slice
    cannot run (the conditions of fused_lm.fused_traced_eligible in the
    JAX package, plus the port's linear-solver subset)."""
    if options.minimizer_type != MinimizerType.TRUST_REGION:
        raise NotImplementedError(f"LINE_SEARCH minimizer: {_MINIMIZERS}")
    if options.trust_region_strategy_type != TrustRegionStrategyType.LEVENBERG_MARQUARDT:
        raise NotImplementedError(f"DOGLEG: {_MINIMIZERS}")
    for flag in (
        "use_nonmonotonic_steps",
        "use_inner_iterations",
        "minimizer_progress_to_stdout",
        "check_gradients",
        "update_state_every_iteration",
        "callbacks",
    ):
        if getattr(options, flag):
            raise NotImplementedError(
                f"{flag} needs the host-loop minimizer: {_MINIMIZERS}"
            )
    if options.max_solver_time_in_seconds < 1e6:
        raise NotImplementedError(
            f"max_solver_time_in_seconds needs the host-loop minimizer: {_MINIMIZERS}"
        )
    if options.linear_solver_type not in (
        LinearSolverType.ITERATIVE_SCHUR,
        LinearSolverType.DENSE_SCHUR,
    ):
        raise NotImplementedError(f"{options.linear_solver_type}: {_LINEAR}")
    if (
        options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR
        and options.preconditioner_type != PreconditionerType.SCHUR_JACOBI
    ):
        raise NotImplementedError(f"{options.preconditioner_type}: {_LINEAR}")
    if options.use_mixed_precision_solves:
        raise NotImplementedError(f"mixed-precision solves: {_LINEAR}")


@dataclasses.dataclass
class SolverSummary:
    """Analog of Solver::Summary (solver.h:818-1106): the fields the
    fused solve fills."""

    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    num_iterations: int = 0
    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residuals: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_linear_solver_iterations: int = 0
    # host set-up (program, dtype cast, Schur and explicit-S plans) and the
    # LM loop itself, up to the last device result
    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_type_used: Optional[LinearSolverType] = None
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION

    def is_solution_usable(self) -> bool:
        return self.termination_type in (
            TerminationType.CONVERGENCE,
            TerminationType.NO_CONVERGENCE,
            TerminationType.USER_SUCCESS,
        )

    def brief_report(self) -> str:
        return (
            f"Ceres-TPU-torch Solver Report: Iterations: {self.num_iterations}, "
            f"Initial cost: {self.initial_cost:e}, "
            f"Final cost: {self.final_cost:e}, "
            f"Termination: {self.termination_type}"
        )


def solve(options: SolverOptions, problem, device="cuda") -> SolverSummary:
    """Analog of ceres::Solve: solves on ``device`` (the card by default;
    without one that raises, it does not move to the CPU) and writes the
    solution back into the problem. Like the JAX package's ``solve`` on its fused
    path, a step that meets the parameter or function tolerance ends the
    solve at the iterate BEFORE that step (trust_region_minimizer.cc:720-766)."""
    from ceres_tpu_torch.fused_lm import run_fused

    return run_fused(options, problem, device, host_loop_parity=True)
