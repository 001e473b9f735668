"""CGNR: conjugate gradients on the normal equations (port of
``ceres_tpu/linear/cgnr.py``; the reference's
``internal/ceres/cgnr_solver.{h,cc}:84-121``). Solves

    (J'J + D'D) y = J'f

matrix-free through the batched-block Jacobian
(``JacobianContext.normal_matvec``: two einsum passes and the plan
reductions per CG iteration).
"""

from __future__ import annotations

from typing import Optional

import torch

from ceres_tpu_torch.evaluator import JacobianContext
from ceres_tpu_torch.linear import preconditioners as precond
from ceres_tpu_torch.linear.cg import CGResult, conjugate_gradients
from ceres_tpu_torch.problem import BlockGroups
from ceres_tpu_torch.types import PreconditionerType


def solve_cgnr(
    ctx: JacobianContext,
    D: torch.Tensor,
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI,
    bd_groups: Optional[BlockGroups] = None,
    max_num_iterations: int = 500,
    min_num_iterations: int = 1,
    q_tolerance: float = 0.1,
    r_tolerance: float = -1.0,
    rhs: Optional[torch.Tensor] = None,
    subset_masks=None,
    subset_plan: Optional[precond.SubsetPlan] = None,
) -> CGResult:
    """Returns CGResult whose .x solves min ||J y - f||^2 + ||D y||^2,
    or (J'J + D'D) y = rhs when an explicit tangent rhs is given. JACOBI is
    block Jacobi when ``bd_groups`` is given, scalar Jacobi otherwise."""

    def operator(v):
        return ctx.normal_matvec(v) + (D * D) * v

    if preconditioner_type == PreconditionerType.IDENTITY:
        M = precond.identity_preconditioner()
    elif preconditioner_type == PreconditionerType.JACOBI:
        if bd_groups is not None:
            M = precond.block_jacobi_preconditioner(ctx, bd_groups, D)
        else:
            M = precond.scalar_jacobi_preconditioner(ctx, D)
    elif preconditioner_type == PreconditionerType.SUBSET and subset_masks is not None:
        M = precond.subset_preconditioner(ctx, subset_masks, D, subset_plan)
    else:
        raise ValueError(
            f"CGNR supports IDENTITY/JACOBI/SUBSET, got {preconditioner_type}"
        )
    if rhs is None:
        rhs = ctx.gradient()  # J'f
    return conjugate_gradients(
        operator,
        rhs,
        preconditioner=M,
        max_num_iterations=max_num_iterations,
        min_num_iterations=min_num_iterations,
        q_tolerance=q_tolerance,
        r_tolerance=r_tolerance,
    )
