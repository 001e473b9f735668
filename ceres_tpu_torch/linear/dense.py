"""Dense linear solvers: QR and normal-equations Cholesky (port of
``ceres_tpu/linear/dense.py``; the reference's
``internal/ceres/dense_qr_solver.{h,cc}`` and
``dense_normal_cholesky_solver.{h,cc}``). The reference dispatches to
Eigen/LAPACK/cuSOLVER and the JAX package to ``jnp.linalg``; here the
factorizations are ``torch.linalg``'s. For small and medium dense problems:
the Jacobian is materialized (``JacobianContext.to_dense``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ceres_tpu_torch.evaluator import JacobianContext


def solve_dense_normal_cholesky(
    ctx: JacobianContext, D: torch.Tensor, rhs: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Solve (J'J + D'D) y = rhs (default rhs = J'f) via Cholesky
    (DenseNormalCholeskySolver). A matrix that is not positive definite
    gives a non-finite y, which the caller reports as FAILURE."""
    J = ctx.to_dense()
    lhs = J.T @ J + torch.diag(D * D)
    if rhs is None:
        rhs = J.T @ ctx.residual_vector()
    chol, info = torch.linalg.cholesky_ex(lhs)
    y = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, y, torch.nan)


def solve_dense_qr(
    ctx: JacobianContext, D: torch.Tensor, rhs: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Solve min ||J y - f||^2 + ||D y||^2 via QR of the stacked system
    [J; diag(D)] with zero rhs rows (DenseQRSolver): more robust than the
    normal equations. With an explicit tangent ``rhs``, solves
    (J'J + D'D) y = rhs = R'R y through two triangular solves with the R
    factor."""
    J = ctx.to_dense()
    n = J.shape[1]
    A = torch.cat([J, torch.diag(D)], dim=0)
    if rhs is not None:
        R = torch.linalg.qr(A, mode="r")[1]
        z = torch.linalg.solve_triangular(R.T, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(R, z, upper=True)[:, 0]
    f = ctx.residual_vector()
    b = torch.cat([f, f.new_zeros((n,))])
    Q, R = torch.linalg.qr(A, mode="reduced")
    return torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]
