"""Preconditioned conjugate gradients (port of ``ceres_tpu/linear/cg.py``,
after conjugate_gradients_solver.h:108-300).

Same update order, Nash-Sofer Q-based termination (zeta test), r-tolerance
test, residual refresh every ``residual_reset_period`` iterations, and the
indefiniteness / numerical-failure guards. The loop runs on the host and
reads one flag from the device per iteration to decide whether to stop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ceres_tpu_torch.types import LinearSolverTerminationType

# Termination codes (LinearSolverTerminationType, linear_solver.h:57-74),
# ordered so that max() combines codes with the worst outcome winning.
CG_NO_CONVERGENCE = LinearSolverTerminationType.NO_CONVERGENCE.value
CG_SUCCESS = LinearSolverTerminationType.SUCCESS.value
CG_FAILURE = LinearSolverTerminationType.FAILURE.value
CG_FATAL_ERROR = LinearSolverTerminationType.FATAL_ERROR.value


def direct_termination(y: torch.Tensor) -> torch.Tensor:
    """FAILURE when a direct solve produced non-finite values."""
    ok = torch.all(torch.isfinite(y))
    return torch.where(ok, CG_SUCCESS, CG_FAILURE).to(torch.int32)


class CGResult(NamedTuple):
    x: torch.Tensor
    num_iterations: torch.Tensor  # int32 scalar
    termination: torch.Tensor  # CG_* code, int32 scalar
    final_norm_r: torch.Tensor


def _is_zero_or_inf(v):
    return (v == 0.0) | torch.isinf(v)


def conjugate_gradients(
    operator: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    preconditioner: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    max_num_iterations: int = 50,
    min_num_iterations: int = 1,
    q_tolerance: float = 0.0,
    r_tolerance: float = 1e-6,
    residual_reset_period: int = 10,
) -> CGResult:
    """Solve A x = rhs with PCG; A given as a matvec closure. Scalars are
    kept in rhs.dtype, as in the JAX package."""
    M = preconditioner if preconditioner is not None else (lambda v: v)
    dev, dt = rhs.device, rhs.dtype
    x = torch.zeros_like(rhs) if x0 is None else x0

    norm_rhs = torch.linalg.norm(rhs)
    tol_r = r_tolerance * norm_rhs
    r = rhs - operator(x)
    norm_r = torch.linalg.norm(r)
    Q0 = -torch.dot(x, rhs + r)

    if bool((norm_rhs == 0.0) | ((min_num_iterations == 0) & (norm_r <= tol_r))):
        return CGResult(
            x=torch.zeros_like(rhs) if bool(norm_rhs == 0.0) else x,
            num_iterations=torch.zeros((), dtype=torch.int32, device=dev),
            termination=torch.tensor(CG_SUCCESS, dtype=torch.int32, device=dev),
            final_norm_r=norm_r,
        )

    p = torch.zeros_like(rhs)
    rho = torch.ones((), dtype=dt, device=dev)
    termination = torch.tensor(CG_NO_CONVERGENCE, dtype=torch.int32, device=dev)
    i = 0
    while i < max_num_iterations:
        i += 1
        z = M(r)
        last_rho = rho
        rho = torch.dot(r, z)
        fail_rho = _is_zero_or_inf(rho)
        beta = rho / last_rho
        fail_beta = _is_zero_or_inf(beta) & (i > 1)
        p = z if i == 1 else z + beta * p

        q = operator(p)
        pq = torch.dot(p, q)
        indefinite = (pq <= 0.0) | torch.isinf(pq)
        alpha = rho / torch.where(indefinite, torch.ones_like(pq), pq)
        fail_alpha = torch.isinf(alpha)

        x_new = x + alpha * p
        # Residual refresh (conjugate_gradients_solver.h:222-237).
        if i % residual_reset_period == 0:
            r_new = rhs - operator(x_new)
        else:
            r_new = r - alpha * q

        Q1 = -torch.dot(x_new, rhs + r_new)
        zeta = i * (Q1 - Q0) / torch.where(Q1 == 0.0, torch.ones_like(Q1), Q1)
        norm_r = torch.linalg.norm(r_new)

        converged_q = (zeta < q_tolerance) & (i >= min_num_iterations)
        converged_r = (norm_r <= tol_r) & (i >= min_num_iterations)
        failed = fail_rho | fail_beta | fail_alpha
        done = failed | indefinite | converged_q | converged_r
        # Indefiniteness (pq <= 0) is FAILURE like the reference's
        # "Matrix is indefinite" return.
        termination = torch.where(
            failed | indefinite,
            CG_FAILURE,
            torch.where(converged_q | converged_r, CG_SUCCESS, CG_NO_CONVERGENCE),
        ).to(torch.int32)
        # On failure/indefiniteness keep the previous iterate.
        keep_old = fail_rho | fail_beta | indefinite
        x = torch.where(keep_old, x, x_new)
        r = torch.where(keep_old, r, r_new)
        Q0 = torch.where(done, Q0, Q1)
        if bool(done):
            break
    return CGResult(
        x=x,
        num_iterations=torch.tensor(i, dtype=torch.int32, device=dev),
        termination=termination,
        final_norm_r=norm_r,
    )
