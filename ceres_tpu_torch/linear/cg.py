"""Preconditioned conjugate gradients (port of ``ceres_tpu/linear/cg.py``,
after conjugate_gradients_solver.h:108-300).

Same update order, Nash-Sofer Q-based termination (zeta test), r-tolerance
test, residual refresh every ``residual_reset_period`` iterations, and the
indefiniteness / numerical-failure guards. The stop is a device value,
as in the JAX package's ``lax.while_loop``: the loop is
``utils.cuda_graph.run_while`` over blocks of iterations, each under
``run_if``, so that inside the fused loop's CUDA graph it is a WHILE node
the device repeats until the stop, and the host reads nothing; run eagerly
(the CPU, the host loop, an uncaptured solve) each ``run_if`` reads the
flag, one read per iteration as before and one per block. On
a sharded program (``parallel/sharding.py``) every vector here is the same
on every rank, built from all-reduced products by the same arithmetic, so
every rank reads the same flag and stops at the same iteration.
``conjugate_gradients_columns`` (the matrix-free covariance's batched CG)
runs the same loop over k columns at once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ceres_tpu_torch.types import LinearSolverTerminationType
from ceres_tpu_torch.utils.cuda_graph import run_if, run_while

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
    kept in rhs.dtype, as in the JAX package. The loop is ``run_while`` over
    blocks of ``residual_reset_period`` iterations, each iteration under
    ``run_if`` of the same test (not done, under the cap): captured, one
    WHILE node holding one block, so that the capture does not grow with
    ``max_num_iterations``, and each iteration's place in its block says
    statically whether it refreshes the residual; eagerly, one read per
    iteration and one per block."""
    M = preconditioner if preconditioner is not None else (lambda v: v)
    dev, dt = rhs.device, rhs.dtype

    norm_rhs = torch.linalg.norm(rhs)
    tol_r = r_tolerance * norm_rhs
    x = torch.zeros_like(rhs) if x0 is None else x0.clone()
    r = rhs - operator(x)
    norm_r = torch.linalg.norm(r)
    Q0 = -torch.dot(x, rhs + r)
    # Done before the first iteration (the JAX package's lax.cond): a zero
    # rhs, whose solution is 0, or min_num_iterations = 0 with x0 already
    # good enough.
    zero_rhs = norm_rhs == 0.0
    done = zero_rhs | ((min_num_iterations == 0) & (norm_r <= tol_r))
    x.copy_(torch.where(zero_rhs, 0.0, x))
    termination = torch.where(done, CG_SUCCESS, CG_NO_CONVERGENCE).to(torch.int32)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    p = torch.zeros_like(rhs)
    rho = torch.ones((), dtype=dt, device=dev)

    def iteration(j: int) -> None:
        # CG iteration i = iterations + 1, the j-th of its block (i = j
        # modulo the period); the state changes only through copy_.
        i = iterations + 1
        z = M(r)
        rho_new = torch.dot(r, z)
        fail_rho = _is_zero_or_inf(rho_new)
        beta = rho_new / rho
        fail_beta = _is_zero_or_inf(beta) & (i > 1)
        p_new = torch.where(i == 1, z, z + beta * p) if j == 1 else z + beta * p

        q = operator(p_new)
        pq = torch.dot(p_new, q)
        indefinite = (pq <= 0.0) | torch.isinf(pq)
        alpha = rho_new / torch.where(indefinite, torch.ones_like(pq), pq)
        fail_alpha = torch.isinf(alpha)

        x_new = x + alpha * p_new
        # Residual refresh (conjugate_gradients_solver.h:222-237).
        if j == residual_reset_period:
            r_new = rhs - operator(x_new)
        else:
            r_new = r - alpha * q

        Q1 = -torch.dot(x_new, rhs + r_new)
        zeta = i.to(dt) * (Q1 - Q0) / torch.where(Q1 == 0.0, torch.ones_like(Q1), Q1)
        norm_r_new = torch.linalg.norm(r_new)

        converged_q = (zeta < q_tolerance) & (i >= min_num_iterations)
        converged_r = (norm_r_new <= tol_r) & (i >= min_num_iterations)
        failed = fail_rho | fail_beta | fail_alpha
        stop = failed | indefinite | converged_q | converged_r
        # Indefiniteness (pq <= 0) is FAILURE like the reference's
        # "Matrix is indefinite" return.
        termination.copy_(torch.where(
            failed | indefinite,
            CG_FAILURE,
            torch.where(converged_q | converged_r, CG_SUCCESS, CG_NO_CONVERGENCE),
        ))
        # On failure/indefiniteness keep the previous iterate. p first: at
        # i = 1 without a preconditioner p_new is r itself.
        keep_old = fail_rho | fail_beta | indefinite
        p.copy_(p_new)
        x.copy_(torch.where(keep_old, x, x_new))
        r.copy_(torch.where(keep_old, r, r_new))
        Q0.copy_(torch.where(stop, Q0, Q1))
        rho.copy_(rho_new)
        norm_r.copy_(norm_r_new)
        iterations.copy_(i)
        done.copy_(stop)

    def running():
        return ~done & (iterations < max_num_iterations)

    def block() -> None:
        for j in range(1, residual_reset_period + 1):
            with run_if(running()) as go:
                if not go:
                    break
                iteration(j)

    run_while(running, block)
    return CGResult(x=x, num_iterations=iterations, termination=termination, final_norm_r=norm_r)


def conjugate_gradients_columns(
    operator: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    preconditioner: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_num_iterations: int = 50,
    min_num_iterations: int = 1,
    q_tolerance: float = 0.0,
    r_tolerance: float = 1e-6,
    residual_reset_period: int = 10,
) -> CGResult:
    """:func:`conjugate_gradients` on the k columns of rhs (n, k) at once,
    from x0 = 0, the analog of the JAX package's ``vmap`` of its
    ``while_loop``: every column runs the same update with its own scalars
    and stops on its own test; a finished column's state is frozen (the
    vmapped loop's select) while the others go on. ``operator`` and
    ``preconditioner`` map (n, k) to (n, k) column by column. The loop is
    :func:`conjugate_gradients`'s: ``run_while`` over blocks of
    ``residual_reset_period`` iterations, each under ``run_if`` of "some
    column running and under the cap" (a running column's count is the
    batch's, so the block says statically where the residual refreshes);
    captured, one WHILE node; eagerly, one read per iteration and one per
    block. Returns x (n, k) and (k,) iteration counts, terminations and
    residual norms."""
    M = preconditioner if preconditioner is not None else (lambda v: v)
    dev, dt = rhs.device, rhs.dtype
    k = rhs.shape[1]

    def dot(a, b):
        return torch.sum(a * b, dim=0)

    x = torch.zeros_like(rhs)
    norm_rhs = torch.linalg.vector_norm(rhs, dim=0)
    tol_r = r_tolerance * norm_rhs
    r = rhs - operator(x)
    norm_r = torch.linalg.vector_norm(r, dim=0)
    Q0 = -dot(x, rhs + r)
    # Columns done before the loop (a zero rhs, or min_num_iterations = 0
    # with x0 already good enough).
    done = (norm_rhs == 0.0) | ((min_num_iterations == 0) & (norm_r <= tol_r))
    termination = torch.where(done, CG_SUCCESS, CG_NO_CONVERGENCE).to(torch.int32)
    iterations = torch.zeros((k,), dtype=torch.int32, device=dev)
    batch_iterations = torch.zeros((), dtype=torch.int32, device=dev)
    p = torch.zeros_like(rhs)
    rho = torch.ones((k,), dtype=dt, device=dev)

    def iteration(j: int) -> None:
        # the batch's iteration i, the j-th of its block; the state changes
        # only through copy_
        i = batch_iterations + 1
        active = ~done
        z = M(r)
        rho_new = dot(r, z)
        fail_rho = _is_zero_or_inf(rho_new)
        beta = rho_new / rho
        fail_beta = _is_zero_or_inf(beta) & (i > 1)
        p_new = torch.where(i == 1, z, z + beta * p) if j == 1 else z + beta * p

        q = operator(p_new)
        pq = dot(p_new, q)
        indefinite = (pq <= 0.0) | torch.isinf(pq)
        alpha = rho_new / torch.where(indefinite, torch.ones_like(pq), pq)
        fail_alpha = torch.isinf(alpha)

        x_new = x + alpha * p_new
        if j == residual_reset_period:
            r_new = rhs - operator(x_new)
        else:
            r_new = r - alpha * q

        Q1 = -dot(x_new, rhs + r_new)
        zeta = i.to(dt) * (Q1 - Q0) / torch.where(Q1 == 0.0, torch.ones_like(Q1), Q1)
        norm_r_new = torch.linalg.vector_norm(r_new, dim=0)

        converged = ((zeta < q_tolerance) | (norm_r_new <= tol_r)) & (i >= min_num_iterations)
        failed = fail_rho | fail_beta | fail_alpha
        stop = failed | indefinite | converged
        term = torch.where(
            failed | indefinite, CG_FAILURE, torch.where(converged, CG_SUCCESS, CG_NO_CONVERGENCE)
        ).to(torch.int32)
        keep_old = fail_rho | fail_beta | indefinite
        # The batched while_loop's select: only active columns move.
        move = active & ~keep_old
        x.copy_(torch.where(move, x_new, x))
        r.copy_(torch.where(move, r_new, r))
        p.copy_(torch.where(active, p_new, p))
        rho.copy_(torch.where(active, rho_new, rho))
        Q0.copy_(torch.where(active & ~stop, Q1, Q0))
        norm_r.copy_(torch.where(active, norm_r_new, norm_r))
        termination.copy_(torch.where(active, term, termination))
        iterations.copy_(iterations + active.to(torch.int32))
        batch_iterations.copy_(i)
        done.copy_(done | stop)

    def running():
        return ~torch.all(done) & (batch_iterations < max_num_iterations)

    def block() -> None:
        for j in range(1, residual_reset_period + 1):
            with run_if(running()) as go:
                if not go:
                    break
                iteration(j)

    run_while(running, block)
    return CGResult(x=x, num_iterations=iterations, termination=termination, final_norm_r=norm_r)
