"""TinySolver: dense Levenberg-Marquardt for small fixed-size problems
(port of ``ceres_tpu/tiny_solver.py``, after ``include/ceres/tiny_solver.h``
and ``tiny_solver_autodiff_function.h``).

``tiny_solve`` solves one problem or a batch of independent ones at once:
x0 of shape (n,) or (B, n), ``fn`` written for one instance and batched by
``torch.func.vmap``, its Jacobian from ``jacfwd``. The JAX package runs
``vmap`` of a ``lax.while_loop``, whose batch goes on until every lane is
done while a finished lane's state is held by a select; here every lane
carries a ``done`` flag, a step is computed for all lanes and kept only for
the active ones, and the host reads one flag per iteration to stop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

_EPS = float(np.finfo(np.float64).eps)


class TinySolverResults(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor
    gradient_max_norm: torch.Tensor
    converged: torch.Tensor  # 0 = no convergence, 1 = gradient tolerance,
    # 2 = cost threshold, 3 = parameter tolerance (tiny_solver.h Status)


def _residuals_and_jacobian(fn: Callable, x: torch.Tensor):
    """(B, m) residuals and (B, m, n) Jacobians of a batch of points."""

    def f(z):
        out = fn(z)
        return out, out

    J, r = vmap(jacfwd(f, has_aux=True))(x)
    return r, J


def tiny_solve(
    fn: Callable,
    x0,
    max_num_iterations: int = 50,
    gradient_tolerance: float = 1e-10,
    parameter_tolerance: float = 1e-8,
    cost_threshold: float = _EPS,
    device="cuda",
) -> TinySolverResults:
    """Minimize 0.5 ||fn(x)||^2 by dense LM (Madsen-Nielsen-Tingleff), for
    x0 of shape (n,) or a batch (B, n). ``fn`` maps one (n,) point to its
    (m,) residuals in torch ops. A lane whose damped normal matrix is not
    positive definite rejects the step, as the JAX package's NaN Cholesky
    does. Results have x0's batch shape."""
    x0 = torch.as_tensor(x0).to(device)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    single = x0.ndim == 1
    x = x0[None] if single else x0
    B, n = x.shape
    dtype = x.dtype
    eye = torch.eye(n, dtype=dtype, device=x.device)

    r, J = _residuals_and_jacobian(fn, x)
    cost0 = 0.5 * torch.sum(r * r, dim=-1)
    jtj = J.transpose(1, 2) @ J
    u = 1e-4 * torch.amax(torch.diagonal(jtj, dim1=1, dim2=2), dim=-1)
    v = torch.full((B,), 2.0, dtype=dtype, device=x.device)
    cost = cost0
    it = torch.zeros((B,), dtype=torch.int32, device=x.device)
    done = torch.zeros((B,), dtype=torch.bool, device=x.device)
    status = torch.zeros((B,), dtype=torch.int32, device=x.device)

    while True:
        active = ~done & (it < max_num_iterations)
        if not bool(active.any()):
            break
        r, J = _residuals_and_jacobian(fn, x)
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        gmax = torch.amax(g.abs(), dim=-1)
        lhs = J.transpose(1, 2) @ J + u[:, None, None] * eye
        # Solve (J'J + uI) dx = -g (tiny_solver.h Update / Solve); a failed
        # factorization gives a NaN step, which is rejected below.
        L, info = torch.linalg.cholesky_ex(lhs)
        dx = -torch.cholesky_solve(g[..., None], L)[..., 0]
        dx = torch.where((info == 0)[:, None], dx, torch.nan)
        x_new = x + dx
        r_new = vmap(fn)(x_new)
        cost_new = 0.5 * torch.sum(r_new * r_new, dim=-1)
        # Gain ratio (Nielsen): predicted = 0.5 dx'(u dx - g).
        predicted = 0.5 * torch.sum(dx * (u[:, None] * dx - g), dim=-1)
        safe_pred = torch.where(predicted == 0, 1.0, predicted)
        rho = (cost - cost_new) / safe_pred
        accept = (rho > 0) & torch.isfinite(cost_new) & (predicted > 0)

        u_acc = u * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        u_next = torch.where(accept, u_acc, u * v)
        v_next = torch.where(accept, 2.0, 2.0 * v)
        x_next = torch.where(accept[:, None], x_new, x)
        cost_next = torch.where(accept, cost_new, cost)

        dx_norm = torch.linalg.vector_norm(dx, dim=-1)
        x_norm = torch.linalg.vector_norm(x, dim=-1)
        grad_conv = gmax <= gradient_tolerance
        param_conv = accept & (dx_norm <= parameter_tolerance * (x_norm + parameter_tolerance))
        cost_conv = cost_next <= cost_threshold
        status_next = torch.where(
            grad_conv, 1, torch.where(cost_conv, 2, torch.where(param_conv, 3, 0))
        ).to(torch.int32)

        # A finished lane keeps its state, as the batched while_loop's select.
        x = torch.where(active[:, None], x_next, x)
        u = torch.where(active, u_next, u)
        v = torch.where(active, v_next, v)
        cost = torch.where(active, cost_next, cost)
        status = torch.where(active, status_next, status)
        done = torch.where(active, grad_conv | param_conv | cost_conv, done)
        it = it + active.to(torch.int32)

    r, J = _residuals_and_jacobian(fn, x)
    gnorm = torch.amax((J.transpose(1, 2) @ r[..., None])[..., 0].abs(), dim=-1)
    out = TinySolverResults(
        x=x, cost=cost, initial_cost=cost0, iterations=it,
        gradient_max_norm=gnorm, converged=status,
    )
    if single:
        out = TinySolverResults(*(a[0] for a in out))
    return out


class TinySolver:
    """Object wrapper with the reference class's shape (tiny_solver.h)."""

    def __init__(
        self,
        max_num_iterations: int = 50,
        gradient_tolerance: float = 1e-10,
        parameter_tolerance: float = 1e-8,
        cost_threshold: float = _EPS,
    ):
        self.max_num_iterations = max_num_iterations
        self.gradient_tolerance = gradient_tolerance
        self.parameter_tolerance = parameter_tolerance
        self.cost_threshold = cost_threshold

    def solve(self, fn: Callable, x0, device="cuda") -> TinySolverResults:
        return tiny_solve(
            fn,
            torch.as_tensor(np.asarray(x0, dtype=np.float64)),
            self.max_num_iterations,
            self.gradient_tolerance,
            self.parameter_tolerance,
            self.cost_threshold,
            device=device,
        )
