"""TinySolver: dense Levenberg-Marquardt for small fixed-size problems
(port of ``ceres_tpu/tiny_solver.py``, after ``include/ceres/tiny_solver.h``
and ``tiny_solver_autodiff_function.h``).

``tiny_solve`` solves one problem or a batch of independent ones at once:
x0 of shape (n,) or (B, n), ``fn`` written for one instance and batched by
``torch.func.vmap``, its Jacobian from ``jacfwd``. The JAX package runs
``vmap`` of a ``lax.while_loop`` inside ``jit``, whose batch goes on until
every lane is done while a finished lane's state is held by a select. Here
every lane carries a ``done`` flag, a step is computed for all lanes and
kept only for the active ones, and the loop is ``utils.cuda_graph.run_while``
on "some lane active" (:class:`_TinyLoop`). On the card the whole solve is
captured once per ``fn``, batch shape, dtype, device and the four options
(the JAX package's ``jit`` cache on its static arguments) as a CUDA graph
whose loop is a WHILE node, and every call replays it: a call reads the
host no more for more iterations. The graph, its memory pool and its static
buffers are kept for the life of the process, as ``jit`` keeps its
executables; ``fn`` must be pure tensor operations, as the JAX package
needs it traceable. On the CPU the same loop runs eagerly, one read per
iteration.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ceres_tpu_torch.ops.small_linalg import cholesky_solve
from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, run_while, uncounted

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


class _TinyLoop:
    """Batched solves of ``fn`` from static buffers: a (B, n) start in
    ``x0``, the state changing only by ``copy_`` so that the loop runs the
    same eagerly and as a WHILE node. With ``captured`` (the card) the solve
    is captured once, after a one-iteration warm-up from ``x_like``, and
    :meth:`run` replays it."""

    def __init__(self, fn: Callable, x_like: torch.Tensor, max_num_iterations: int,
                 gradient_tolerance: float, parameter_tolerance: float,
                 cost_threshold: float, captured: bool):
        B, n = x_like.shape
        dtype, device = x_like.dtype, x_like.device
        self.fn = fn
        self.options = (max_num_iterations, gradient_tolerance, parameter_tolerance,
                        cost_threshold)
        self.x0 = x_like.clone()
        self.budget = torch.zeros((), dtype=torch.int32, device=device)
        self.x = torch.zeros_like(self.x0)
        self.u, self.v, self.cost, self.cost0, self.gmax = (
            torch.zeros((B,), dtype=dtype, device=device) for _ in range(5))
        self.it, self.status = (torch.zeros((B,), dtype=torch.int32, device=device)
                                for _ in range(2))
        self.done = torch.zeros((B,), dtype=torch.bool, device=device)
        self.eye = torch.eye(n, dtype=dtype, device=device)
        self.graph = None
        self.capture_seconds = 0.0
        if captured:
            t0 = time.perf_counter()
            self.budget.fill_(1)
            with uncounted():
                self._solve()
            self.graph = CapturedGraph(self._solve, device)
            self.capture_seconds = time.perf_counter() - t0

    def _active(self) -> torch.Tensor:
        return ~self.done & (self.it < self.budget)

    def _iteration(self) -> None:
        fn, x, u, v, cost = self.fn, self.x, self.u, self.v, self.cost
        _, gradient_tolerance, parameter_tolerance, cost_threshold = self.options
        active = self._active()
        r, J = _residuals_and_jacobian(fn, x)
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        gmax = torch.amax(g.abs(), dim=-1)
        lhs = J.transpose(1, 2) @ J + u[:, None, None] * self.eye
        # Solve (J'J + uI) dx = -g (tiny_solver.h Update / Solve); a failed
        # factorization gives a NaN step, which is rejected below.
        L, info = torch.linalg.cholesky_ex(lhs)
        dx = -cholesky_solve(L, g[..., None])[..., 0]
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
        x.copy_(torch.where(active[:, None], x_next, x))
        u.copy_(torch.where(active, u_next, u))
        v.copy_(torch.where(active, v_next, v))
        cost.copy_(torch.where(active, cost_next, cost))
        self.status.copy_(torch.where(active, status_next, self.status))
        self.done.copy_(torch.where(active, grad_conv | param_conv | cost_conv, self.done))
        self.it.copy_(self.it + active.to(torch.int32))

    def _solve(self) -> None:
        r, J = _residuals_and_jacobian(self.fn, self.x0)
        self.cost0.copy_(0.5 * torch.sum(r * r, dim=-1))
        jtj = J.transpose(1, 2) @ J
        self.u.copy_(1e-4 * torch.amax(torch.diagonal(jtj, dim1=1, dim2=2), dim=-1))
        self.v.fill_(2.0)
        self.x.copy_(self.x0)
        self.cost.copy_(self.cost0)
        for t in (self.it, self.status, self.done):
            t.zero_()
        run_while(lambda: torch.any(self._active()), self._iteration)
        r, J = _residuals_and_jacobian(self.fn, self.x)
        self.gmax.copy_(torch.amax((J.transpose(1, 2) @ r[..., None])[..., 0].abs(), dim=-1))

    def run(self, x0: torch.Tensor) -> TinySolverResults:
        """The solve from ``x0``; the results are copies (the buffers serve
        the next call)."""
        self.x0.copy_(x0)
        self.budget.fill_(self.options[0])
        if self.graph is None:
            self._solve()
        else:
            self.graph.replay()
        return TinySolverResults(
            x=self.x.clone(), cost=self.cost.clone(), initial_cost=self.cost0.clone(),
            iterations=self.it.clone(), gradient_max_norm=self.gmax.clone(),
            converged=self.status.clone(),
        )


# The card's captured solves, by fn, batch shape, dtype, device and options.
_LOOPS: dict = {}


def tiny_loop(fn: Callable, x: torch.Tensor, *options) -> _TinyLoop:
    """The solve loop of ``fn`` from starts shaped as ``x`` (B, n) with these
    options: on the card the one captured at the first call with them,
    elsewhere a new eager one."""
    if x.device.type != "cuda":
        return _TinyLoop(fn, x, *options, captured=False)
    key = (fn, tuple(x.shape), x.dtype, x.device, *options)
    loop = _LOOPS.get(key)
    if loop is None:
        loop = _LOOPS[key] = _TinyLoop(fn, x, *options, captured=True)
    return loop


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
    does. Results have x0's batch shape. On the card the first call with a
    given ``fn``, shape, dtype and options captures the solve (a failed
    capture raises) and every call replays it."""
    x0 = torch.as_tensor(x0).to(device)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float64)
    single = x0.ndim == 1
    x = x0[None] if single else x0
    loop = tiny_loop(fn, x, int(max_num_iterations), float(gradient_tolerance),
                     float(parameter_tolerance), float(cost_threshold))
    out = loop.run(x)
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
