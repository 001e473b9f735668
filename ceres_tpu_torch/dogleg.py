"""Dogleg trust-region strategy, traditional and two-dimensional subspace
(port of ``ceres_tpu/dogleg.py``; analog of
``internal/ceres/dogleg_strategy.{h,cc}``, the Shultz, Schnabel & Byrd
subspace dogleg).

The Cauchy point, the Gauss-Newton step and their interpolants are plain
functions on tensors over the ``JacobianContext``; the scalar state machine
(radius, regularization mu, reuse flag) stays on the host like the
reference's, and the 2-D boundary problem's quartic is solved on the host
(``ops/polynomial.polynomial_roots``), as it is O(1) work.

Scaling convention of dogleg_strategy.cc:168-175: the elliptical trust
region ||D step|| <= r is handled in the scaled space step' = D step, with
D = sqrt(clamped diag(J'J)). Every array stays in the evaluation dtype; the
host reads through ``trust_region._to_host``, one read per retry of the
Gauss-Newton solve and one for the step's norm and model cost change. In
the host loop ``precompute`` runs from ``host_loop_graphs`` (a CUDA graph
on the card, replayed per retry with mu a device scalar); ``traditional``,
``subspace_model`` and the model cost change are a few vector operations
and run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_SUCCESS
from ceres_tpu_torch.ops.polynomial import polynomial_roots
from ceres_tpu_torch.trust_region import _model_cost_change, _to_host
from ceres_tpu_torch.types import DoglegType

_MIN_MU = 1e-8
_MAX_MU = 1.0
_MU_INCREASE = 10.0


def precompute(ctx, mu: torch.Tensor, linear_solve, solve_aux, min_diagonal: float,
               max_diagonal: float):
    """The diagonal scaling, the scaled gradient, the Cauchy alpha and the
    scaled Gauss-Newton step regularized by D = diagonal * sqrt(mu)
    (dogleg_strategy.cc:120-134, 176-195, 560-568, ComputeGaussNewtonStep),
    mu an f64 device scalar. Returns (diagonal, gradient, alpha, gn_step,
    lin_iters, lin_term)."""
    diagonal = torch.sqrt(torch.clamp(ctx.squared_column_norms(), min_diagonal, max_diagonal))
    gradient = ctx.gradient() / diagonal
    jg = ctx.matvec(gradient / diagonal)
    jg_sq = ctx._sum(sum(torch.sum(w * w) for w in jg))
    alpha = torch.sum(gradient * gradient) / jg_sq
    y, lin_iters, lin_term = linear_solve(ctx, diagonal * torch.sqrt(mu).to(diagonal.dtype),
                                          solve_aux)
    # a mixed-precision solve returns an f64-refined y
    gn_step = -diagonal * y.to(diagonal.dtype)
    return diagonal, gradient, alpha, gn_step, lin_iters, lin_term


def traditional(diagonal, gradient, alpha, gn_step, radius: float):
    """ComputeTraditionalDoglegStep (dogleg_strategy.cc:199-257), branchless
    on the device: the Gauss-Newton step inside the region, else the Cauchy
    point on its boundary when that lies outside, else the interpolant.
    Returns (step, ||scaled step||) as device tensors."""
    gn_norm = torch.linalg.norm(gn_step)
    g_norm = torch.linalg.norm(gradient)
    b_dot_a = -alpha * torch.sum(gradient * gn_step)
    a_sq = (alpha * g_norm) ** 2
    b_minus_a_sq = a_sq - 2 * b_dot_a + gn_norm**2
    c = b_dot_a - a_sq
    d = torch.sqrt(torch.clamp(c * c + b_minus_a_sq * (radius**2 - a_sq), min=0.0))
    one = torch.ones_like(c)
    beta = torch.where(
        c <= 0,
        (d - c) / torch.where(b_minus_a_sq == 0, one, b_minus_a_sq),
        (radius**2 - a_sq) / torch.where(d + c == 0, one, d + c),
    )
    interp = (-alpha * (1.0 - beta)) * gradient + beta * gn_step
    cauchy = -(radius / torch.where(g_norm == 0, one, g_norm)) * gradient
    step_scaled = torch.where(
        gn_norm <= radius,
        gn_step,
        torch.where(g_norm * alpha >= radius, cauchy, interp),
    )
    return step_scaled / diagonal, torch.linalg.norm(step_scaled)


def subspace_model(ctx, diagonal, gradient, gn_step):
    """Orthonormal 2-D basis Q of span(gradient, gn_step) and the reduced
    model (B, g) with |diag(R)| (ComputeSubspaceModel,
    dogleg_strategy.cc:648-715)."""
    basis = torch.stack([gradient, gn_step], dim=1)  # (n, 2)
    Q, R = torch.linalg.qr(basis)
    jb0 = ctx.matvec(Q[:, 0] / diagonal)
    jb1 = ctx.matvec(Q[:, 1] / diagonal)
    b00 = sum(torch.sum(a * a) for a in jb0)
    b01 = sum(torch.sum(a * b) for a, b in zip(jb0, jb1))
    b11 = sum(torch.sum(b * b) for b in jb1)
    b00, b01, b11 = ctx._sum(torch.stack([b00, b01, b11])).unbind()
    B = torch.stack([torch.stack([b00, b01]), torch.stack([b01, b11])])
    g2 = Q.T @ gradient
    rdiag = torch.abs(torch.diagonal(R))
    return Q, B, g2, rdiag


def find_boundary_minimum(B: np.ndarray, g: np.ndarray, radius: float):
    """The minimum of 0.5 x'Bx + g'x on ||x|| = radius: the quartic in the
    Lagrange multiplier from its companion matrix, every root's real part a
    candidate (MakePolynomialForBoundaryConstrainedProblem +
    FindMinimumOnTrustRegionBoundary). Host f64; None when nothing
    qualifies."""
    detB = float(np.linalg.det(B))
    trB = float(np.trace(B))
    r2 = radius * radius
    B_adj = np.array([[B[1, 1], -B[0, 1]], [-B[1, 0], B[0, 0]]])
    poly = np.array(
        [
            r2,
            2.0 * r2 * trB,
            r2 * (trB * trB + 2.0 * detB) - g @ g,
            -2.0 * (g @ B_adj @ g - r2 * detB * trB),
            r2 * detB * detB - float((B_adj @ g) @ (B_adj @ g)),
        ]
    )
    if not np.all(np.isfinite(poly)):
        return None
    best, best_val = None, np.inf
    for y in polynomial_roots(poly, real_parts=True):
        M = B + y * np.eye(2)
        try:
            x = -np.linalg.solve(M, g)
        except np.linalg.LinAlgError:
            continue
        nx = np.linalg.norm(x)
        if nx > 0:
            xb = (radius / nx) * x
            val = 0.5 * xb @ B @ xb + g @ xb
            if val < best_val:
                best_val, best = val, x
    return best


class DoglegStrategy:
    """The host state machine over the functions above; the interface of
    ``LevenbergMarquardtStrategy`` plus ``compute_step``. With ``graphs``
    (``host_loop_graphs.HostLoopGraphs``) the Gauss-Newton solve is its
    ``dogleg`` region, on the context ``graphs.scaled()``, which is then
    the one ``compute_step`` is given."""

    def __init__(self, options, linear_solve, solve_aux=None, graphs=None):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.mu = _MIN_MU
        self.reuse = False
        self.dogleg_type = options.dogleg_type
        self.dogleg_step_norm = 0.0
        self.min_diagonal = options.min_lm_diagonal
        self.max_diagonal = options.max_lm_diagonal
        self._linear_solve = linear_solve
        self._solve_aux = solve_aux
        self._graphs = graphs
        self._cache = None  # (ctx, diagonal, gradient, alpha, gn_step)
        # Gauss-Newton solves redone at a larger mu in this solve (each
        # retry is one more linear solve and host read).
        self.mu_retries = 0

    def compute_step(self, ctx):
        """(step or None, model cost change, lin_iters, lin_termination),
        host numbers but the step."""
        lin_iters, lin_term = 0, CG_SUCCESS
        if not self.reuse or self._cache is None:
            # Fresh Cauchy / Gauss-Newton computation, raising mu on a
            # non-finite or FAILURE-terminated solve (the reference's LM
            # regularization retry). One host read per try.
            while True:
                diagonal, gradient, alpha, gn_step, checks = self._precompute(ctx)
                finite, lin_iters, lin_term = checks.cpu().tolist()
                lin_iters, lin_term = int(lin_iters), int(lin_term)
                if finite and lin_term < CG_FAILURE:
                    break
                self.mu *= _MU_INCREASE
                self.mu_retries += 1
                if self.mu >= _MAX_MU:
                    return None, 0.0, lin_iters, lin_term
            self._cache = (ctx, diagonal, gradient, alpha, gn_step)
        ctx, diagonal, gradient, alpha, gn_step = self._cache

        if self.dogleg_type == DoglegType.SUBSPACE_DOGLEG:
            step, norm = self._subspace_step(ctx, diagonal, gradient, alpha, gn_step)
        else:
            step, norm = traditional(diagonal, gradient, alpha, gn_step, self.radius)
        mcc = _model_cost_change(ctx, step)
        if isinstance(norm, torch.Tensor):
            norm, mcc = _to_host(norm, mcc)
        else:
            (mcc,) = _to_host(mcc)
        self.dogleg_step_norm = float(norm)
        return step, mcc, lin_iters, lin_term

    def _precompute(self, ctx):
        """:func:`precompute` at this mu: (diagonal, gradient, alpha,
        gn_step, (gn_step finite, lin_iters, lin_term) as one f64 device
        vector, read by the caller)."""
        if self._graphs is not None:
            return self._graphs.dogleg_precompute(self.mu)
        f64 = torch.float64
        mu = torch.full((), self.mu, dtype=f64, device=ctx.residuals[0].device)
        diagonal, gradient, alpha, gn_step, li, term = precompute(
            ctx, mu, self._linear_solve, self._solve_aux, self.min_diagonal, self.max_diagonal)
        checks = torch.stack([torch.all(torch.isfinite(gn_step)).to(f64), li.to(f64),
                              term.to(f64)])
        return diagonal, gradient, alpha, gn_step, checks

    def _subspace_step(self, ctx, diagonal, gradient, alpha, gn_step):
        """ComputeSubspaceDoglegStep (dogleg_strategy.cc:265-343): the
        Gauss-Newton step when inside the region, else the minimum of the
        model on the boundary within span(gradient, gn_step). Returns
        (step, norm), the norm a host float or a device tensor."""
        radius = self.radius
        (gn_norm,) = _to_host(torch.linalg.norm(gn_step))
        if gn_norm <= radius:
            return gn_step / diagonal, gn_norm

        Q, B, g2, rdiag = subspace_model(ctx, diagonal, gradient, gn_step)
        host = torch.cat(
            [B.reshape(-1), g2, rdiag, torch.linalg.norm(gradient).reshape(1)]
        ).to(torch.float64).cpu().numpy()
        Bnp, gnp, rd, g_norm = host[:4].reshape(2, 2), host[4:6], host[6:8], float(host[8])
        rank = int((rd > 1e-12 * max(rd.max(), 1e-300)).sum())
        if rank < 2:
            # 1-D subspace: along the gradient to the boundary.
            return -(radius / g_norm) * gradient / diagonal, radius

        minimum = find_boundary_minimum(Bnp, gnp, radius)
        if minimum is None:
            return traditional(diagonal, gradient, alpha, gn_step, radius)
        # First-order optimality check (dogleg_strategy.cc:322-343).
        grad_min = Bnp @ minimum + gnp
        denom = np.linalg.norm(minimum) * np.linalg.norm(grad_min)
        if denom == 0 or (-minimum @ grad_min) / denom < 0.99:
            return traditional(diagonal, gradient, alpha, gn_step, radius)
        step_scaled = Q[:, 0] * float(minimum[0]) + Q[:, 1] * float(minimum[1])
        return step_scaled / diagonal, radius

    # -- radius state machine (dogleg_strategy.cc:617-643) -------------------

    def step_accepted(self, step_quality: float) -> None:
        if step_quality < 0.25:
            self.radius *= 0.5
        if step_quality > 0.75:
            self.radius = max(self.radius, 3.0 * self.dogleg_step_norm)
        self.radius = min(self.radius, self.max_radius)
        self.mu = max(_MIN_MU, 2.0 * self.mu / _MU_INCREASE)
        self.reuse = False
        self._cache = None

    def step_rejected(self, step_quality: float) -> None:
        del step_quality
        self.radius *= 0.5
        self.reuse = True

    def step_is_invalid(self, step_quality: float = 0.0) -> None:
        del step_quality
        self.mu *= _MU_INCREASE
        self.reuse = False
        self._cache = None
