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
D = sqrt(clamped diag(J'J)). Every array stays in the evaluation dtype. The
device work runs from ``host_loop_graphs``' regions (CUDA graphs on the card
where the host loop is captured): ``precompute`` (the ``dogleg`` region,
replayed per retry with mu a device scalar), and the step choice of
``host_loop_graphs.DoglegRegions`` (the radius a device scalar, the
subspace step's coefficients copied in from the host). The host reads once
per retry of the Gauss-Newton solve, once for the subspace model (which
holds ||gn_step||, so the Gauss-Newton branch needs no read of its own) and
once for the step's norm and model cost change. Under
SPARSE_NORMAL_CHOLESKY the Gauss-Newton solve is regions around the host
factor (:class:`SparseGaussNewton`), which read J'J's cells once a point
(and, with mixed precision, the refinement's residual once a refinement
step).
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_FATAL_ERROR, CG_SUCCESS
from ceres_tpu_torch.ops.polynomial import polynomial_roots
from ceres_tpu_torch.types import DoglegType

_MIN_MU = 1e-8
_MAX_MU = 1.0
_MU_INCREASE = 10.0


def cauchy(ctx, min_diagonal: float, max_diagonal: float):
    """The diagonal scaling, J'f, the scaled gradient and the Cauchy alpha
    (dogleg_strategy.cc:120-134, 176-195): (diagonal, jtf, gradient,
    alpha)."""
    diagonal = torch.sqrt(torch.clamp(ctx.squared_column_norms(), min_diagonal, max_diagonal))
    jtf = ctx.gradient()
    gradient = jtf / diagonal
    jg = ctx.matvec(gradient / diagonal)
    jg_sq = ctx._sum(sum(torch.sum(w * w) for w in jg))
    alpha = torch.sum(gradient * gradient) / jg_sq
    return diagonal, jtf, gradient, alpha


def precompute(ctx, mu: torch.Tensor, linear_solve, solve_aux, min_diagonal: float,
               max_diagonal: float):
    """The diagonal scaling, the scaled gradient, the Cauchy alpha and the
    scaled Gauss-Newton step regularized by D = diagonal * sqrt(mu)
    (:func:`cauchy`; dogleg_strategy.cc:560-568, ComputeGaussNewtonStep),
    mu an f64 device scalar. Returns (diagonal, gradient, alpha, gn_step,
    lin_iters, lin_term)."""
    diagonal, _, gradient, alpha = cauchy(ctx, min_diagonal, max_diagonal)
    y, lin_iters, lin_term = linear_solve(ctx, diagonal * torch.sqrt(mu).to(diagonal.dtype),
                                          solve_aux)
    # a mixed-precision solve returns an f64-refined y
    gn_step = -diagonal * y.to(diagonal.dtype)
    return diagonal, gradient, alpha, gn_step, lin_iters, lin_term


def traditional(diagonal, gradient, alpha, gn_step, radius: torch.Tensor):
    """ComputeTraditionalDoglegStep (dogleg_strategy.cc:199-257), branchless
    on the device: the Gauss-Newton step inside the region, else the Cauchy
    point on its boundary when that lies outside, else the interpolant.
    ``radius`` an f64 device scalar, taken in the evaluation dtype (its
    square rounded once from f64). Returns (step, ||scaled step||) as device
    tensors."""
    r = radius.to(gradient.dtype)
    r2 = (radius * radius).to(gradient.dtype)
    gn_norm = torch.linalg.norm(gn_step)
    g_norm = torch.linalg.norm(gradient)
    b_dot_a = -alpha * torch.sum(gradient * gn_step)
    a_sq = (alpha * g_norm) ** 2
    b_minus_a_sq = a_sq - 2 * b_dot_a + gn_norm**2
    c = b_dot_a - a_sq
    d = torch.sqrt(torch.clamp(c * c + b_minus_a_sq * (r2 - a_sq), min=0.0))
    one = torch.ones_like(c)
    beta = torch.where(
        c <= 0,
        (d - c) / torch.where(b_minus_a_sq == 0, one, b_minus_a_sq),
        (r2 - a_sq) / torch.where(d + c == 0, one, d + c),
    )
    interp = (-alpha * (1.0 - beta)) * gradient + beta * gn_step
    cauchy = -(r / torch.where(g_norm == 0, one, g_norm)) * gradient
    step_scaled = torch.where(
        gn_norm <= r,
        gn_step,
        torch.where(g_norm * alpha >= r, cauchy, interp),
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


def subspace_step(Q, gradient, diagonal, coef: torch.Tensor) -> torch.Tensor:
    """The subspace dogleg's step from the host's coefficients ``coef`` (an
    f64 device 4-vector (m0, m1, c, one_d)): Q m, the minimum on the
    boundary in Q's basis, or with one_d nonzero c * gradient, the 1-D
    subspace's step along the gradient to the boundary; unscaled by the
    diagonal."""
    w = coef.to(Q.dtype)
    step_scaled = torch.where(coef[3] != 0, w[2] * gradient, Q[:, 0] * w[0] + Q[:, 1] * w[1])
    return step_scaled / diagonal


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


class SparseGaussNewton:
    """DOGLEG's Gauss-Newton solve under SPARSE_NORMAL_CHOLESKY, f(ctx, mu)
    -> :func:`precompute`'s (diagonal, gradient, alpha, gn_step) and its
    checks vector, as regions around the host factor (the JAX package
    computes the solve in its graph through a host callback, its
    ``trust_region.py:399-420``), on ``regions``
    (``host_loop_graphs.SparseRegions``):

    - ``dogleg_sparse_prep``: :func:`cauchy`'s terms and J'J's cells
      (``linear/inner_product.py``; on a sharded program the whole
      program's, all-reduced), the diagonal, J'f and the cells read once;
    - the host damps the cells with D = diagonal sqrt(mu), the reference's
      D (no f32 floor), and factors them
      (``inner_product.host_normal_factor_solve``);
    - ``dogleg_sparse_finish``: gn_step from the host's solution (rank 0's,
      broadcast, on a sharded program) and the checks vector.

    A new mu at the same point damps the same host cells again, with no
    card work, as the LM step's reject streak does.

    With ``use_mixed_precision_solves`` the solve is the JAX package's
    mixed-precision wrapper around its f32 solve (its
    ``trust_region.py:439-472``): the prep's cells are those of the
    Jacobian cast to f32 (summed in f64, as the host callback sums them),
    the host factors them in f64 once a (point, mu) with D cast to f32,
    and each solve's right-hand side and result are rounded to f32; y
    starts from rhs and takes ``num_refinement_iterations`` corrections,
    each from the f64 residual of the ``dogleg_sparse_refine`` region (one
    read). The iterations add up and the termination is the worst."""

    def __init__(self, config, program, regions):
        from ceres_tpu_torch.linear.inner_product import normal_assembly

        self.config, self.regions = config, regions
        self.plan, self.assembly = normal_assembly(program)
        self._state: dict = {"ctx": None}

    def __call__(self, ctx, mu: float):
        from ceres_tpu_torch.linear.inner_product import host_normal_factor_solve

        c, regions, state = self.config, self.regions, self._state
        if state["ctx"] is not ctx:
            regions.dogleg_sparse_prep(ctx, self.plan)
            diag_h, rhs_h, *cells_h = regions.read_flat("dogleg_sparse_prep")
            dtype = np.float32 if ctx.dtype == torch.float32 else np.float64
            state.update(ctx=ctx, diag=diag_h.astype(dtype), rhs=rhs_h, cells=cells_h)
        diag_h = state["diag"]
        D_h = diag_h * diag_h.dtype.type(np.sqrt(mu))
        if c.use_mixed_precision_solves:
            return regions.dogleg_sparse_finish(ctx, *self._refined(ctx, D_h, mu))
        y, term = host_normal_factor_solve(
            self.assembly, state["cells"], D_h, state["rhs"], ordering=c.ordering_type,
            use_postordering=c.use_postordering)
        return regions.dogleg_sparse_finish(ctx, y, 1, term)

    def _refined(self, ctx, D_h, mu: float):
        """(y f64, linear iterations, termination) of the mixed-precision
        solve at mu (see the class). A failed solve ends it with y = 0: the
        strategy retries at a larger mu whatever y is."""
        from ceres_tpu_torch.linear.inner_product import host_normal_factor

        c, state = self.config, self._state
        iters = 1 + c.num_refinement_iterations
        chol = host_normal_factor(self.assembly, state["cells"], D_h.astype(np.float32),
                                  ordering=c.ordering_type, use_postordering=c.use_postordering)
        if chol is None:
            return np.zeros(ctx.num_tangent), iters, CG_FAILURE
        y = None
        for _ in range(iters):
            b = state["rhs"] if y is None else self.regions.dogleg_sparse_refine(ctx, y, mu)
            dy = chol.solve(b.astype(np.float32).astype(np.float64))
            if not np.all(np.isfinite(dy)):
                return np.zeros(ctx.num_tangent), iters, CG_FATAL_ERROR
            dy = dy.astype(np.float32).astype(np.float64)
            y = dy if y is None else y + dy
        return y, iters, CG_SUCCESS


class DoglegStrategy:
    """The host state machine over the functions above; the interface of
    ``LevenbergMarquardtStrategy`` plus ``compute_step``. With ``graphs``
    (``host_loop_graphs.HostLoopGraphs``) the Gauss-Newton solve is its
    ``dogleg`` region, on the context ``graphs.scaled()``, which is then
    the one ``compute_step`` is given, and the step choice its
    ``DoglegRegions``' regions; without, both run eagerly (the step choice
    on ``DoglegRegions`` of its own, made at the first step). ``sparse``
    (a :class:`SparseGaussNewton`) takes the Gauss-Newton solve in place
    of the ``dogleg`` region."""

    def __init__(self, options, linear_solve, solve_aux=None, graphs=None, sparse=None):
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
        self._regions = graphs
        self._sparse = sparse
        self._cache = None  # (ctx, diagonal, gradient, alpha, gn_step)
        self._model = None  # the subspace model of the cache, read on the host
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
            self._model = None
        if self._regions is None:
            from ceres_tpu_torch.host_loop_graphs import DoglegRegions

            self._regions = DoglegRegions(ctx.residuals[0].device, captured=False)

        if self.dogleg_type == DoglegType.SUBSPACE_DOGLEG:
            step, norm, mcc = self._subspace_step()
        else:
            step, norm, mcc = self._traditional()
        self.dogleg_step_norm = norm
        return step, mcc, lin_iters, lin_term

    def _traditional(self):
        """The traditional step at this radius: (step, norm, model cost
        change), one read."""
        step, scalars = self._regions.dogleg_traditional(self._cache, self.radius)
        norm, mcc = scalars.cpu().tolist()
        return step, norm, mcc

    def _precompute(self, ctx):
        """:func:`precompute` at this mu: (diagonal, gradient, alpha,
        gn_step, (gn_step finite, lin_iters, lin_term) as one f64 device
        vector, read by the caller)."""
        if self._sparse is not None:
            return self._sparse(ctx, self.mu)
        if self._graphs is not None:
            return self._graphs.dogleg_precompute(self.mu)
        f64 = torch.float64
        mu = torch.full((), self.mu, dtype=f64, device=ctx.residuals[0].device)
        diagonal, gradient, alpha, gn_step, li, term = precompute(
            ctx, mu, self._linear_solve, self._solve_aux, self.min_diagonal, self.max_diagonal)
        checks = torch.stack([torch.all(torch.isfinite(gn_step)).to(f64), li.to(f64),
                              term.to(f64)])
        return diagonal, gradient, alpha, gn_step, checks

    def _subspace_step(self):
        """ComputeSubspaceDoglegStep (dogleg_strategy.cc:265-343): the
        Gauss-Newton step when inside the region, else the minimum of the
        model on the boundary within span(gradient, gn_step). Returns
        (step, norm, model cost change). The model (with ||gn_step||) is
        read once per Gauss-Newton solve, the step's model cost change once
        per step."""
        radius, regions = self.radius, self._regions
        if self._model is None:
            host = regions.dogleg_subspace_model(self._cache).cpu().numpy()
            self._model = (host[:4].reshape(2, 2), host[4:6], host[6:8], float(host[8]),
                           float(host[9]))
        Bnp, gnp, rd, g_norm, gn_norm = self._model
        if gn_norm <= radius:
            # the traditional step is the Gauss-Newton step there
            return self._traditional()
        rank = int((rd > 1e-12 * max(rd.max(), 1e-300)).sum())
        if rank < 2:
            # 1-D subspace: along the gradient to the boundary.
            coef = np.array([0.0, 0.0, -(radius / g_norm), 1.0])
        else:
            minimum = find_boundary_minimum(Bnp, gnp, radius)
            if minimum is None:
                return self._traditional()
            # First-order optimality check (dogleg_strategy.cc:322-343).
            grad_min = Bnp @ minimum + gnp
            denom = np.linalg.norm(minimum) * np.linalg.norm(grad_min)
            if denom == 0 or (-minimum @ grad_min) / denom < 0.99:
                return self._traditional()
            coef = np.array([float(minimum[0]), float(minimum[1]), 0.0, 0.0])
        step, mcc = regions.dogleg_subspace_step(self._cache, coef)
        (mcc,) = mcc.cpu().tolist()
        return step, radius, mcc

    # -- radius state machine (dogleg_strategy.cc:617-643) -------------------

    def step_accepted(self, step_quality: float) -> None:
        if step_quality < 0.25:
            self.radius *= 0.5
        if step_quality > 0.75:
            self.radius = max(self.radius, 3.0 * self.dogleg_step_norm)
        self.radius = min(self.radius, self.max_radius)
        self.mu = max(_MIN_MU, 2.0 * self.mu / _MU_INCREASE)
        self.reuse = False
        self._cache = self._model = None

    def step_rejected(self, step_quality: float) -> None:
        del step_quality
        self.radius *= 0.5
        self.reuse = True

    def step_is_invalid(self, step_quality: float = 0.0) -> None:
        del step_quality
        self.mu *= _MU_INCREASE
        self.reuse = False
        self._cache = self._model = None
