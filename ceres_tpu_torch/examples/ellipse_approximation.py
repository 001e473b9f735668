"""Ellipse approximation — analog of examples/ellipse_approximation.cc.

Fits a closed line-segment contour to points sampled from a rotated
ellipse by JOINTLY optimizing the contour control points and each data
point's preimage position on the contour. In the reference this is the
showcase for ``dynamic_sparsity``: which control-point pair a residual
touches changes as its preimage slides along the contour.

Here the control-point matrix is ONE vector block and the dependence on
the (dynamically chosen) segment is a differentiable gather: the segment's
index comes from floor(t), which carries no derivative, and the gather is
batched under the evaluator's ``vmap``. The ``dynamic_sparsity`` option is
still exercised by the second solve.
"""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


def make_ellipse_data(num=212, seed=1337):
    """Same generator as the data comment in ellipse_approximation.cc."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 2.0 * np.pi, num, endpoint=False)
    t += 2.0 * np.pi * 0.01 * rng.randn(t.size)
    theta = np.deg2rad(15)
    a, b = np.cos(theta), np.sin(theta)
    R = np.array([[a, -b], [b, a]])
    return np.c_[4.0 * np.cos(t), np.sin(t)] @ R.T


def contour_point(X_flat, t, num_segments):
    """Point on the closed contour at preimage t (a one-element tensor;
    segments parameterized by arc index): floor(t) picks the segment,
    frac(t) interpolates."""
    X = X_flat.reshape(num_segments, 2)
    tm = torch.remainder(t, num_segments)
    i0 = torch.floor(tm).long()
    i1 = torch.remainder(i0 + 1, num_segments)
    frac = tm - i0
    return ((1.0 - frac) * X.index_select(0, i0) + frac * X.index_select(0, i1)).reshape(-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_segments", type=int, default=151)
    ap.add_argument("--num_points", type=int, default=212)
    ap.add_argument("--regularization_weight", type=float, default=1e-2)
    ap.add_argument("--max_iterations", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Y = make_ellipse_data(args.num_points)
    S = args.num_segments

    # Control points initialized on the unit circle.
    w = np.linspace(0.0, 2.0 * np.pi, S, endpoint=False)
    X0 = np.c_[np.cos(w), np.sin(w)].reshape(-1)

    # Preimage init: index of the closest control point.
    Xc = X0.reshape(S, 2)
    t0 = np.argmin(((Xc[None, :, :] - Y[:, None, :]) ** 2).sum(-1), axis=1).astype(np.float64)

    p = ctt.Problem()
    xb = p.add_parameter_block(X0)
    tb = [p.add_parameter_block(np.array([ti])) for ti in t0]

    def point_residual(X_flat, t, y):
        return contour_point(X_flat, t, S) - y

    for i in range(Y.shape[0]):
        p.add_residual_block(point_residual, None, [xb, tb[i]], data=Y[i])

    # Regularization: consecutive control points attract
    # (EuclideanDistanceFunctor, ellipse_approximation.cc:349-363).
    sqrt_w = np.sqrt(args.regularization_weight)

    def regularizer(X_flat):
        X = X_flat.reshape(S, 2)
        return (sqrt_w * (X - torch.roll(X, -1, dims=0))).reshape(-1)

    p.add_residual_block(regularizer, None, [xb])

    # Like the reference: solve the same problem twice, without and with
    # dynamic_sparsity (the second solve polishes the first's solution).
    for dynamic in (False, True):
        opts = ctt.SolverOptions(
            linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            dynamic_sparsity=dynamic,
            max_num_iterations=args.max_iterations,
        )
        summary = ctt.solve(opts, p, device=args.device)
        print("#" * 20)
        print(f"dynamic_sparsity = {dynamic}")
        print("#" * 20)
        print(summary.brief_report())
        assert summary.is_solution_usable()


if __name__ == "__main__":
    main()
