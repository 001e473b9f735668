"""Fit a circle to 2-D samples — analog of examples/circle_fit.cc
(radius parameterized as r = m^2; residual r^2 - |p - c|^2; optional
Cauchy robustification)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt


def residual(x, y, m, data):
    """circle_fit.cc:74-99: r*r - xp*xp - yp*yp with r = m^2."""
    r = m * m
    xp = data[0:1] - x
    yp = data[1:2] - y
    return r * r - xp * xp - yp * yp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robust_threshold", type=float, default=0.0)
    ap.add_argument("--num_points", type=int, default=200)
    ap.add_argument("--outliers", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    true_c = np.array([2.0, -1.0])
    true_r = 3.0
    theta = rng.uniform(0, 2 * np.pi, args.num_points)
    pts = true_c + true_r * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    pts += 0.05 * rng.standard_normal(pts.shape)
    pts[: args.outliers] += rng.uniform(-3, 3, (args.outliers, 2))  # outliers

    p = ctt.Problem()
    x = p.add_parameter_block(np.array([0.0]))
    y = p.add_parameter_block(np.array([0.0]))
    m = p.add_parameter_block(np.array([1.0]))

    loss = ctt.CauchyLoss(args.robust_threshold) if args.robust_threshold > 0 else None
    ids = np.zeros(args.num_points, dtype=np.int64)
    p.add_residual_blocks(
        residual,
        loss,
        [np.full_like(ids, x), np.full_like(ids, y), np.full_like(ids, m)],
        data=pts,
    )
    summary = ctt.solve(ctt.SolverOptions(max_num_iterations=100), p, device=args.device)
    print(summary.brief_report())
    cx = p.parameter_block_value(x)[0]
    cy = p.parameter_block_value(y)[0]
    r = p.parameter_block_value(m)[0] ** 2
    print(f"center ({cx:.4f}, {cy:.4f}) r {r:.4f}  (truth: (2, -1) r 3)")


if __name__ == "__main__":
    main()
