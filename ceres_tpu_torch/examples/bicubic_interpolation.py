"""Optimize over a bicubically-interpolated grid — analog of
examples/bicubic_interpolation.cc: recover a translation that aligns
noisy samples of f(x, y) = x*x - y*x + y*y against the interpolated
grid."""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


def grid_and_samples():
    """The interpolator of f on [-2, 12)^2 and 40 noisy samples of f at
    points moved by the true shift (the same draws as the reference)."""

    def f(r, c):
        return r * r - c * r + c * c

    rows, cols = np.meshgrid(np.arange(-2.0, 12.0), np.arange(-2.0, 12.0), indexing="ij")
    interp = ctt.BiCubicInterpolator(ctt.Grid2D(f(rows, cols), row_begin=-2, col_begin=-2))
    rng = np.random.default_rng(5)
    true_shift = np.array([1.3, -0.7])
    samples = rng.uniform(1.0, 7.0, (40, 2))
    values = f(samples[:, 0] + true_shift[0], samples[:, 1] + true_shift[1])
    values += 0.01 * rng.standard_normal(40)
    return interp, true_shift, samples, values


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    interp, true_shift, samples, values = grid_and_samples()

    def residual(shift, data):
        pts, vals = data
        pred = torch.func.vmap(
            lambda q: interp.evaluate(q[0:1] + shift[0:1], q[1:2] + shift[1:2])[0]
        )(pts)
        return pred.reshape(-1) - vals

    p = ctt.Problem()
    b = p.add_parameter_block(np.zeros(2))
    p.add_residual_block(residual, None, [b], data=(samples, values))
    s = ctt.solve(ctt.SolverOptions(max_num_iterations=50), p, device=args.device)
    print(s.brief_report())
    print("shift:", p.parameter_block_value(b), "(truth:", true_shift, ")")


if __name__ == "__main__":
    main()
