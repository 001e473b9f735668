"""Bicubic grid alignment with hand-written Jacobians — analog of
examples/bicubic_interpolation_analytic.cc: the cost uses the
interpolator's analytic derivative outputs (f, df/dr, df/dc) directly
via ``ctt.analytic_cost`` instead of differentiating through the spline.
"""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.bicubic_interpolation import grid_and_samples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    interp, true_shift, samples, values = grid_and_samples()

    def moved(shift, pts):
        return pts[:, 0] + shift[0:1], pts[:, 1] + shift[1:2]

    def residual(shift, pts, vals):
        return interp.evaluate(*moved(shift, pts))[0].reshape(-1) - vals

    def jacobian(shift, pts, vals):
        # AnalyticBiCubicCost::Evaluate: J row i = [df/dr, df/dc] at
        # point_i + shift — the interpolator's analytic derivatives.
        _, dfdr, dfdc = interp.evaluate(*moved(shift, pts))
        return torch.cat([dfdr, dfdc], dim=1), None, None  # data: NULL slots

    cost = ctt.analytic_cost(residual, jacobian)
    p = ctt.Problem()
    b = p.add_parameter_block(np.zeros(2))
    p.add_residual_block(
        lambda shift, data: cost(shift, *data), None, [b], data=(samples, values)
    )
    s = ctt.solve(ctt.SolverOptions(max_num_iterations=50), p, device=args.device)
    print(s.brief_report())
    print("shift:", p.parameter_block_value(b), "(truth:", true_shift, ")")


if __name__ == "__main__":
    main()
