"""Curve fitting with outliers + CauchyLoss — analog of
examples/robust_curve_fitting.cc (same dataset with corrupted points)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.curve_fitting import DATA as CLEAN, residual

# robust_curve_fitting.cc corrupts a copy of the data with outliers.
DATA = CLEAN.copy()
rng = np.random.default_rng(1234)
for i in rng.choice(len(DATA), 8, replace=False):
    DATA[i, 1] += rng.choice([-1, 1]) * rng.uniform(1.5, 4.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = ctt.Problem()
    mc = p.add_parameter_block(np.zeros(2))
    p.add_residual_block(
        residual, ctt.CauchyLoss(0.5), [mc], data=(DATA[:, 0], DATA[:, 1])
    )
    summary = ctt.solve(ctt.SolverOptions(max_num_iterations=50), p, device=args.device)
    print(summary.brief_report())
    m, c = p.parameter_block_value(mc)
    print(f"Final m: {m:.6f} c: {c:.6f} (truth: 0.3, 0.1, robust to outliers)")


if __name__ == "__main__":
    main()
