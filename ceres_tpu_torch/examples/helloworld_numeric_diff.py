"""Minimize 0.5 (10 - x)^2 with numeric differentiation — analog of
examples/helloworld_numeric_diff.cc (NumericDiffCostFunction)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = ctt.Problem()
    x0 = 0.5
    xb = p.add_parameter_block(np.array([x0]))
    cost = ctt.numeric_diff(lambda x: 10.0 - x, method="CENTRAL")
    p.add_residual_block(cost, None, [xb])
    options = ctt.SolverOptions(minimizer_progress_to_stdout=True)
    summary = ctt.solve(options, p, device=args.device)
    print(summary.brief_report())
    print(f"x : {x0} -> {p.parameter_block_value(xb)[0]}")


if __name__ == "__main__":
    main()
