"""Rosenbrock with a numerically differentiated gradient — analog of
examples/rosenbrock_numeric_diff.cc (central differences around f)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.rosenbrock import rosenbrock
from ceres_tpu_torch.numeric_diff import numeric_diff_gradient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # NumericDiffFirstOrderFunction analog: central differences supply
    # the gradient, the cost itself is evaluated exactly.
    problem = ctt.GradientProblem(
        rosenbrock,
        num_parameters=2,
        gradient_fn=numeric_diff_gradient(rosenbrock, method="CENTRAL"),
    )
    options = ctt.GradientProblemOptions(max_num_iterations=200)
    x = np.array([-1.2, 1.0])
    summary = ctt.solve_gradient_problem(options, problem, x, device=args.device)
    print(summary.brief_report())
    print("x:", x, "(truth: [1, 1])")


if __name__ == "__main__":
    main()
