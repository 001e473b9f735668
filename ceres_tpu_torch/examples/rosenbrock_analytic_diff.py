"""Rosenbrock with a hand-written analytic gradient — analog of
examples/rosenbrock_analytic_diff.cc (FirstOrderFunction::Evaluate
filling the gradient manually)."""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.rosenbrock import rosenbrock


def rosenbrock_gradient(x):
    # rosenbrock_analytic_diff.cc:46-52
    g0 = -2.0 * (1.0 - x[0:1]) - 400.0 * x[0:1] * (x[1:2] - x[0:1] ** 2)
    g1 = 200.0 * (x[1:2] - x[0:1] ** 2)
    return torch.cat([g0, g1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    problem = ctt.GradientProblem(
        rosenbrock, num_parameters=2, gradient_fn=rosenbrock_gradient
    )
    options = ctt.GradientProblemOptions(max_num_iterations=200)
    x = np.array([-1.2, 1.0])
    summary = ctt.solve_gradient_problem(options, problem, x, device=args.device)
    print(summary.brief_report())
    print("x:", x, "(truth: [1, 1])")


if __name__ == "__main__":
    main()
