"""Rosenbrock minimization with GradientProblem — analog of
examples/rosenbrock.cc (general unconstrained minimization path)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt


def rosenbrock(x):
    return ((1.0 - x[0:1]) ** 2 + 100.0 * (x[1:2] - x[0:1] ** 2) ** 2).sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    problem = ctt.GradientProblem(rosenbrock, num_parameters=2)
    options = ctt.GradientProblemOptions(max_num_iterations=200)
    x = np.array([-1.2, 1.0])
    summary = ctt.solve_gradient_problem(options, problem, x, device=args.device)
    print(summary.brief_report())
    print("x:", x, "(truth: [1, 1])")


if __name__ == "__main__":
    main()
