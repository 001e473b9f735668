"""Powell's singular function — analog of examples/powell.cc."""

import argparse
import math

import numpy as np

import ceres_tpu_torch as ctt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = ctt.Problem()
    x1 = p.add_parameter_block(np.array([3.0]))
    x2 = p.add_parameter_block(np.array([-1.0]))
    x3 = p.add_parameter_block(np.array([0.0]))
    x4 = p.add_parameter_block(np.array([1.0]))

    p.add_residual_block(lambda a, b: a + 10.0 * b, None, [x1, x2])
    p.add_residual_block(lambda c, d: math.sqrt(5.0) * (c - d), None, [x3, x4])
    p.add_residual_block(lambda b, c: (b - 2.0 * c) ** 2, None, [x2, x3])
    p.add_residual_block(lambda a, d: math.sqrt(10.0) * (a - d) ** 2, None, [x1, x4])

    options = ctt.SolverOptions(
        max_num_iterations=100, minimizer_progress_to_stdout=True
    )
    summary = ctt.solve(options, p, device=args.device)
    print(summary.brief_report())
    print(
        "Final x1..x4:",
        [float(p.parameter_block_value(b)[0]) for b in (x1, x2, x3, x4)],
    )


if __name__ == "__main__":
    main()
