"""Minimize 0.5 (10 - x)^2 — analog of examples/helloworld.cc.

    python -m ceres_tpu_torch.examples.helloworld [--device cpu]
"""

import argparse

import numpy as np

import ceres_tpu_torch as ctt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = ctt.Problem()
    x0 = 5.0
    xb = p.add_parameter_block(np.array([x0]))
    p.add_residual_block(lambda x: 10.0 - x, None, [xb])
    options = ctt.SolverOptions(minimizer_progress_to_stdout=True)
    summary = ctt.solve(options, p, device=args.device)
    print(summary.brief_report())
    print(f"x : {x0} -> {p.parameter_block_value(xb)[0]}")


if __name__ == "__main__":
    main()
