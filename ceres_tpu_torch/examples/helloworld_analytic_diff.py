"""Minimize 0.5 (10 - x)^2 with a hand-written analytic Jacobian — analog
of examples/helloworld_analytic_diff.cc (SizedCostFunction).

The hand-written derivative is attached through ``ctt.analytic_cost`` as
the forward-mode rule of the residual, so the solver's batched
``vmap(jacfwd)`` evaluation consumes it like any other residual.
"""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


def residual(x):
    return 10.0 - x


def jacobian(x):
    # dr/dx = -1 (helloworld_analytic_diff.cc:55-76: jacobians[0][0] = -1)
    return (torch.full((1, 1), -1.0, dtype=x.dtype, device=x.device),)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = ctt.Problem()
    x0 = 0.5
    xb = p.add_parameter_block(np.array([x0]))
    p.add_residual_block(ctt.analytic_cost(residual, jacobian), None, [xb])
    options = ctt.SolverOptions(minimizer_progress_to_stdout=True)
    summary = ctt.solve(options, p, device=args.device)
    print(summary.brief_report())
    print(f"x : {x0} -> {p.parameter_block_value(xb)[0]}")


if __name__ == "__main__":
    main()
