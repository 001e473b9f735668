"""Moré–Garbow–Hillstrom battery CLI — analog of
examples/more_garbow_hillstrom.cc.

Runs canonical unconstrained test functions ("Testing Unconstrained
Optimization Software", TOMS 7(1) 1981) from their standard starts with
either minimizer and reports the achieved vs certified minimum.

Usage:
    python -m ceres_tpu_torch.examples.more_garbow_hillstrom          # all
    python -m ceres_tpu_torch.examples.more_garbow_hillstrom --problem rosenbrock
    python -m ceres_tpu_torch.examples.more_garbow_hillstrom --minimizer line_search
"""

import argparse
import math

import numpy as np
import torch

import ceres_tpu_torch as ctt


def _rosenbrock():
    def f(x):
        return torch.cat([10.0 * (x[1:2] - x[0:1] ** 2), 1.0 - x[0:1]])

    return f, np.array([-1.2, 1.0]), 0.0


def _freudenstein_roth():
    def f(x):
        return torch.cat(
            [
                -13.0 + x[0:1] + ((5.0 - x[1:2]) * x[1:2] - 2.0) * x[1:2],
                -29.0 + x[0:1] + ((x[1:2] + 1.0) * x[1:2] - 14.0) * x[1:2],
            ]
        )

    return f, np.array([0.5, -2.0]), 0.5 * 48.9842


def _powell_badly_scaled():
    def f(x):
        return torch.cat(
            [
                1e4 * x[0:1] * x[1:2] - 1.0,
                torch.exp(-x[0:1]) + torch.exp(-x[1:2]) - 1.0001,
            ]
        )

    return f, np.array([0.0, 1.0]), 0.0


def _brown_badly_scaled():
    def f(x):
        return torch.cat([x[0:1] - 1e6, x[1:2] - 2e-6, x[0:1] * x[1:2] - 2.0])

    return f, np.array([1.0, 1.0]), 0.0


def _beale():
    def f(x):
        return torch.cat(
            [
                1.5 - x[0:1] * (1.0 - x[1:2]),
                2.25 - x[0:1] * (1.0 - x[1:2] ** 2),
                2.625 - x[0:1] * (1.0 - x[1:2] ** 3),
            ]
        )

    return f, np.array([1.0, 1.0]), 0.0


def _helical_valley():
    def f(x):
        theta = torch.atan2(x[1:2], x[0:1]) / (2.0 * math.pi)
        return torch.cat(
            [
                10.0 * (x[2:3] - 10.0 * theta),
                10.0 * (torch.sqrt(x[0:1] ** 2 + x[1:2] ** 2) - 1.0),
                x[2:3],
            ]
        )

    return f, np.array([-1.0, 0.0, 0.0]), 0.0


GAUSSIAN_Y = (0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521, 0.3989,
              0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044, 0.0009)


def _gaussian():
    # the data copied to the device once per device and dtype: a residual
    # that copies host data on every call cannot run inside a CUDA graph
    ys_on = {}

    def f(x):
        key = (x.device, x.dtype)
        if key not in ys_on:
            ys_on[key] = torch.tensor(GAUSSIAN_Y, dtype=x.dtype, device=x.device)
        ys = ys_on[key]
        t = (8.0 - torch.arange(1.0, 16.0, dtype=x.dtype, device=x.device)) / 2.0
        return x[0:1] * torch.exp(-x[1:2] * (t - x[2:3]) ** 2 / 2.0) - ys

    return f, np.array([0.4, 1.0, 0.0]), 0.5 * 1.12793e-8


def _box_3d():
    def f(x):
        t = torch.arange(1.0, 11.0, dtype=x.dtype, device=x.device) * 0.1
        return (
            torch.exp(-t * x[0:1])
            - torch.exp(-t * x[1:2])
            - x[2:3] * (torch.exp(-t) - torch.exp(-10.0 * t))
        )

    return f, np.array([0.0, 10.0, 20.0]), 0.0


def _wood():
    def f(x):
        return torch.cat(
            [
                10.0 * (x[1:2] - x[0:1] ** 2),
                1.0 - x[0:1],
                math.sqrt(90.0) * (x[3:4] - x[2:3] ** 2),
                1.0 - x[2:3],
                math.sqrt(10.0) * (x[1:2] + x[3:4] - 2.0),
                (x[1:2] - x[3:4]) / math.sqrt(10.0),
            ]
        )

    return f, np.array([-3.0, -1.0, -3.0, -1.0]), 0.0


PROBLEMS = {
    "rosenbrock": _rosenbrock,
    "freudenstein_roth": _freudenstein_roth,
    "powell_badly_scaled": _powell_badly_scaled,
    "brown_badly_scaled": _brown_badly_scaled,
    "beale": _beale,
    "helical_valley": _helical_valley,
    "gaussian": _gaussian,
    "box_3d": _box_3d,
    "wood": _wood,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=sorted(PROBLEMS), default=None)
    ap.add_argument(
        "--minimizer", choices=["trust_region", "line_search"], default="trust_region"
    )
    ap.add_argument("--max_iterations", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    names = [args.problem] if args.problem else sorted(PROBLEMS)
    wins = 0
    for name in names:
        fn, x0, cost_min = PROBLEMS[name]()
        p = ctt.Problem()
        b = p.add_parameter_block(x0.copy())
        p.add_residual_block(fn, None, [b])
        opts = ctt.SolverOptions(
            minimizer_type=(
                ctt.MinimizerType.TRUST_REGION
                if args.minimizer == "trust_region"
                else ctt.MinimizerType.LINE_SEARCH
            ),
            max_num_iterations=args.max_iterations,
        )
        s = ctt.solve(opts, p, device=args.device)
        ok = abs(s.final_cost - cost_min) < 1e-5 * max(1.0, abs(cost_min))
        wins += ok
        print(
            f"{name:22s} cost {s.final_cost: .6e} "
            f"(certified {cost_min: .6e}) "
            f"{'OK' if ok else 'MISS':4s} [{s.termination_type}]"
        )
    print(f"{wins}/{len(names)} at certified minimum")


if __name__ == "__main__":
    main()
