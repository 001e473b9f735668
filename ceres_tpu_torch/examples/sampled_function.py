"""Optimize over an interpolated sampled function — analog of
examples/sampled_function/sampled_function.cc (CubicInterpolator in a
cost function)."""

import argparse

import numpy as np

import ceres_tpu_torch as ctt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # f(x) = (x - 4.5)^2 sampled at integers (sampled_function.cc:49-55).
    xs = np.arange(10.0)
    values = (xs - 4.5) ** 2
    interp = ctt.CubicInterpolator(ctt.Grid1D(values))

    def residual(x):
        f, _ = interp.evaluate(x[0:1])
        return f.reshape(-1)

    p = ctt.Problem()
    xb = p.add_parameter_block(np.array([1.0]))
    p.add_residual_block(residual, None, [xb])
    summary = ctt.solve(
        ctt.SolverOptions(max_num_iterations=20, minimizer_progress_to_stdout=True),
        p,
        device=args.device,
    )
    print(summary.brief_report())
    print(f"x: 1.0 -> {p.parameter_block_value(xb)[0]:.4f} (expected 4.5)")


if __name__ == "__main__":
    main()
