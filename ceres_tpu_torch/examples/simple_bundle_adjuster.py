"""Minimal BAL bundle adjustment — analog of
examples/simple_bundle_adjuster.cc (the tutorial version of
bundle_adjuster.py: load file, Snavely residual, default solve)."""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bal_file", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.bal_file:
        prob = bal.load_bal_file(args.bal_file)
    else:
        prob = bal.synthesize_bal(16, 2000, 8000)

    problem, _, _ = bal.build_problem(prob)
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
        minimizer_progress_to_stdout=True,
    )
    summary = ctt.solve(options, problem, device=args.device)
    print(summary.full_report())


if __name__ == "__main__":
    main()
