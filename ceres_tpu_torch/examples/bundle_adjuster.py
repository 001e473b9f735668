"""Bundle adjustment on BAL problems — analog of examples/bundle_adjuster.cc.

Reads a BAL text file (or synthesizes an instance of the canonical
problem-16-22106 shape) and solves it with the configured trust-region /
linear-solver / preconditioner combination.
"""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal

# What --mesh needs: a sharded solve (torch.distributed collectives).
_SHARDING = "a solve sharded over N devices (--mesh) is ROADMAP Queue 1 item 19"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="BAL problem file")
    ap.add_argument("--num_cameras", type=int, default=16)
    ap.add_argument("--num_points", type=int, default=22106)
    ap.add_argument("--num_observations", type=int, default=83718)
    ap.add_argument(
        "--linear_solver",
        default="ITERATIVE_SCHUR",
        choices=[t.name for t in ctt.LinearSolverType],
    )
    ap.add_argument(
        "--preconditioner",
        default="SCHUR_JACOBI",
        choices=[t.name for t in ctt.PreconditionerType],
    )
    ap.add_argument(
        "--trust_region_strategy",
        default="LEVENBERG_MARQUARDT",
        choices=[t.name for t in ctt.TrustRegionStrategyType],
    )
    ap.add_argument("--robustify", action="store_true")
    ap.add_argument("--inner_iterations", action="store_true")
    ap.add_argument("--num_iterations", type=int, default=50)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--mesh", type=int, default=0, help="shard over N devices")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(_SHARDING)

    if args.input:
        prob = bal.load_bal_file(args.input)
    else:
        prob = bal.synthesize_bal(args.num_cameras, args.num_points, args.num_observations)
    print(
        f"cameras {prob.num_cameras}, points {prob.num_points}, "
        f"observations {prob.num_observations}"
    )

    loss = ctt.HuberLoss(1.0) if args.robustify else None
    problem, _, _ = bal.build_problem(prob, loss=loss)

    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType[args.linear_solver],
        preconditioner_type=ctt.PreconditionerType[args.preconditioner],
        trust_region_strategy_type=ctt.TrustRegionStrategyType[args.trust_region_strategy],
        use_inner_iterations=args.inner_iterations,
        max_num_iterations=args.num_iterations,
        eta=args.eta,
        minimizer_progress_to_stdout=True,
    )
    summary = ctt.solve(options, problem, device=args.device)
    print(summary.full_report())


if __name__ == "__main__":
    main()
