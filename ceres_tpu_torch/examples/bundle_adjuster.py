"""Bundle adjustment on BAL problems — analog of examples/bundle_adjuster.cc.

Reads a BAL text file (or synthesizes an instance of the canonical
problem-16-22106 shape) and solves it with the configured trust-region /
linear-solver / preconditioner combination.

``--mesh N`` shards the solve over N ranks: run it under
``python -m torch.distributed.run --nproc-per-node N -m
ceres_tpu_torch.examples.bundle_adjuster --mesh N``, NCCL with one card per
rank (``--device cuda``), gloo on the CPU (``--device cpu``). Rank 0 alone
prints.
"""

import argparse
import contextlib
import os
import sys

import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal


def _join_ranks(n: int, device: str):
    """(this rank's device, its mesh, whether this call started the process
    group) for ``--mesh n`` under torch.distributed.run."""
    import torch.distributed as dist

    from ceres_tpu_torch.parallel import make_mesh

    started = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {n} runs on {n} ranks: start it with python -m "
                f"torch.distributed.run --nproc-per-node {n}"
            )
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        device, started = str(dev), True
    return device, make_mesh(n, device_type=torch.device(device).type), started


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
    device, mesh, started = args.device, None, False
    if args.mesh:
        device, mesh, started = _join_ranks(args.mesh, args.device)
    quiet = mesh is not None and torch.distributed.get_rank() != 0
    try:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(
                null if quiet else sys.stdout):
            _run(args, device, mesh)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run(args, device, mesh):
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
        mesh=mesh,
    )
    summary = ctt.solve(options, problem, device=device)
    print(summary.full_report())


if __name__ == "__main__":
    main()
