"""The host-factor solvers through ``ctt.solve`` on one card: a sharded
sparse solve on a mesh of one NCCL rank (this process), and DOGLEG's
sparse Gauss-Newton solve in one process. For measuring them, and for
comparing two trees on one card in one call: the tool imports
``ceres_tpu_torch`` and ``chip_smoke`` of whichever tree comes first on the
path.

    PYTHONPATH=. python3 ceres_tpu_torch/tools/host_factor.py
    PYTHONPATH=<other tree> python3 ceres_tpu_torch/tools/host_factor.py

Cases (``chip_smoke``'s): on the mesh, the 2500-pose graph under
SPARSE_NORMAL_CHOLESKY, static and with ``dynamic_sparsity``, and the
sequential bundle adjustment under SPARSE_SCHUR; without a mesh, the
2500-pose graph under SPARSE_NORMAL_CHOLESKY and DOGLEG, without and with
``use_mixed_precision_solves``; all float64 (name cases as arguments to run
only those). Each
is solved three times from one start: ``ctt.solve`` (which captures the
host loop's regions where the tree does), again (a repeat on the kept
program), and ``profile_solve.eager_host_loop``. Prints the card's name
and power limit, then one JSON line per solve: whether it was captured,
LM iterations, seconds an LM iteration, host reads, the all-reduce and
broadcast calls and bytes (none without a mesh), the capture's seconds
(a first solve's include the builds of what the process uses first) and
the final cost.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

# case -> on the mesh
CASES = {"pose_graph_sparse_normal": True, "pose_graph_sparse_normal_dynamic": True,
         "sequential_sparse_schur": True, "pose_graph_sparse_normal_dogleg": False,
         "pose_graph_sparse_normal_dogleg_mixed": False}


def _problem(case: str):
    """(problem, options) of a case, from the tree's ``chip_smoke``."""
    import chip_smoke
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal, pose_graph

    if case == "sequential_sparse_schur":
        return (bal.build_problem(chip_smoke.sequential_instance())[0],
                chip_smoke._sequential_options("float64"))
    graph = pose_graph.synthesize_sphere(chip_smoke.POSE_GRAPH_POSES,
                                         seed=chip_smoke.POSE_GRAPH_SEED)[:3]
    opts = pose_graph.default_options()
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    opts.dynamic_sparsity = case.endswith("dynamic")
    if "dogleg" in case:
        opts.trust_region_strategy_type = ctt.TrustRegionStrategyType.DOGLEG
    opts.use_mixed_precision_solves = case.endswith("mixed")
    return pose_graph.build_problem_3d(*graph)[0], opts


def _solve(problem, opts, run: str) -> dict:
    """One solve of ``run`` ("solve", "again" or "eager"): its numbers."""
    import torch

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.tools.profile_solve import _host_reads, eager_host_loop

    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()):
        if run == "eager":
            (s, _), reads = _host_reads(lambda: eager_host_loop(problem, opts, "cuda"))
        else:
            s, reads = _host_reads(lambda: ctt.solve(opts, problem, device="cuda"))
    iters = max(s.num_iterations, 1)
    none = {"calls": 0, "bytes": 0}
    reduce, bcast = (none, none) if s.collectives is None else (
        s.collectives["all_reduce"], s.collectives["broadcast"])
    return dict(captured=s.captured_loop, lm_iterations=s.num_iterations,
                seconds_per_lm_iteration=s.minimizer_time_in_seconds / iters,
                host_reads=sum(reads.values()), host_reads_per_lm_iteration=sum(reads.values())
                / iters, all_reduce_calls=reduce["calls"], all_reduce_bytes=reduce["bytes"],
                broadcast_calls=bcast["calls"], broadcast_bytes=bcast["bytes"],
                capture_seconds=s.graph_capture_time_in_seconds, final_cost=s.final_cost)


def main() -> int:
    import torch
    import torch.distributed as dist

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("host_factor needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(tool="host_factor", package=os.path.dirname(ctt.__file__),
                          card=smi)), flush=True)
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, device_type="cuda")
            for case in sys.argv[1:] or CASES:
                problem, opts = _problem(case)
                opts.mesh = mesh if CASES[case] else None
                start = problem.state().copy()
                for run in ("solve", "again", "eager"):
                    problem.write_back(start)
                    print(json.dumps(dict(case=case, run=run, **_solve(problem, opts, run))),
                          flush=True)
                del problem
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
