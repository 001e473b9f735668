"""3-D pose-graph SLAM — analog of examples/slam/pose_graph_3d/.

With --input reads a g2o (SE3:QUAT) file; without, synthesizes a
sphere-style odometry + loop-closure graph.
"""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import pose_graph as pg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="g2o file (SE3:QUAT)")
    ap.add_argument("--num_poses", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.input:
        positions, quats, constraints = pg.read_g2o_3d(args.input)
    else:
        positions, quats, constraints, _ = pg.synthesize_sphere(args.num_poses)
    print(f"poses {len(positions)}, constraints {len(constraints)}")
    problem, pos_id, quat_id = pg.build_problem_3d(positions, quats, constraints)
    options = pg.default_options()
    options.minimizer_progress_to_stdout = True
    summary = ctt.solve(options, problem, device=args.device)
    print(summary.brief_report())


if __name__ == "__main__":
    main()
