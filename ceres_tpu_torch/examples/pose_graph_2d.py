"""2-D pose-graph SLAM — analog of examples/slam/pose_graph_2d/."""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import pose_graph as pg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="g2o file (SE2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    poses, constraints = pg.read_g2o_2d(args.input)
    print(f"poses {len(poses)}, constraints {len(constraints)}")
    problem, pid_of = pg.build_problem_2d(poses, constraints)
    summary = ctt.solve(pg.default_options(), problem, device=args.device)
    print(summary.brief_report())


if __name__ == "__main__":
    main()
