"""Bundle adjustment on libmv (Blender tracking) problems — analog of
examples/libmv_bundle_adjuster.cc."""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import libmv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--input", default="/root/reference/data/libmv-ba-problems/problem_01.bin"
    )
    ap.add_argument(
        "--refine_intrinsics",
        action="store_true",
        help="refine the shared camera intrinsics too",
    )
    ap.add_argument("--num_iterations", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    lp = libmv.load_libmv_file(args.input)
    print(
        f"cameras {lp.cameras_Rt.shape[0]}, points {lp.points.shape[0]}, "
        f"markers {lp.markers.shape[0]}, "
        f"space {'image' if lp.is_image_space else 'normalized'}"
    )
    problem, intr, cams, pts = libmv.build_problem(
        lp, refine_intrinsics=args.refine_intrinsics
    )
    options = libmv.default_options()
    options.max_num_iterations = args.num_iterations
    options.minimizer_progress_to_stdout = True
    summary = ctt.solve(options, problem, device=args.device)
    print(summary.brief_report())
    print("final intrinsics:", problem.parameter_block_value(intr))


if __name__ == "__main__":
    main()
