"""Fields-of-Experts image denoising — analog of examples/denoising.cc."""

import argparse

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import denoising as dn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="/root/reference/data/ceres_noisy.pgm")
    ap.add_argument("--foe_file", default="/root/reference/data/2x2.foe")
    ap.add_argument("--output", default="")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--num_iterations", type=int, default=100)
    ap.add_argument("--crop", type=int, default=0, help="use a crop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    img = dn.read_pgm(args.input)
    if args.crop:
        img = img[: args.crop, : args.crop]
    foe = dn.load_foe_file(args.foe_file)
    print(f"image {img.shape}, FoE {foe.size}x{foe.size} x{foe.num_filters}")

    problem, pix2d = dn.build_problem(img, foe, sigma=args.sigma)
    options = dn.default_options()
    options.max_num_iterations = args.num_iterations
    options.minimizer_progress_to_stdout = True
    summary = ctt.solve(options, problem, device=args.device)
    print(summary.brief_report())

    if args.output:
        out = dn.solution_image(problem, pix2d)
        dn.write_pgm(args.output, out)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
