"""NIST StRD benchmark — analog of examples/nist.cc.

Prints the per-problem LRE table and the summary score (Ceres reference:
average LRE 9.4, 41/54 wins — nist.cc:67-72).
"""

import argparse

from ceres_tpu_torch.models import nist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nist_data_dir", default="/root/reference/data/nist")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--num_iterations", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    options = nist.default_options()
    options.max_num_iterations = args.num_iterations
    results = nist.run_suite(
        data_dir=args.nist_data_dir,
        options=options,
        names=args.names,
        verbose=True,
        device=args.device,
    )
    if not results:
        print("no problems matched")


if __name__ == "__main__":
    main()
