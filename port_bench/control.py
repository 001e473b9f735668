"""The readings the check's limits are set from, on the card, in one process.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 --seconds 5 \
        [--dtypes float64,float32]

For every seed and dtype, one run of the cell (``harness.run_cell``, a
window of ``--seconds``): the program as its configuration states it
(float64) gives the lower readings, the control (``evaluation_dtype``
float32, the program's own lower-precision path) the upper ones. Each seed
also reads ``gn_decrease`` at the set-up's start, which is what a solve
that returned its state unchanged would read. One JSON line per reading on
standard output. The benchmark's own runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from port_bench.run import use_checkout_caches  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--dtypes", default="float64,float32")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    use_checkout_caches()

    import torch

    from port_bench import scene as scenes
    from port_bench.harness import MAX_SETUP_SOLVES, ROOT, Bench, run_cell
    from port_bench.reference import Reference

    if args.device == "cuda" and not torch.cuda.is_available():
        print("the control runs on a CUDA device; none is available", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.workload(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for dtype in args.dtypes.split(","):
            t0 = time.perf_counter()
            r = run_cell(bench, args.workload, seed, args.seconds, False, args.device, t0,
                         evaluation_dtype=dtype, log=lambda line: print(line, file=sys.stderr))
            print(json.dumps({"workload": args.workload, "seed": seed, "dtype": dtype,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "failed": r["failed"],
                              **{k: c["value"] for k, c in r["checks"].items()},
                              **{k: m["value"] for k, m in r["metrics"].items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
        sc = scenes.make_scene(config["num_cameras"], config["num_points"],
                               config["num_observations"], config["pixel_noise"],
                               config["scene_seed"], args.device)
        start = scenes.Starts(sc, traffic["points_sigma"], traffic["translation_sigma"], seed,
                              args.device, stream=scenes.Starts.SETUP,
                              batch=MAX_SETUP_SOLVES)[0]
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": "state_unchanged",
                          "gn_decrease": Reference(sc, args.device).gauss_newton_decrease(start)}),
              flush=True)
        del sc
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
