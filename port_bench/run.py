"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is the result (JSON: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last, each number compared beside its limit); the last lines of
standard error are the same numbers. Exits non-zero, with no result, without
a card (or fewer than the cell asks for), without the program beside it, or
when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def use_checkout_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout, set before
    torch is imported (the port's own nvcc and g++ builds go to
    ``ceres_tpu_torch/_build/``, also inside it)."""
    cache = ROOT / ".port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    use_checkout_caches()

    import torch

    from port_bench.harness import Bench, forbidden_modules, run_cell

    bench = Bench(ROOT)
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0, log=log)
    loaded = forbidden_modules()
    if loaded:
        log(f"JAX or the JAX package was loaded: {', '.join(loaded)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
