"""Sweep the launch parameters of the unsorted segment sum (K3) on the card.

    python3 -m ceres_tpu_torch.tools.sweep_kernels

Two tables, one JSON line per cell on standard output, each line with the
card's name and power limit:

- ``table``: K3 at the large bundle-adjustment case's camera-side shape
  (B = 1.2 M rows, G = 464, uniform random ids; d = 81, 9, 3; f32 and f64)
  for every (TABLE_BYTES, THREADS) pair, beside ``index_add_``;
- ``cap``: K3 at its module defaults against ``index_add_`` for growing G
  (d = 9 and 81, f32), which is what ``ops/reduce.UNSORTED_MAX_GROUPS`` is
  set from.

Times are CUDA-event means after a warm-up. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ceres_tpu_torch.ops import unsorted_segment_sum as us

B = 1_200_000
TABLE_BYTES = (32 * 1024, 48 * 1024, 64 * 1024, 100 * 1024, 160 * 1024, 227 * 1024)
THREADS = (256, 512, 1024)
CAP_GROUPS = (511, 1023, 2047, 4095, 8191, 16383)


def _time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_kernels needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def emit(**fields):
        print(json.dumps({**fields, "card": smi}), flush=True)

    def index_add_ms(c, seg64, G):
        d = c.shape[1]
        return _time_ms(
            lambda: torch.zeros((G + 1, d), dtype=c.dtype, device=dev).index_add_(0, seg64, c)
        )

    us.build_kernel()
    defaults = (us.TABLE_BYTES, us.THREADS)
    ids = torch.from_numpy(rng.integers(0, 464, B).astype(np.int32)).to(dev)
    seg64 = ids.to(torch.int64)
    for dtype in (torch.float32, torch.float64):
        for d in (81, 9, 3):
            c = torch.randn((B, d), dtype=dtype, device=dev)
            lib = index_add_ms(c, seg64, 464)
            for table in TABLE_BYTES:
                for threads in THREADS:
                    us.TABLE_BYTES, us.THREADS = table, threads
                    ms = _time_ms(lambda: us.segment_sum_unsorted(c, ids, 464))
                    emit(table="table", dtype=str(dtype), d=d, G=464, B=B,
                         table_bytes=table, threads=threads, ms=ms, index_add_ms=lib)
            del c
    us.TABLE_BYTES, us.THREADS = defaults
    for G in CAP_GROUPS:
        if G > us.max_num_groups(torch.float32):
            continue
        ids = torch.from_numpy(rng.integers(0, G, B).astype(np.int32)).to(dev)
        seg64 = ids.to(torch.int64)
        for d in (9, 81):
            c = torch.randn((B, d), dtype=torch.float32, device=dev)
            emit(table="cap", dtype="torch.float32", d=d, G=G, B=B,
                 table_bytes=us.TABLE_BYTES, threads=us.THREADS,
                 ms=_time_ms(lambda: us.segment_sum_unsorted(c, ids, G)),
                 index_add_ms=index_add_ms(c, seg64, G))
            del c
    return 0


if __name__ == "__main__":
    sys.exit(main())
