"""Run one function on N ranks of a new process group, each rank a
process started with the ``spawn`` method (what a test or a one-card check
uses where ``torchrun`` would start the ranks).

The ranks meet through a ``file://`` store in a temporary directory (no
TCP port). Each calls ``fn(rank, world_size, *args)`` inside an initialised
process group and sends back what it returns. A rank's exception, or a run
past ``timeout`` seconds, ends every rank and raises here: nothing is
passed over.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

# The process group's timeout: a rank left waiting in a collective fails
# after this many seconds instead of hanging.
PG_TIMEOUT = 90.0


def _rank_main(fn, rank, world_size, init_method, backend, args, results):
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT),
        )
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # sent to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), backend: str = "gloo",
                timeout: float = 300.0) -> List[Any]:
    """``[fn(rank, world_size, *args) for each rank]``, each in its own
    process. ``fn`` and ``args`` must pickle (``fn`` a module-level function
    of a module the child can import)."""
    ctx = mp.get_context("spawn")
    procs = []
    try:
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "rendezvous")
            results = ctx.Queue()
            procs = [
                ctx.Process(target=_rank_main, args=(
                    fn, r, world_size, init, backend, tuple(args), results))
                for r in range(world_size)
            ]
            for p in procs:
                p.start()
            out = [None] * world_size
            deadline = time.monotonic() + timeout
            for _ in range(world_size):
                while True:
                    try:
                        rank, ok, value = results.get(timeout=0.5)
                        break
                    except queue.Empty:
                        dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                        if dead:
                            raise RuntimeError(f"a rank died with exit code {dead[0]}") from None
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"{world_size} ranks did not finish within {timeout} s"
                            ) from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with code {p.exitcode}")
            return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
