"""Which operations of the linear solvers a CUDA graph captures, one at a
time, each in a process of its own (a failed capture can leave the context
unusable). Every operation runs once eagerly, then is captured five ways:
alone in ``torch.cuda.graph`` (``plain``), inside a conditional IF body
(``utils/cuda_graph.run_if`` in a ``CapturedGraph``, as the fused loop
captures its LM iteration: ``in_if_body``), inside a WHILE body in such an
IF body (``in_while_body``), inside an IF body in that WHILE body (as
``linear/cg.py`` captures a CG iteration: ``in_cg_iteration``), and ten
times in ten such IF bodies (a CG block: ``in_cg_block``); each graph is
replayed and held to the eager result. One JSON line per operation and
way: its name, ``captured`` and the error. On the card only:

    CUDA_LAUNCH_BLOCKING=1 python3 -m ceres_tpu_torch.tools.capture_ops [names]

The operations: the SUBSET preconditioner's assembly and solve as they were
written before they were made capturable (``index_put_`` with
``accumulate=True`` into J'J, a single-matrix ``torch.cholesky_solve``) and
as they are now (``ops/segment_sum.py``'s K1 over a fixed cell order, then
``index_copy_``; two triangular solves), and the batched
``torch.cholesky_solve`` that ``ops/small_linalg.spd_inverse`` replaced;
then the library calls of the inner iterations and DOGLEG's subspace step:
``torch.linalg.solve_ex`` of a batch of (T, T) systems at the large case's
point and camera sets (200 000 of 3 x 3, 464 of 9 x 9) and
``torch.linalg.qr`` of an (n, 2) basis at its tangent size, in float32 and
float64. Each line also says whether the eager call waits for the device
(``syncs``: it raised under ``torch.cuda.set_sync_debug_mode("error")``).

``--collectives`` probes the mesh's collectives the same way, in a process
group of one NCCL rank per process (one card): ``dist.all_reduce`` and
``dist.broadcast`` as ``parallel/sharding.MeshComm`` issues them (on one
rank NCCL adds no device work for them, so also an averaging all-reduce,
for which it launches a kernel, and an all-gather, a copy), captured
``plain``, ``in_if_body``, ``in_while_body`` and ``in_cg_iteration``
(three collectives in one IF body inside a WHILE body, as a CG iteration
of the distributed Schur solvers makes them). Each graph is replayed twice
with an eager collective on the same communicator between the replays and
held to the eager result; the line also gives the nodes the collective
added to the graph it was captured into, by type (read through libcuda
while the stream captures), and the torch and NCCL versions::

    python3 -m ceres_tpu_torch.tools.capture_ops --collectives
"""

from __future__ import annotations

import collections
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

# J'J's sizes: the 60-pose graph's (on which the fused loop's capture of
# PR 13's SUBSET path fails) and a larger one
SIZES = (354, 600)
B = 2000  # instances
T = 3  # their block size


def _inputs(device, N):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N, (B, T))).to(device)
    contrib = torch.from_numpy(rng.standard_normal((B, T, T))).to(device)
    a = rng.standard_normal((N, N))
    H = torch.from_numpy(a @ a.T + N * np.eye(N)).to(device)
    L = torch.linalg.cholesky(H)
    v = torch.from_numpy(rng.standard_normal(N)).to(device)
    small = rng.standard_normal((512, 9, 9))
    Ls = torch.linalg.cholesky(torch.from_numpy(small @ small.transpose(0, 2, 1) + 9 * np.eye(9))
                               .to(device))
    return idx, contrib, H, L, v, Ls


def _operations(device, N):
    from ceres_tpu_torch.ops.segment_sum import build_row_ptr, segment_sum_sorted
    from ceres_tpu_torch.ops.small_linalg import cholesky_solve

    idx, contrib, H, L, v, Ls = _inputs(device, N)
    cells = (idx[:, :, None] * N + idx[:, None, :]).reshape(-1).cpu().numpy()
    perm = np.argsort(cells, kind="stable")
    unique, seg = np.unique(cells[perm], return_inverse=True)
    perm_d = torch.from_numpy(perm).to(device)
    row_ptr = torch.from_numpy(build_row_ptr(seg, unique.size)).to(device)
    unique_d = torch.from_numpy(unique).to(device)
    eye = torch.eye(9, dtype=Ls.dtype, device=device).expand(Ls.shape)
    rng = np.random.default_rng(1)
    systems = {}
    for T, batch in ((3, 200_000), (9, 464)):
        a = rng.standard_normal((batch, T, T))
        systems[T] = (torch.from_numpy(a @ a.transpose(0, 2, 1) + T * np.eye(T)).to(device),
                      torch.from_numpy(rng.standard_normal((batch, T, 1))).to(device))
    basis = torch.from_numpy(rng.standard_normal((604_176, 2))).to(device)

    def index_put_accumulate():
        out = torch.zeros((N, N), dtype=contrib.dtype, device=device)
        return out.index_put_((idx[:, :, None], idx[:, None, :]), contrib, accumulate=True)

    def k1_cells():
        sums = segment_sum_sorted(contrib.reshape(-1)[perm_d][:, None], row_ptr, unique.size)
        out = torch.zeros((N * N,), dtype=contrib.dtype, device=device)
        return out.index_copy_(0, unique_d, sums[: unique.size, 0]).reshape(N, N)

    return {
        "index_put_accumulate": index_put_accumulate,
        "k1_cells_index_copy": k1_cells,
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(H)[0],
        "cholesky_solve": lambda: torch.cholesky_solve(v[:, None], L),
        "two_triangular_solves": lambda: cholesky_solve(L, v[:, None]),
        "cholesky_solve_batched": lambda: torch.cholesky_solve(eye, Ls),
        "two_triangular_solves_batched": lambda: cholesky_solve(Ls, eye),
        "solve_ex_3x3": lambda: torch.linalg.solve_ex(*systems[3], check_errors=False)[0],
        "solve_ex_9x9": lambda: torch.linalg.solve_ex(*systems[9], check_errors=False)[0],
        "qr_two_columns_float64": lambda: torch.linalg.qr(basis)[0],
        "qr_two_columns_float32": lambda: torch.linalg.qr(basis.float())[0],
    }


def check(name: str, way: str, N: int) -> dict:
    from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, run_if, run_while

    device = torch.device("cuda", 0)
    op = _operations(device, N)[name]
    eager = op()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        op()
        syncs = False
    except RuntimeError:
        syncs = True
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    result = {}
    try:
        if way == "plain":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                result["out"] = op()
            graph.replay()
        else:
            out = torch.empty_like(eager)
            go = torch.ones((), dtype=torch.bool, device=device)
            trips = torch.zeros((), dtype=torch.int32, device=device)

            def trip():
                out.copy_(op())
                trips.add_(1)

            def cg_trip():  # a CG iteration: an IF body inside the WHILE body
                with run_if(go):
                    trip()

            def cg_block():  # a CG block: ten such IF bodies in one WHILE body
                for _ in range(10):
                    with run_if(go):
                        out.copy_(op())
                trips.add_(1)

            def body():
                with run_if(go):
                    if way == "in_if_body":
                        out.copy_(op())
                    else:  # a WHILE body inside the LM iteration's IF
                        trips.zero_()
                        run_while(lambda: trips < 1, {"in_while_body": trip,
                                                      "in_cg_iteration": cg_trip,
                                                      "in_cg_block": cg_block}[way])

            CapturedGraph(body, device).replay()
            result["out"] = out
        torch.cuda.synchronize()
    except Exception as e:  # the capture's failure is the finding
        return dict(operation=name, way=way, n=N, captured=False, syncs=syncs,
                    error=f"{type(e).__name__}: {e}"[:400])
    return dict(operation=name, way=way, n=N, captured=True, syncs=syncs,
                equal_to_eager=bool(torch.equal(result["out"], eager)))


NAMES = ["index_put_accumulate", "k1_cells_index_copy", "cholesky_ex", "cholesky_solve",
         "two_triangular_solves", "cholesky_solve_batched", "two_triangular_solves_batched",
         "solve_ex_3x3", "solve_ex_9x9", "qr_two_columns_float64", "qr_two_columns_float32"]


COLLECTIVES = ("all_reduce", "broadcast", "all_reduce_avg", "all_gather")
COLLECTIVE_WAYS = ("plain", "in_if_body", "in_while_body", "in_cg_iteration")
# CUgraphNodeType (cuda.h)
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child_graph", "empty", "wait_event",
               "event_record", "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc",
               "mem_free", "batch_mem_op", "conditional")


@functools.cache
def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    cu.cuStreamGetCaptureInfo_v2.argtypes = [p, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_ulonglong),
                                             ctypes.POINTER(p), ctypes.POINTER(p),
                                             ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.argtypes = [p, p, ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    for fn in (cu.cuStreamGetCaptureInfo_v2, cu.cuGraphGetNodes, cu.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    return cu


def _node_census() -> collections.Counter:
    """The nodes, by type, of the graph the current stream is capturing
    into (a conditional body's own graph inside a body)."""
    cu = _libcuda()
    status, cid = ctypes.c_int(), ctypes.c_ulonglong()
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    stream = torch.cuda.current_stream().cuda_stream
    err = cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), ctypes.byref(cid),
                                       ctypes.byref(graph), ctypes.byref(deps),
                                       ctypes.byref(ndeps))
    if err or status.value != 1:
        raise RuntimeError(f"cuStreamGetCaptureInfo: {err}, status {status.value}")
    n = ctypes.c_size_t(0)
    cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    out = collections.Counter()
    for node in nodes[: n.value]:
        t = ctypes.c_int()
        cu.cuGraphNodeGetType(node, ctypes.byref(t))
        out[_NODE_TYPES[t.value] if t.value < len(_NODE_TYPES) else str(t.value)] += 1
    return out


def check_collective(kind: str, way: str) -> dict:
    """One collective captured one way in a one-rank NCCL process group
    (see the module docstring)."""
    import torch.distributed as dist

    from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, run_if, run_while

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(d, "rv"),
                                rank=0, world_size=1)
        try:
            return _check_collective(kind, way, device, dist, CapturedGraph, run_if, run_while)
        finally:
            dist.destroy_process_group()


def _check_collective(kind, way, device, dist, CapturedGraph, run_if, run_while) -> dict:
    base = torch.arange(4176, dtype=torch.float64, device=device) * 0.5
    added = collections.Counter()

    def op():
        t = base.clone()
        before = _node_census() if torch.cuda.is_current_stream_capturing() else None
        if kind == "all_reduce":
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        elif kind == "all_reduce_avg":
            dist.all_reduce(t, op=dist.ReduceOp.AVG)
        elif kind == "all_gather":
            t = torch.empty_like(base)
            dist.all_gather_into_tensor(t, base)
        else:
            dist.broadcast(t, src=0)
        if before is not None:
            added.update(_node_census() - before)
        return t * 2.0

    eager = op()
    torch.cuda.synchronize()
    info = dict(collective=kind, way=way, torch=torch.__version__,
                nccl=".".join(map(str, torch.cuda.nccl.version())))
    try:
        out = torch.empty_like(eager)
        if way == "plain":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out.copy_(op())
            replay = graph.replay
        else:
            go = torch.ones((), dtype=torch.bool, device=device)
            trips = torch.zeros((), dtype=torch.int32, device=device)

            def trip():
                out.copy_(op())
                trips.add_(1)

            def cg_trip():  # three collectives in an IF body in the WHILE body
                with run_if(go):
                    a = op()
                    b = op()
                    out.copy_(op() + a - b)
                trips.add_(1)

            def body():
                with run_if(go):
                    if way == "in_if_body":
                        out.copy_(op())
                    else:
                        trips.zero_()
                        run_while(lambda: trips < 3,
                                  trip if way == "in_while_body" else cg_trip)

            replay = CapturedGraph(body, device).replay
        results = []
        for _ in range(2):
            out.zero_()
            replay()
            torch.cuda.synchronize()
            results.append(out.clone())
            between = op()  # an eager collective on the same communicator
            torch.cuda.synchronize()
    except Exception as e:  # the capture's failure is the finding
        return dict(info, captured=False, error=f"{type(e).__name__}: {e}"[:600])
    return dict(info, captured=True, nodes_added=dict(added),
                equal_to_eager=all(bool(torch.equal(r, eager)) for r in results)
                and bool(torch.equal(between, eager)))


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("capture_ops needs a CUDA device")
    if len(argv) == 4 and argv[0] == "--one":
        print(json.dumps(check(argv[1], argv[2], int(argv[3]))), flush=True)
        return 0
    if len(argv) == 3 and argv[0] == "--one-collective":
        print(json.dumps(check_collective(argv[1], argv[2])), flush=True)
        return 0
    if argv == ["--collectives"]:
        for kind in COLLECTIVES:
            for way in COLLECTIVE_WAYS:
                _one_process(["--one-collective", kind, way], dict(collective=kind, way=way))
        return 0
    for name in argv or NAMES:
        for N in SIZES:
            for way in ("plain", "in_if_body", "in_while_body", "in_cg_iteration",
                        "in_cg_block"):
                _one_process(["--one", name, way, str(N)], dict(operation=name, way=way, n=N))
    return 0


def _one_process(args, what: dict) -> None:
    """Run one check in a process of its own and print its JSON line."""
    run = subprocess.run([sys.executable, "-m", "ceres_tpu_torch.tools.capture_ops", *args],
                         capture_output=True, text=True, timeout=300)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    print(lines[-1] if lines else json.dumps(dict(
        what, captured=False, exit_code=run.returncode,
        error=run.stderr.strip().splitlines()[-3:] or [""])), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
