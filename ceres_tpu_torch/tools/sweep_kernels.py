"""Sweep the launch parameters of the hand-written kernels on the card.

    python3 -m ceres_tpu_torch.tools.sweep_kernels [k1] [k3] [k4] [probes]

(no argument: the three kernels). One JSON line per cell on standard output, each
with the card's name and power limit and a ``table``:

- ``k1_threads``: the sorted segment sum (K1) at the point-side shapes of
  the two bundle-adjustment cases (large: 200 000 segments of 6 rows;
  flagship: 22 106 segments of 3 or 4 rows; d = 3 and 9; f32 and f64) at
  every block size, beside ``index_add_``. ``ops/segment_sum.THREADS`` is
  set from it;
- ``k1_length``: K1 on 1.2 M rows cut into uniform segments of L rows, for
  growing L (d = 3, 9), beside ``index_add_``: what longer segments cost a
  kernel that gives each output element one thread;
- ``k1_outlier``: K1 at the large shape with one more segment of N rows, for
  growing N: what a lone long segment costs it;
- ``k3_parts``: the unsorted segment sum (K3) at the large case's
  camera-side shapes (B = 1.2 M rows, G = 464; d = 81 and 9; f32 and f64), on
  the case's own camera ids (observations sorted by point) and on uniform
  random ids: the whole call, its gather kernel alone, its sum-of-pieces
  kernel alone, a pass that only streams the same bytes in order with
  16-byte loads, ``index_add_``, the bound and the scratch bytes;
- ``k3_warps``: K3 at the same shapes with the segments cut into no more
  than SMs x n pieces (one warp each), for growing n;
  ``ops/unsorted_segment_sum.WARPS_PER_SM`` is set from it;
- ``k3_cap``: K3 at its module defaults against ``index_add_`` for growing G
  (d = 3, 9 and 81; f32 and f64), which is what
  ``ops/reduce.UNSORTED_MAX_GROUPS`` is held against;
- ``k4``: the fused pair-outer segment sum (K4) on the large case's own
  strict-lower pair lists (3.0 M pairs, 107 416 cells, K = 3, 9 x 9; random
  slabs; f32 and f64): the compile-time form at every (threads, pairs per
  staging buffer), and the run-time form at the same shape.
  ``ops/outer_segment_sum.THREADS`` and ``STAGE_PAIRS`` are set from it;
- ``probes``: not a kernel: the CLUSTER_JACOBI blocks of the large case's
  implicit S (464 cameras in canonical-views clusters, 4176 probes S e_i at
  the start, f32 and f64) for growing probe chunks, synchronized seconds and
  peak memory, each against the first chunk size's blocks.
  ``linear/schur.PROBE_CHUNK_BYTES`` is set from it.

The kernels' times are of the call replayed from a CUDA graph (the host's
enqueue left out). Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import segment_sum as ss
from ceres_tpu_torch.ops import unsorted_segment_sum as us

B = 1_200_000
PEAK_BYTES_PER_S = 3.35e12  # the card's published device memory rate
K3_WARPS_PER_SM = (16, 24, 32, 36, 40, 44, 48, 52, 64, 96)
CAP_GROUPS = (511, 1023, 2047, 4095, 8191, 16383)
K1_THREADS = (64, 128, 256, 512, 1024)
K1_LENGTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096)
K1_OUTLIERS = (0, 256, 1024, 4096, 16384, 65536)
K4_THREADS = (128, 256, 512)
K4_STAGES = (3, 6, 9, 12, 15, 18)


def _graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``launches`` calls captured into one CUDA
    graph, the graph replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def _name(dtype) -> str:
    return str(dtype).split(".")[1]


def _row_ptr(counts, dev):
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.from_numpy(row_ptr).to(dev), int(row_ptr[-1])


def _k1_ms(c, row_ptr, G) -> float:
    return _graph_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G))


def _index_add_ms(c, row_ptr, G) -> float:
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(G + 1, device=c.device), counts)
    shape = (G + 1, c.shape[1])
    return _graph_ms(
        lambda: torch.zeros(shape, dtype=c.dtype, device=c.device).index_add_(0, seg, c)
    )


def sweep_k1(dev, emit) -> None:
    ss.build_kernel()
    rng = np.random.default_rng(0)
    default = ss.THREADS
    shapes = {
        "large": np.r_[np.full(200_000, 6), 0],
        "flagship": np.r_[rng.permutation(np.r_[np.full(17400, 4), np.full(4706, 3)]), 0],
    }
    for case, counts in shapes.items():
        row_ptr, rows = _row_ptr(counts, dev)
        G = counts.size - 1
        for dtype in (torch.float32, torch.float64):
            for d in (3, 9):
                c = torch.randn((rows, d), dtype=dtype, device=dev)
                lib = _index_add_ms(c, row_ptr, G)
                for threads in K1_THREADS:
                    ss.THREADS = threads
                    emit(table="k1_threads", case=case, rows=rows, G=G, d=d,
                         dtype=_name(dtype), threads=threads, index_add_ms=lib,
                         ms=_k1_ms(c, row_ptr, G))
                ss.THREADS = default
    for L in K1_LENGTHS:
        G = B // L
        row_ptr, rows = _row_ptr(np.r_[np.full(G, L), 0], dev)
        for d in (3, 9):
            c = torch.randn((rows, d), dtype=torch.float32, device=dev)
            emit(table="k1_length", rows=rows, G=G, L=L, d=d, dtype="float32",
                 ms=_k1_ms(c, row_ptr, G), index_add_ms=_index_add_ms(c, row_ptr, G))
            del c
    for n in K1_OUTLIERS:
        counts = np.r_[np.full(100_000, 6), n, np.full(100_000, 6), 0]
        row_ptr, rows = _row_ptr(counts, dev)
        G = counts.size - 1
        for d in (3, 9):
            c = torch.randn((rows, d), dtype=torch.float32, device=dev)
            emit(table="k1_outlier", rows=rows, G=G, outlier_rows=n, d=d,
                 dtype="float32", ms=_k1_ms(c, row_ptr, G),
                 index_add_ms=_index_add_ms(c, row_ptr, G))


def sweep_k3(dev, emit) -> None:
    from ceres_tpu_torch.models import bal

    us.build_kernel()
    rng = np.random.default_rng(0)
    G = 464
    inst = bal.synthesize_bal(
        num_cameras=G, num_points=200_000, num_observations=B,
        noise=2.0, perturb=0.7, seed=7,
    )
    # observations lie sorted by point, as models/bal.build_problem lays them
    camera_ids = inst.camera_index[np.argsort(inst.point_index, kind="stable")]
    id_sets = {"camera": camera_ids, "random": rng.integers(0, G, B)}

    def index_add_ms(c, seg64, groups):
        shape = (groups + 1, c.shape[1])
        return _graph_ms(
            lambda: torch.zeros(shape, dtype=c.dtype, device=dev).index_add_(0, seg64, c)
        )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def stream_ms(c):
        """The streaming yardstick over the bytes of ``c`` (16-byte loads)."""
        lib, sink = us._library(), torch.empty(4, device=dev)
        num_bytes = c.numel() * c.element_size() // 16 * 16

        def run():
            err = lib.unsorted_segment_sum_stream(
                c.data_ptr(), num_bytes, sink.data_ptr(), 4 * sms, 512,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"stream yardstick failed: cudaError {err}")

        return _graph_ms(run)

    shapes = [(dtype, d) for dtype in (torch.float32, torch.float64) for d in (81, 9)]
    for dtype, d in shapes:
        c = torch.randn((B, d), dtype=dtype, device=dev)
        e = c.element_size()
        common = dict(dtype=_name(dtype), d=d, G=G, B=B)
        for ids_name, ids in id_sets.items():
            plan = us.build_unsorted_plan(ids, G, dev)
            partial = torch.empty((plan.num_pieces, d), dtype=dtype, device=dev)
            out = torch.empty((G + 1, d), dtype=dtype, device=dev)
            emit(table="k3_parts", **common, ids=ids_name, pieces=plan.num_pieces,
                 bound_ms=(B * d * e + B * 4 + (G + 1) * d * e) / PEAK_BYTES_PER_S * 1e3,
                 scratch_bytes=plan.num_pieces * d * e,
                 ms=_graph_ms(lambda: us.segment_sum_unsorted(c, plan)),
                 gather_ms=_graph_ms(lambda: us._launch(c, plan, partial, out, 1)),
                 sum_pieces_ms=_graph_ms(lambda: us._launch(c, plan, partial, out, 2)),
                 stream_ms=stream_ms(c),
                 index_add_ms=index_add_ms(c, torch.from_numpy(ids).to(dev).long(), G))
        for warps_per_sm in K3_WARPS_PER_SM:
            plan = us.build_unsorted_plan(camera_ids, G, dev, sms * warps_per_sm)
            emit(table="k3_warps", **common, ids="camera", warps_per_sm=warps_per_sm,
                 pieces=plan.num_pieces,
                 ms=_graph_ms(lambda: us.segment_sum_unsorted(c, plan)))
        del c
    for groups in CAP_GROUPS:
        ids = rng.integers(0, groups, B)
        plan = us.build_unsorted_plan(ids, groups, dev)
        seg64 = torch.from_numpy(ids).to(dev).long()
        for dtype in (torch.float32, torch.float64):
            for d in (3, 9, 81):
                c = torch.randn((B, d), dtype=dtype, device=dev)
                emit(table="k3_cap", dtype=_name(dtype), d=d, G=groups, B=B,
                     pieces=plan.num_pieces,
                     ms=_graph_ms(lambda: us.segment_sum_unsorted(c, plan)),
                     index_add_ms=index_add_ms(c, seg64, groups))
                del c


def sweep_k4(dev, emit) -> None:
    from ceres_tpu_torch.linear import schur as schur_mod
    from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
    from ceres_tpu_torch.models import bal

    osum.build_kernel()
    program = bal.build_problem(bal.synthesize_bal(
        num_cameras=464, num_points=200_000, num_observations=1_200_000,
        noise=2.0, perturb=0.7, seed=7,
    ))[0].program(dev)
    plan = build_explicit_plan(program, schur_mod.build_schur_structure(program))
    group = next(g for g in plan.corr if not g.self_pairs)
    slots = program.families[0].batch
    a, b, row_ptr, G = group.a_idx, group.b_idx, group.plan.row_ptr, group.num_cells
    defaults = (osum.THREADS, dict(osum.STAGE_PAIRS), osum.TILED_SHAPES)

    def run(W, Y):
        return _graph_ms(lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, 3, 9, 9), 5)

    for dtype in (torch.float32, torch.float64):
        W = torch.randn((slots + 1, 27), dtype=dtype, device=dev)
        Y = torch.randn((slots + 1, 27), dtype=dtype, device=dev)
        common = dict(table="k4", dtype=_name(dtype), pairs=int(a.shape[0]), cells=G)
        for threads in K4_THREADS:
            osum.THREADS = threads
            osum.TILED_SHAPES = frozenset()
            emit(**common, form="run_time", threads=threads, stage=None, ms=run(W, Y))
            osum.TILED_SHAPES = defaults[2]
            for stage in K4_STAGES:
                if 2 * stage * 54 * W.element_size() * (threads // 32) > 227 * 1024:
                    continue
                osum.STAGE_PAIRS = {4: stage, 8: stage}
                emit(**common, form="compile_time", threads=threads, stage=stage,
                     ms=run(W, Y))
        osum.THREADS, osum.STAGE_PAIRS, osum.TILED_SHAPES = (
            defaults[0], dict(defaults[1]), defaults[2]
        )
        del W, Y


def sweep_probes(dev, emit) -> None:
    """The cluster blocks of the large case's implicit S by chunk size."""
    import time

    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linear.schur import SchurOperator
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.problem import cast_program
    from ceres_tpu_torch.trust_region import _build_solve_aux, _lm_damping
    from ceres_tpu_torch.types import PreconditionerType

    inst = bal.synthesize_bal(num_cameras=464, num_points=200_000,
                              num_observations=1_200_000, noise=2.0, perturb=0.7, seed=7)
    for dtype in (torch.float32, torch.float64):
        program = bal.build_problem(inst)[0].program(dev)
        cast_program(program, dtype)
        opts = bal.default_options(iterative=True)
        opts.preconditioner_type = PreconditionerType.CLUSTER_JACOBI
        ss = _build_solve_aux(opts, program)["ss"]
        x = torch.from_numpy(program.initial_ambient()).to(dev, dtype)
        ctx = Evaluator(program).cost_gradient_jacobian(x).jacobian_context
        diag = torch.clamp(ctx.squared_column_norms(), 1e-6, 1e32)
        op = SchurOperator(ctx, _lm_damping(diag, torch.tensor(1e4, device=dev)), ss)
        groups = ss.cluster_groups
        first = None
        for chunk in (6, 24, 96):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            blocks = op.cluster_blocks(groups, chunk=chunk)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            first = blocks if first is None else first
            emit(table="probes", dtype=str(dtype).split(".")[-1], clusters=list(groups.shape),
                 probes=int((groups < program.num_tangent).sum()), chunk=chunk,
                 seconds=seconds,
                 peak_device_bytes=torch.cuda.max_memory_allocated(),
                 max_rel_diff=float((blocks - first).abs().max() / first.abs().max()))
        del program, ctx, op, blocks, first


def main(argv) -> int:
    sweeps = {"k1": sweep_k1, "k3": sweep_k3, "k4": sweep_k4, "probes": sweep_probes}
    chosen = argv or ["k1", "k3", "k4"]
    for name in chosen:
        if name not in sweeps:
            raise SystemExit(f"unknown sweep {name!r}; choose from {sorted(sweeps)}")
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_kernels needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def emit(**fields):
        print(json.dumps({**fields, "card": smi}), flush=True)

    for name in chosen:
        sweeps[name](dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
