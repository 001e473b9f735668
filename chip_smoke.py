"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the last line):

1. device: requires CUDA, prints the card's name and power limit, and
   checks that float32 matmuls run in full float32 (no TF32);
2. build: compiles the three kernels with nvcc from ``ceres_tpu_torch/csrc``,
   one nvcc each, all at the same time: the sorted segment sum (K1), the
   unsorted segment sum (K3) and the fused pair-outer segment sum (K4);
3. kernel: each kernel against its plain PyTorch version on the card, at the
   shapes the solves below give it (f32 and f64) and at edge cases (K1:
   short segments, long ones and a mix; K3: its compile-time widths 9 and 81
   and run-time widths, every check launched twice and the two results held
   to the same bits; K4: K = 3, 9 x 9 through the compile-time form, other
   shapes through the run-time form), with its time, the plain
   version's, the one PyTorch call that computes the same function where
   there is one (``index_add_``), and its bound: the bytes it must move
   (inputs once, outputs once) over the card's 3.35 TB/s, or its operations
   over 67 TFLOP/s of plain float32 if that is more (CUDA events after a
   warm-up). ``ms`` is a call as the solve makes it, host enqueue included;
   ``device_ms`` is the same call replayed from a CUDA graph, which leaves
   the host out. K3's ``kernel_time`` lines also carry the times of its two
   kernels on their own (the gather, the sum of the pieces), the number of
   pieces and the bytes of its scratch. K4's ``kernel_time`` line also
   carries ``floor_ms``, a number modelled from the pair lists and not
   measured (so it stays out of the ``kernels`` line): the 32-byte sectors
   its row gathers touch, less those an L2 window of 25 MB of gathered
   traffic would still hold, plus lists and output, over the same memory
   rate;
4. solve, flagship: ``ceres_tpu_torch.fused_solve`` on the 16 cameras /
   22106 points / 83718 observations instance (seed 16, as bench.py builds
   it), ITERATIVE_SCHUR + SCHUR_JACOBI, in float32 and in float64, each after
   a warm-up solve and timed REPEATS times on fresh problems (every repeat
   must reach the same final cost). Both final costs must lie within 1e-3
   relative of the JAX reference's 202425.46 (BENCH_r05.json) and K1 must
   have been launched;
5. solve, large: the 464 cameras / 200 000 points / 1 200 000 observations
   instance (seed 7), DENSE_SCHUR (Cholesky of the 4176 x 4176 reduced
   camera system), in float32 and in float64, each after a 2-iteration
   warm-up solve and timed LARGE_REPEATS times on fresh problems (no kernel
   on this path adds with atomics, so every repeat must reach the same final
   cost to the bit). Both final costs must lie within 1e-3 relative of the
   JAX reference's 3587827.37 (BENCH_r05.json), and K1, K3 and K4 must each
   have been launched during the first timed solve.

``solve_seconds`` is the LM loop on the device; the host set-up of each
fresh problem is reported as ``setup_seconds``. Launch counters are set to
zero just before a timed solve and read just after it; K1's and K3's are
also reported by the width d of what they reduce (``launches_by_width``).

Before the last line: one ``{"kernels": [...]}`` line (per kernel: its times
at the large case's float32 shape and its launches in the large float32
solve) and the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.linear import schur as schur_mod
from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.ops import cuda_build
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import segment_sum as ss
from ceres_tpu_torch.ops import unsorted_segment_sum as us

NUM_CAMERAS, NUM_POINTS, NUM_OBS, SEED = 16, 22106, 83718, 16
LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7)
PERTURB, NOISE = 0.7, 2.0
REFERENCE_FINAL_COST = 202425.46  # ceres_tpu fused_solve, f32 (BENCH_r05.json)
LARGE_REFERENCE_FINAL_COST = 3587827.37  # the same, large case
COST_RTOL = 1e-3
# Timed flagship solves per dtype (each on a fresh problem); the first is
# the run whose K1 launches are counted.
REPEATS = 3
LARGE_REPEATS = 2  # the same for the large case
# Summation-order tolerance of a kernel against its plain version, relative
# to the sum of |contributions| in each segment (a reordered sum of n terms
# moves by at most ~n * eps of that).
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The card's published peaks: device memory rate and plain (non tensor
# core) float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SECTOR_BYTES = 32  # what a memory access moves at the least
# Gathered traffic an L2 of 50 MB is taken to still hold when a row is
# wanted again (half of it: lists, output and the other slab share it).
L2_WINDOW_BYTES = 25e6
KERNELS = {
    "sorted_segment_sum": (ss, "ceres_tpu/ops/pallas_segment.py:389"),
    "unsorted_segment_sum": (us, "ceres_tpu/ops/pallas_segment.py:224"),
    "outer_segment_sum": (osum, "ceres_tpu/ops/pallas_segment.py:504"),
}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the port compares in full f32")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")
    phase(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        allow_tf32=False, float32_matmul_precision="highest",
    )
    return smi


def build_kernels() -> None:
    t0 = time.perf_counter()
    cuda_build.build_in_parallel([mod.build_kernel for mod, _ in KERNELS.values()])
    for name in KERNELS:
        phase(
            "build", kernel=name, seconds=time.perf_counter() - t0,
            nvcc_seconds=cuda_build.build_seconds[name],
        )


def flagship_instance():
    return bal.synthesize_bal(
        num_cameras=NUM_CAMERAS, num_points=NUM_POINTS,
        num_observations=NUM_OBS, noise=NOISE, perturb=PERTURB, seed=SEED,
    )


def large_instance():
    return bal.synthesize_bal(noise=NOISE, perturb=PERTURB, **LARGE)


def _time_ms(fn, reps: int = 200) -> float:
    for _ in range(max(2, reps // 20)):
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


def _device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one call with the host's enqueue cost left out:
    ``launches`` calls are captured into one CUDA graph and the graph is
    replayed. Where this is far below ``_time_ms``, the wrapper's host work
    and not the kernel sets the time a caller sees."""
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


def _bound(num_bytes: float, flops: float):
    """(least ms the card could take, what sets it)."""
    by_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _within(out, ref, scale, dtype, label) -> float:
    """Hold a kernel's output to its plain version's; returns max |error|."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"kernel {label}: bad shape or non-finite output")
    err = (out - ref).abs()
    if (err > KERNEL_RTOL[dtype] * scale).any():
        raise RuntimeError(
            f"kernel {label}: max error {err.max().item():.3e} above "
            f"rtol {KERNEL_RTOL[dtype]:g} x sum|contrib|"
        )
    return err.max().item() if err.numel() else 0.0


def _record(name: str, max_err: float, **times) -> dict:
    mod, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda",
        "source": f"ceres_tpu_torch/csrc/{mod._SOURCE}",
        "replaces": replaces, "max_abs_err": max_err, **times,
    }


# ---- K1 ---------------------------------------------------------------------


def _compare_sorted(row_ptr, G, contrib, label) -> float:
    out = ss.segment_sum_sorted(contrib, row_ptr, G)
    ref = ss.segment_sum_sorted_plain(contrib, row_ptr, G)
    scale = ss.segment_sum_sorted_plain(contrib.abs(), row_ptr, G)
    return _within(out, ref, scale, contrib.dtype, label)


def _time_sorted(row_ptr, G, c, reps) -> dict:
    """K1's times at one shape: as called, the plain version, index_add_,
    the bound, and kernel and index_add_ from a CUDA graph."""
    B, d = c.shape
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(G + 1, device=c.device), counts)

    def library():
        torch.zeros((G + 1, d), dtype=c.dtype, device=c.device).index_add_(0, seg, c)

    e = c.element_size()
    bound_ms, bound_by = _bound(B * d * e + (G + 2) * 4 + (G + 1) * d * e, B * d)
    return dict(
        ms=_time_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G), reps),
        plain_ms=_time_ms(lambda: ss.segment_sum_sorted_plain(c, row_ptr, G), reps),
        library_ms=_time_ms(library, reps), bound_ms=bound_ms, bound_by=bound_by,
        device_ms=_device_ms(lambda: ss.segment_sum_sorted(c, row_ptr, G)),
        library_device_ms=_device_ms(library),
    )


def check_sorted(device, flagship_plan, large_plan) -> dict:
    """K1 vs plain at the point-side plans of both cases and at edge cases."""
    rng = np.random.default_rng(0)
    max_err, checks, record, shapes = 0.0, 0, None, []
    for case, plan, reps in (("flagship", flagship_plan, 200), ("large", large_plan, 50)):
        if plan.kind != "sorted":
            raise RuntimeError(f"{case} point plan is {plan.kind!r}, not 'sorted'")
        G = plan.num_groups
        B = int(plan.row_ptr[-1])
        for dtype in (torch.float32, torch.float64):
            for d in (3, 9):
                c = torch.tensor(rng.standard_normal((B, d)), dtype=dtype, device=device)
                err = _compare_sorted(plan.row_ptr, G, c, f"K1 {case} d={d} {dtype}")
                max_err, checks = max(max_err, err), checks + 1
                if dtype == torch.float32:
                    times = _time_sorted(plan.row_ptr, G, c, reps)
                    phase("kernel_time", kernel="sorted_segment_sum", case=case, B=B, G=G,
                          d=d, dtype="float32", **times)
                    shapes.append(dict(case=case, d=d, **times))
                    if case == "large" and d == 9:
                        record = times
    edge = {
        "B not a tile multiple, d=1": (np.sort(rng.integers(0, 5000, 83717)), 5000, 1),
        "empty segments, d=24": (np.sort(rng.integers(0, 40000, 7001)), 40000, 24),
        "segment of 6000 rows, d=81": (
            np.concatenate([np.full(6000, 7), np.sort(rng.integers(8, 900, 3000))]), 900, 81,
        ),
        "ids >= G to the dummy row, d=9": (np.sort(rng.integers(0, 1300, 20000)), 1000, 9),
        "G+1 = 289, d=3": (np.sort(rng.integers(0, 288, 9000)), 288, 3),
        # short segments, long ones, and a mix
        "short segments (4 rows each), d=3": (np.repeat(np.arange(30000), 4), 30000, 3),
        "long segments (3 of 7000 rows), d=9": (np.repeat(np.arange(3), 7000), 600, 9),
        "short segments and five of 800 rows, d=5": (
            np.sort(np.concatenate([np.repeat(np.arange(5), 800), rng.integers(5, 9000, 30000)])),
            9000, 5,
        ),
    }
    for label, (seg, g, d) in edge.items():
        row_ptr = torch.from_numpy(ss.build_row_ptr(seg, g)).to(device)
        for dtype in (torch.float32, torch.float64):
            c = torch.tensor(rng.standard_normal((seg.size, d)), dtype=dtype, device=device)
            err = _compare_sorted(row_ptr, g, c, f"K1 {label} {dtype}")
            max_err, checks = max(max_err, err), checks + 1
    phase("kernel", kernel="sorted_segment_sum", checks=checks, max_abs_err=max_err)
    return _record("sorted_segment_sum", max_err, timed_shapes=shapes, **record)


# ---- K3 ---------------------------------------------------------------------


def _compare_unsorted(plan, contrib, label) -> float:
    """K3 against its plain version, and against itself: the design promises
    the same bits on every launch."""
    out = us.segment_sum_unsorted(contrib, plan)
    ref = us.segment_sum_unsorted_plain(contrib, plan)
    scale = us.segment_sum_unsorted_plain(contrib.abs(), plan)
    err = _within(out, ref, scale, contrib.dtype, label)
    if not torch.equal(out, us.segment_sum_unsorted(contrib, plan)):
        raise RuntimeError(f"kernel {label}: two launches gave different bits")
    return err


def check_unsorted(device, camera_plan) -> dict:
    """K3 vs plain at the large case's camera-side plan (d = 81: F'F and
    self-pair cells; d = 9: gradient, column norms, rmatvec) and at edge
    cases."""
    if camera_plan.kind != "unsorted":
        raise RuntimeError(f"large camera plan is {camera_plan.kind!r}, not 'unsorted'")
    rng = np.random.default_rng(1)
    plan, G = camera_plan.unsorted, camera_plan.num_groups
    B = plan.num_rows
    seg64 = plan.segment_ids()
    max_err, checks, record = 0.0, 0, None
    for dtype in (torch.float32, torch.float64):
        for d in (81, 9):
            c = torch.tensor(rng.standard_normal((B, d)), dtype=dtype, device=device)
            err = _compare_unsorted(plan, c, f"K3 large d={d} {dtype}")
            max_err, checks = max(max_err, err), checks + 1

            def library():
                torch.zeros((G + 1, d), dtype=dtype, device=device).index_add_(0, seg64, c)

            e = c.element_size()
            bound_ms, by = _bound(B * d * e + B * 4 + (G + 1) * d * e, B * d)
            times = dict(
                ms=_time_ms(lambda: us.segment_sum_unsorted(c, plan), 30),
                plain_ms=_time_ms(lambda: us.segment_sum_unsorted_plain(c, plan), 30),
                library_ms=_time_ms(library, 30), bound_ms=bound_ms, bound_by=by,
                device_ms=_device_ms(lambda: us.segment_sum_unsorted(c, plan)),
                library_device_ms=_device_ms(library),
            )
            # The two kernels of the pair on their own, from a CUDA graph.
            partial = torch.empty((plan.num_pieces, d), dtype=dtype, device=device)
            out = torch.empty((G + 1, d), dtype=dtype, device=device)
            parts = dict(
                gather_device_ms=_device_ms(lambda: us._launch(c, plan, partial, out, 1)),
                sum_pieces_device_ms=_device_ms(lambda: us._launch(c, plan, partial, out, 2)),
                pieces=plan.num_pieces, scratch_bytes=partial.numel() * e,
            )
            phase("kernel_time", kernel="unsorted_segment_sum", case="large", B=B, G=G,
                  d=d, dtype=str(dtype).split(".")[1], **times, **parts)
            if dtype == torch.float32 and d == 81:
                record = times
            del c, partial, out
    # (ids, G, d); d = 9 and 81 take the compile-time form, the others the
    # run-time form (d = 40 and 100: more than one column group).
    edge = {
        "all rows in one group, d=9": (np.full(50000, 3), 464, 9),
        "ids >= G and < 0 to the dummy row, d=9": (rng.integers(-5, 700, 30000), 600, 9),
        "G+1 = 289, d=81": (rng.integers(0, 288, 20000), 288, 81),
        "G+1 = 4096, d=81": (rng.integers(0, 4095, 100000), 4095, 81),
        "65 535 groups, most of them empty, d=3": (rng.integers(0, 65535, 60000), 65535, 3),
        "B = 100003, d=1": (rng.integers(0, 464, 100003), 464, 1),
        "B = 7, d=40": (rng.integers(0, 464, 7), 464, 40),
        "B = 70001, d=100": (rng.integers(0, 464, 70001), 464, 100),
    }
    for label, (seg, g, d) in edge.items():
        plan_e = us.build_unsorted_plan(seg, g, device)
        for dtype in (torch.float32, torch.float64):
            c = torch.tensor(rng.standard_normal((seg.size, d)), dtype=dtype, device=device)
            max_err = max(max_err, _compare_unsorted(plan_e, c, f"K3 {label} {dtype}"))
            checks += 1
    phase("kernel", kernel="unsorted_segment_sum", checks=checks, max_abs_err=max_err)
    return _record("unsorted_segment_sum", max_err, **record)


# ---- K4 ---------------------------------------------------------------------


def _compare_outer(W, Y, a, b, row_ptr, G, K, T1, T2, label) -> float:
    out = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2)
    ref = osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, K, T1, T2)
    scale = osum.outer_segment_sum_plain(W.abs(), Y.abs(), a, b, row_ptr, G, K, T1, T2)
    return _within(out, ref, scale, W.dtype, label)


def _gathered_floor_bytes(a, b, row_bytes: int):
    """(bytes of the sectors K4's row gathers touch, the same less the rows
    an L2 window still holds). A pair gathers row ``a[p]`` of one slab and
    ``b[p]`` of the other, in the order of the list; a row wanted again
    within L2_WINDOW_BYTES of gathered traffic counts as served by L2."""
    pairs = a.shape[0]
    position = torch.arange(pairs, device=a.device)

    def sectors(rows):
        first = rows * row_bytes
        return (first + row_bytes - 1) // SECTOR_BYTES - first // SECTOR_BYTES + 1

    touched = [sectors(idx.long()) for idx in (a, b)]
    total = sum(int(t.sum()) for t in touched) * SECTOR_BYTES
    window_pairs = L2_WINDOW_BYTES / (total / max(pairs, 1))
    missed = 0
    for idx, sec in zip((a, b), touched):
        order = torch.argsort(idx.long() * pairs + position)  # by row, then position
        rows, pos = idx[order], position[order]
        again = (rows[1:] == rows[:-1]) & ((pos[1:] - pos[:-1]) <= window_pairs)
        miss = torch.ones(pairs, dtype=torch.bool, device=a.device)
        miss[1:] = ~again
        missed += int(sec[order][miss].sum())
    return total, missed * SECTOR_BYTES


def check_outer(device, group, num_slots: int) -> dict:
    """K4 vs plain at the large case's strict-lower pair group (the plan's
    own pair lists and row pointer, random slabs) and at edge cases."""
    if group.self_pairs or group.plan.kind != "sorted":
        raise RuntimeError("the large case's strict-lower pair group is not 'sorted'")
    rng = np.random.default_rng(2)
    K, T1, T2, G = 3, group.T1, group.T2, group.num_cells
    a, b, row_ptr = group.a_idx, group.b_idx, group.plan.row_ptr
    if a.dtype != torch.int32 or (K, T1, T2) not in osum.TILED_SHAPES:
        raise RuntimeError("the large case's pair group is not int32 lists at K=3, 9 x 9")
    Pp = a.shape[0]
    max_err, checks, record = 0.0, 0, None
    forms = {"compile_time": 0, "run_time": 0}
    for dtype in (torch.float32, torch.float64):
        W = torch.tensor(rng.standard_normal((num_slots + 1, K * T1)), dtype=dtype, device=device)
        Y = torch.tensor(rng.standard_normal((num_slots + 1, K * T2)), dtype=dtype, device=device)
        W[num_slots] = 0.0
        Y[num_slots] = 0.0
        err = _compare_outer(W, Y, a, b, row_ptr, G, K, T1, T2, f"K4 large {dtype}")
        max_err, checks = max(max_err, err), checks + 1
        forms["compile_time"] += 1
        e = W.element_size()
        other_bytes = 2 * Pp * 4 + (G + 2) * 4 + (G + 1) * T1 * T2 * e
        bound_ms, by = _bound(
            (W.numel() + Y.numel()) * e + other_bytes, 2.0 * Pp * K * T1 * T2,
        )
        gathered, missed = _gathered_floor_bytes(a, b, K * T1 * e)
        times = dict(
            ms=_time_ms(lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2), 20),
            plain_ms=_time_ms(
                lambda: osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, K, T1, T2), 10
            ),
            library_ms=None, bound_ms=bound_ms, bound_by=by,
            device_ms=_device_ms(
                lambda: osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2), 5
            ),
        )
        # Modelled from the pair lists, not measured: in this line only.
        modelled = dict(
            floor_ms=(missed + other_bytes) / PEAK_BYTES_PER_S * 1e3,
            gathered_bytes=gathered, gathered_bytes_missing_l2=missed,
        )
        phase("kernel_time", kernel="outer_segment_sum", case="large", pairs=Pp, cells=G,
              slots=num_slots, K=K, T1=T1, T2=T2, dtype=str(dtype).split(".")[1],
              **times, **modelled)
        if dtype == torch.float32:
            record = times
        del W, Y
    # Edge cases: (pairs' cell ids, cells, slots, K, T1, T2).
    long_cell = np.concatenate([np.full(5000, 2), np.sort(rng.integers(3, 50, 800))])
    edge = {
        "empty cells": (np.sort(rng.integers(0, 4000, 3000)) // 2 * 2, 4000, 900, 3, 9, 9),
        "one cell with 5000 pairs": (long_cell, 50, 3000, 3, 9, 9),
        "T1 != T2 (9 x 6)": (np.sort(rng.integers(0, 700, 20000)), 700, 5000, 3, 9, 6),
        "K=2, 12 x 12 (two passes of 128)": (np.sort(rng.integers(0, 300, 4000)), 300, 800, 2, 12, 12),
        "cells of 1 to 60 pairs (every staging tail)": (
            np.repeat(np.arange(600), np.arange(600) % 60 + 1), 600, 4000, 3, 9, 9,
        ),
        "no pairs": (np.zeros(0, np.int64), 10, 20, 3, 9, 9),
    }
    for label, (cells, g, n, k, t1, t2) in edge.items():
        rp = torch.from_numpy(ss.build_row_ptr(cells, g)).to(device)
        # about one pair row in eight is the pad row n (a zero row)
        ai = torch.from_numpy(osum.pair_rows_int32(
            np.where(rng.random(cells.size) < 0.125, n, rng.integers(0, n, cells.size))
        )).to(device)
        bi = torch.from_numpy(osum.pair_rows_int32(rng.integers(0, n + 1, cells.size))).to(device)
        form = "compile_time" if (k, t1, t2) in osum.TILED_SHAPES else "run_time"
        for dtype in (torch.float32, torch.float64):
            W = torch.tensor(rng.standard_normal((n + 1, k * t1)), dtype=dtype, device=device)
            Y = torch.tensor(rng.standard_normal((n + 1, k * t2)), dtype=dtype, device=device)
            W[n] = 0.0
            Y[n] = 0.0
            err = _compare_outer(W, Y, ai, bi, rp, g, k, t1, t2, f"K4 {label} {dtype}")
            max_err, checks = max(max_err, err), checks + 1
            forms[form] += 1
    if not all(forms.values()):
        raise RuntimeError(f"K4 checks do not reach both forms: {forms}")
    phase("kernel", kernel="outer_segment_sum", checks=checks, max_abs_err=max_err,
          checks_by_form=forms)
    return _record("outer_segment_sum", max_err, **record)


def check_kernels(device) -> list:
    """Every kernel against its plain version, on the plans the two cases
    build on this device. Returns the kernel records."""
    flagship = bal.build_problem(flagship_instance())[0].program(device)
    large = bal.build_problem(large_instance())[0].program(device)
    cam_plan, point_plan = large.families[0].reduce_plans
    records = [
        check_sorted(device, flagship.families[0].reduce_plans[1], point_plan),
        check_unsorted(device, cam_plan),
    ]
    structure = schur_mod.build_schur_structure(large)
    plan = build_explicit_plan(large, structure)
    kinds = {
        "ftf": [(s.perm is None, s.plan.kind) for s in plan.ftf],
        "corr": [(g.self_pairs, g.natural, g.plan.kind, g.num_cells, int(g.a_idx.shape[0]))
                 for g in plan.corr],
    }
    phase("plan", case="large", nf=plan.nf, **kinds)
    group = next(g for g in plan.corr if not g.self_pairs)
    records.append(check_outer(device, group, large.families[0].batch))
    return records


# ---- solves -----------------------------------------------------------------


def _reset_launches() -> None:
    for mod, _ in KERNELS.values():
        mod.launches = 0
    for mod in (ss, us):
        mod.launches_by_width.clear()


def _launches() -> dict:
    return {name: mod.launches for name, (mod, _) in KERNELS.items()}


def _launches_by_width() -> dict:
    """K1's and K3's launches by the width d of the contributions."""
    return {
        name: {f"d={d}": n for d, n in sorted(KERNELS[name][0].launches_by_width.items())}
        for name in ("sorted_segment_sum", "unsorted_segment_sum")
    }


def _options(dtype: str, iterative: bool, max_iters: int = 50):
    opts = bal.default_options(iterative=iterative)
    opts.max_num_iterations = max_iters
    if iterative:
        opts.function_tolerance = 1e-9
    opts.evaluation_dtype = dtype
    return opts


def _checked(problem, summary, reference: float, label: str) -> float:
    """The repo's own check of a solve: a finite solution of the expected
    shape whose cost agrees with the JAX package's. Returns the relative
    cost difference."""
    x = problem.state()
    rel = abs(summary.final_cost - reference) / reference
    if x.shape != (summary.num_parameters,) or not np.all(np.isfinite(x)):
        raise RuntimeError(f"{label}: bad or non-finite solution")
    if not np.isfinite(summary.final_cost) or rel > COST_RTOL:
        raise RuntimeError(
            f"{label}: final cost {summary.final_cost} not within "
            f"{COST_RTOL} of {reference}"
        )
    return rel


def solve_flagship(device, dtype: str) -> dict:
    """Warm-up solve, then REPEATS timed solves; returns the launches made
    by the first of them."""
    inst = flagship_instance()
    warm, _, _ = bal.build_problem(inst)
    ctt.fused_solve(_options(dtype, True, max_iters=2), warm, device=device)
    runs = []
    for i in range(REPEATS):
        problem, _, _ = bal.build_problem(inst)
        if i == 0:
            _reset_launches()
        runs.append(ctt.fused_solve(_options(dtype, True), problem, device=device))
        if i == 0:
            launches, by_width, first_problem = _launches(), _launches_by_width(), problem
        if runs[-1].final_cost != runs[0].final_cost:
            raise RuntimeError(f"{dtype} solve is not repeatable on the card")
    summary = runs[0]
    times = [s.minimizer_time_in_seconds for s in runs]
    rel = _checked(first_problem, summary, REFERENCE_FINAL_COST, f"flagship {dtype}")
    phase(
        "solve", case="flagship", dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost, reference_final_cost=REFERENCE_FINAL_COST,
        rel_err=rel, lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps,
        cg_iterations=summary.num_linear_solver_iterations,
        termination=str(summary.termination_type), solve_seconds=times[0],
        seconds_per_lm_iteration=times[0] / max(summary.num_iterations, 1),
        solve_seconds_all=times, solve_seconds_median=float(np.median(times)),
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width,
    )
    if launches["sorted_segment_sum"] == 0:
        raise RuntimeError(f"flagship {dtype}: K1 was never launched")
    return launches


def solve_large(device, dtype: str, inst) -> dict:
    """A 2-iteration warm-up solve on a fresh problem, then LARGE_REPEATS
    timed solves; returns the launches made by the first of them."""
    warm, _, _ = bal.build_problem(inst)
    ctt.fused_solve(_options(dtype, False, max_iters=2), warm, device=device)
    del warm
    runs = []
    for i in range(LARGE_REPEATS):
        problem, _, _ = bal.build_problem(inst)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
        runs.append(ctt.fused_solve(_options(dtype, False), problem, device=device))
        if i == 0:
            launches, by_width = _launches(), _launches_by_width()
            peak = torch.cuda.max_memory_allocated()
            rel = _checked(problem, runs[0], LARGE_REFERENCE_FINAL_COST, f"large {dtype}")
        if runs[-1].final_cost != runs[0].final_cost:
            raise RuntimeError(f"large {dtype} solve is not repeatable on the card")
        del problem
    summary = runs[0]
    seconds = summary.minimizer_time_in_seconds
    phase(
        "solve", case="large", dtype=dtype, initial_cost=summary.initial_cost,
        final_cost=summary.final_cost,
        reference_final_cost=LARGE_REFERENCE_FINAL_COST, rel_err=rel,
        lm_iterations=summary.num_iterations,
        successful_steps=summary.num_successful_steps,
        termination=str(summary.termination_type), solve_seconds=seconds,
        seconds_per_lm_iteration=seconds / max(summary.num_iterations, 1),
        solve_seconds_all=[s.minimizer_time_in_seconds for s in runs],
        setup_seconds=summary.preprocessor_time_in_seconds,
        setup_seconds_all=[s.preprocessor_time_in_seconds for s in runs],
        launches=launches, launches_by_width=by_width, peak_device_bytes=peak,
    )
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"large {dtype}: {name} was never launched")
    return launches, by_width


def main() -> int:
    smi = check_device()
    device = torch.device("cuda", 0)
    build_kernels()
    records = check_kernels(device)
    solve_flagship(device, "float32")
    solve_flagship(device, "float64")
    inst = large_instance()
    launches, by_width = solve_large(device, "float32", inst)
    solve_large(device, "float64", inst)
    for record in records:
        record["launches"] = launches[record["name"]]
        if record["name"] in by_width:
            record["launches_by_width"] = by_width[record["name"]]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
