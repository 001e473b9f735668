"""The metric arithmetic on made-up records."""

import numpy as np
import pytest

from port_bench import yardstick
from port_bench.harness import Bench, Solve, solve_seconds
from port_bench.trace import Trace
from conftest import ROOT


def solve(iterations=5, linear=12, minimizer=0.02, reads=3):
    return Solve(iterations=iterations, linear_iterations=linear,
                 minimizer_s=minimizer, capture_s=0.0, final_cost=1.0,
                 termination="CONVERGENCE", usable=True, host_reads=reads)


def read(name, records):
    return Bench(ROOT).reader(name)(records)


def test_solve_seconds_spans_the_whole_window():
    # three solves end inside a 1 s window, the fourth after it: a stall
    # before the third counts, the straddler does not
    assert solve_seconds([0.2, 0.4, 0.9, 1.1], 1.0) == pytest.approx(0.9 / 3)
    assert solve_seconds([1.5], 1.0) is None


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert yardstick.busy_seconds(spans) == pytest.approx(30e-6)
    assert yardstick.idle_gaps(spans, 0, 50) == [(20, 30), (40, 50)]
    assert yardstick.busy_seconds([]) == 0.0


def test_breakdown_puts_gaps_down_to_the_innermost_host_event():
    t = Trace(device=[(0, 10, "k1"), (30, 40, "k2")],
              host=[(0, 50, "port_bench.solve"), (12, 28, "cudaGraphLaunch")],
              start_us=0, stop_us=50, window_s=50e-6)
    b = t.breakdown()
    assert b["device_ops"] == [["k1", pytest.approx(10e-6)], ["k2", pytest.approx(10e-6)]]
    assert dict(b["idle_gaps"]) == {"cudaGraphLaunch": pytest.approx(20e-6),
                                    "port_bench.solve": pytest.approx(10e-6)}


def test_k4_bytes_count_what_one_call_moves():
    # two points: one seen by cameras 0, 1, 2 (3 pairs), one by 0, 1 (1 pair)
    vis = yardstick.k4_visibility(np.array([0, 1, 2, 0, 1]), np.array([0, 0, 0, 1, 1]))
    assert vis == {"slots": 5, "pairs": 4, "cells": 3}
    num_bytes, flops = yardstick.k4_bytes(vis, 8)
    slabs = 2 * (5 + 1) * 27 * 8  # W and Y, their pad rows included
    assert num_bytes == slabs + 2 * 4 * 4 + (3 + 2) * 4 + (3 + 1) * 81 * 8
    assert flops == 2 * 4 * 3 * 81
    # Dubrovnik-356's visibility in float64: bound by bytes, about 0.18 ms
    vis = {"slots": 1255268, "pairs": 2875390, "cells": 63190}
    bound, by = yardstick.bound_seconds(*yardstick.k4_bytes(vis, 8), 8)
    assert by == "bytes" and 0.17e-3 < bound < 0.19e-3


def test_solve_counters():
    records = {"solves": [solve(5, 10, 0.05, 3), solve(7, 20, 0.09, 5)]}
    assert read("lm_iteration_ms", records) == pytest.approx(1e3 * 0.14 / 12)
    assert read("cg_iterations_per_solve", records) == pytest.approx(15.0)
    assert read("host_reads_per_solve", records) == pytest.approx(4.0)
    records["solves"][0].host_reads = None  # not counted in this run
    assert read("host_reads_per_solve", records) is None
    assert read("lm_iteration_ms", {"solves": []}) is None


def test_setup_readers():
    records = {"setup": {"preprocess_s": 1.5, "capture_s": 0.0}}
    assert read("preprocess_s", records) == 1.5
    assert read("capture_s", records) is None  # nothing captured: nothing read


def test_device_ms_per_iteration_is_the_traced_busy_union_less_the_starts():
    # traced: kernels busy 0-1 ms and 2-3 ms, the start's draw 4-5 ms (inside
    # its span's device range), over 10 LM iterations
    t = Trace(device=[(0, 1000, "k"), (500, 800, "k"), (2000, 3000, "k"), (4000, 5000, "randn")],
              host=[], start_us=0, stop_us=6000, window_s=6e-3,
              annotations=[(3900, 5100, "port_bench.start"), (0, 3500, "port_bench.solve")])
    records = {"trace": t, "traced": [solve(4), solve(6)]}
    assert read("device_ms_per_iteration", records) == pytest.approx(2.0 / 10)
    assert t.busy_s == pytest.approx(3e-3)  # the driver's busy_s keeps every operation
    assert read("device_ms_per_iteration", {**records, "trace": None}) is None
    assert read("device_ms_per_iteration", {**records, "traced": []}) is None


def test_k4_roofline_from_its_kernels_alone():
    class Scene:
        camera_index = np.array([0, 1, 2, 0, 1])
        point_index = np.array([0, 0, 0, 1, 1])

    bound, _ = yardstick.bound_seconds(*yardstick.k4_bytes(
        yardstick.k4_visibility(Scene.camera_index, Scene.point_index), 8), 8)
    name = "void (anonymous namespace)::tiled_kernel<double, 3, 9, 9>(double const*)"
    t = Trace(device=[(0, 2, name), (10, 14, name), (20, 90, "gemm")], host=[],
              start_us=0, stop_us=100, window_s=1e-4)
    records = {"trace": t, "scene": Scene, "element_bytes": 8}
    assert read("k4_roofline_pct", records) == pytest.approx(100 * bound / 3e-6)
    t.device = t.device[2:]
    assert read("k4_roofline_pct", records) is None  # no call traced: nothing, never 0
