"""The benchmark's own arithmetic: the card's peaks, the busy union of a
device trace, the host-read counter, and the bytes of K4's pair-cell
reduction. Copies, so that a change to the program cannot move the
yardstick:

- ``busy_seconds``: the union of the device operations' intervals, as
  ``ceres_tpu_torch/tools/profile_solve._device_profile`` sums it;
- ``HostReads``: the operations that waited for the card, as
  ``profile_solve._host_reads`` counts them (``torch.cuda.set_sync_debug_mode``);
- ``k4_bytes`` and ``bound_seconds``: ``chip_smoke.py`` ``check_outer``'s
  and ``_bound``'s count of what K4 must read and write once.
"""

from __future__ import annotations

import collections
import warnings

import numpy as np

# NVIDIA H100 80GB HBM3 (SXM), published: device memory rate and plain
# (non tensor core) float32 and float64 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def busy_seconds(spans) -> float:
    """Seconds covered by the union of ``spans``, (start, end) pairs in
    microseconds."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6


def idle_gaps(spans, start: float, stop: float):
    """The intervals of [start, stop] (microseconds) that no span covers,
    as (start, end) pairs in order."""
    gaps, at = [], start
    for a, b in sorted(spans):
        if a > at:
            gaps.append((at, min(a, stop)))
        at = max(at, b)
        if at >= stop:
            break
    if at < stop:
        gaps.append((at, stop))
    return [(a, b) for a, b in gaps if b > a]


class HostReads:
    """Counts, while entered, the operations that wait for the card (reads
    to the host, and copies from it, which wait too) by the warning
    ``torch.cuda.set_sync_debug_mode("warn")`` gives for each."""

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def take(self) -> int:
        """The reads since the last take (or the start)."""
        n = sum(1 for w in self._caught if "synchroniz" in str(w.message))
        self._caught.clear()
        return n

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)


def k4_visibility(camera_index: np.ndarray, point_index: np.ndarray) -> dict:
    """What K4 reduces for a bundle adjustment visibility: ``slots``, the
    camera observations (rows of each operand slab less its zero pad row);
    ``pairs``, the unordered pairs of observations of one point by two
    different cameras (the strict-lower correction pairs of the reduced
    camera system); ``cells``, the distinct camera pairs they fall into."""
    cam = np.asarray(camera_index, dtype=np.int64)
    pt = np.asarray(point_index, dtype=np.int64)
    order = np.argsort(pt, kind="stable")
    cam_s, pt_s = cam[order], pt[order]
    n = np.bincount(pt_s)
    first = np.concatenate([[0], np.cumsum(n)])
    group = n[pt_s]
    ia = np.repeat(np.arange(pt_s.size), group)
    ib = first[pt_s][ia] + (np.arange(ia.size) - np.repeat(np.cumsum(group) - group, group))
    a, b = cam_s[ia], cam_s[ib]
    lower = a > b
    C = int(cam.max()) + 1 if cam.size else 0
    cells = np.unique(a[lower] * C + b[lower]).size
    return {"slots": int(cam.size), "pairs": int(lower.sum()), "cells": int(cells)}


def k4_bytes(visibility: dict, element_bytes: int, K: int = 3, T1: int = 9, T2: int = 9):
    """(bytes, operations) K4 must move and compute in one call: both slabs
    (slots + 1 rows of K*T values) read once, the two int32 pair lists and
    the cells' int32 row pointer read once, the (cells + 1) T1 x T2 output
    written once; 2 K T1 T2 operations a pair."""
    slots, pairs, cells = visibility["slots"], visibility["pairs"], visibility["cells"]
    slabs = (slots + 1) * K * (T1 + T2) * element_bytes
    other = 2 * pairs * 4 + (cells + 2) * 4 + (cells + 1) * T1 * T2 * element_bytes
    return slabs + other, 2.0 * pairs * K * T1 * T2


def bound_seconds(num_bytes: float, flops: float, element_bytes: int):
    """(least seconds the card could take, what sets it)."""
    by_bytes = num_bytes / PEAK_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[element_bytes]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def top(pairs, n: int = 10):
    """The n largest totals of (name, seconds) pairs, summed by name."""
    total = collections.defaultdict(float)
    for name, seconds in pairs:
        total[name] += seconds
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
