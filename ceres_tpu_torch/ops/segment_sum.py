"""Sorted segment sum (K1): the hand-written CUDA kernel and its plain version.

Port of ``ceres_tpu/ops/pallas_segment.py``'s ``sorted_segment_sum_blocked``
and ``sorted_segment_sum`` (one function, two TPU layouts): reduce (B, ...)
contributions whose segment ids are SORTED into (G+1, ...) group sums, row G
being the dummy group for ids outside [0, G). The kernel source and its
design note are in ``ceres_tpu_torch/csrc/sorted_segment_sum.cu``.

The plan is a CSR row pointer built on the host (:func:`build_row_ptr`).
The kernel gives every output element (g, c) one thread, which adds its
segment's rows one after another in their stored order: what the short
segments of bundle adjustment (3 to 6 rows each, d = 3 or 9) need, right for
every row pointer, every output row written once, the same bits on every
run. :func:`segment_sum_sorted` launches it for CUDA tensors and takes
:func:`segment_sum_sorted_plain` for CPU tensors; there is no other route.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from ceres_tpu_torch.ops import cuda_build
from ceres_tpu_torch.utils import cuda_graph

# Kernel launches made by segment_sum_sorted (a plain counter: a run can
# show that its main path went through the kernel; a launch captured into
# a CUDA graph counts once per replay that ran it, utils/cuda_graph.py).
launches = 0
# The same launches by the width d of the contributions.
launches_by_width: collections.Counter = collections.Counter()


def _credit(n: int, d: int) -> None:
    """Add n launches at width d (``utils.cuda_graph.launched``)."""
    global launches
    launches += n
    launches_by_width[d] += n


_SOURCE = "sorted_segment_sum.cu"
# Threads per block, from tools/sweep_kernels.py on an H100 80GB HBM3 at
# 700 W (float32, from a CUDA graph): 128 to 512 within 6% of each other at
# the point-side shapes of both bundle-adjustment cases.
THREADS = 256


def build_row_ptr(seg: np.ndarray, num_groups: int) -> np.ndarray:
    """(G+2,) int32 CSR row pointer of sorted ids: rows
    ``row_ptr[g]:row_ptr[g+1]`` hold segment g, ids outside [0, G) count
    as the dummy segment G. Raises when the mapped ids are not sorted."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    G = int(num_groups)
    seg = np.where((seg < 0) | (seg >= G), G, seg)
    if seg.size and np.any(seg[1:] < seg[:-1]):
        raise ValueError("segment ids must be sorted (dummy ids last)")
    if seg.size >= np.iinfo(np.int32).max:
        raise ValueError("too many rows for an int32 row pointer")
    return np.searchsorted(seg, np.arange(G + 2), side="left").astype(
        np.int32
    )


def segment_sum_sorted_plain(
    contrib: torch.Tensor, row_ptr: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into (G+1, d) zeros."""
    B = contrib.shape[0]
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    seg = torch.repeat_interleave(
        torch.arange(num_groups + 1, device=contrib.device), counts,
        output_size=B,
    )
    flat = contrib.reshape(B, math.prod(contrib.shape[1:]))
    out = torch.zeros(
        (num_groups + 1, flat.shape[1]), dtype=flat.dtype, device=flat.device
    )
    out.index_add_(0, seg, flat)
    return out.reshape((num_groups + 1,) + tuple(contrib.shape[1:]))


@functools.cache
def _library():
    """The loaded library with its argument types set (once per process)."""
    lib = cuda_build.load_library("sorted_segment_sum", [_SOURCE])
    for fn in (lib.sorted_segment_sum_f32, lib.sorted_segment_sum_f64):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _library()


def segment_sum_sorted(
    contrib: torch.Tensor, row_ptr: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """(B, ...) contributions with sorted ids -> (G+1, ...) segment sums.

    ``row_ptr`` is the (G+2,) int32 plan of :func:`build_row_ptr` on the
    contributions' device. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    G = int(num_groups)
    B = contrib.shape[0]
    if row_ptr.device != contrib.device:
        raise ValueError(
            f"plan on {row_ptr.device} but contributions on {contrib.device}"
        )
    if row_ptr.dtype != torch.int32 or row_ptr.shape != (G + 2,):
        raise ValueError(
            f"row_ptr must be int32 of shape ({G + 2},), got "
            f"{row_ptr.dtype} {tuple(row_ptr.shape)}"
        )
    if contrib.device.type == "cpu":
        return segment_sum_sorted_plain(contrib, row_ptr, G)
    if contrib.device.type != "cuda":
        raise ValueError(f"unsupported device {contrib.device}")
    if contrib.dtype == torch.float32:
        name = "sorted_segment_sum_f32"
    elif contrib.dtype == torch.float64:
        name = "sorted_segment_sum_f64"
    else:
        raise TypeError(f"unsupported dtype {contrib.dtype}")
    flat = contrib.reshape(B, math.prod(contrib.shape[1:])).contiguous()
    d = flat.shape[1]
    out = torch.empty((G + 1, d), dtype=flat.dtype, device=flat.device)
    if d == 0:
        return out.reshape((G + 1,) + tuple(contrib.shape[1:]))
    fn = getattr(_library(), name)
    stream = torch.cuda.current_stream(contrib.device).cuda_stream
    err = fn(
        flat.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), G + 1, d,
        THREADS, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    cuda_graph.launched(_credit, d)
    return out.reshape((G + 1,) + tuple(contrib.shape[1:]))
