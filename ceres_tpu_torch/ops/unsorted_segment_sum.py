"""Unsorted segment sum (K3): the hand-written CUDA kernel and its plain version.

Port of ``ceres_tpu/ops/pallas_segment.py``'s ``segment_sum_onehot_tiled``
(wrapper ``segment_sum_onehot``): reduce (B, ...) contributions whose
segment ids come in ANY order into (G+1, ...) group sums, row G being the
dummy group for ids outside [0, G). No sort and no row gather. The kernel
source and its design note are in
``ceres_tpu_torch/csrc/unsorted_segment_sum.cu``.

The plan is the (B,) int32 id array on the contributions' device.
:func:`segment_sum_unsorted` launches the kernel for CUDA tensors and takes
:func:`segment_sum_unsorted_plain` for CPU tensors; there is no other route.
The kernel adds with atomics: its sums are not bit-repeatable from run to
run (the same terms in another order).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ceres_tpu_torch.ops import cuda_build

# Kernel launches made by segment_sum_unsorted (a plain counter: a run can
# show that its main path went through the kernel).
launches = 0

_SOURCE = "unsorted_segment_sum.cu"

# Shared-memory budget of one CTA's (G+1, dc) table and threads per CTA.
# The kernel chunks the columns so that a table fits the budget; a smaller
# budget means more CTAs per SM and more column chunks. The whole 227 KB a
# block may opt into, with 1024 threads, was the fastest of 18 pairs in
# float32 at B = 1.2 M, G = 464, d = 81 and within 5% of the fastest at
# d = 9 (tools/sweep_kernels.py on an H100 80GB HBM3 at 700 W).
TABLE_BYTES = 227 * 1024
THREADS = 1024


def max_num_groups(dtype: torch.dtype) -> int:
    """Largest G whose one-column table still fits the budget."""
    return TABLE_BYTES // torch.empty((), dtype=dtype).element_size() - 1


def segment_sum_unsorted_plain(
    contrib: torch.Tensor, ids: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into (G+1, d) zeros."""
    G = int(num_groups)
    B = contrib.shape[0]
    seg = ids.to(torch.int64)
    seg = torch.where((seg < 0) | (seg >= G), G, seg)
    flat = contrib.reshape(B, math.prod(contrib.shape[1:]))
    out = torch.zeros((G + 1, flat.shape[1]), dtype=flat.dtype, device=flat.device)
    out.index_add_(0, seg, flat)
    return out.reshape((G + 1,) + tuple(contrib.shape[1:]))


@functools.cache
def _library():
    """The loaded library with its argument types set (once per process)."""
    lib = cuda_build.load_library("unsorted_segment_sum", [_SOURCE])
    for fn in (lib.unsorted_segment_sum_f32, lib.unsorted_segment_sum_f64):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _library()


def segment_sum_unsorted(
    contrib: torch.Tensor, ids: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """(B, ...) contributions with ids in any order -> (G+1, ...) sums.

    ``ids`` is (B,) int32 on the contributions' device (dummy id = G; ids
    outside [0, G) count as dummy). CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    global launches
    G = int(num_groups)
    B = contrib.shape[0]
    if ids.device != contrib.device:
        raise ValueError(
            f"plan on {ids.device} but contributions on {contrib.device}"
        )
    if ids.dtype != torch.int32 or ids.shape != (B,):
        raise ValueError(
            f"ids must be int32 of shape ({B},), got {ids.dtype} "
            f"{tuple(ids.shape)}"
        )
    if contrib.device.type == "cpu":
        return segment_sum_unsorted_plain(contrib, ids, G)
    if contrib.device.type != "cuda":
        raise ValueError(f"unsupported device {contrib.device}")
    if contrib.dtype == torch.float32:
        name = "unsorted_segment_sum_f32"
    elif contrib.dtype == torch.float64:
        name = "unsorted_segment_sum_f64"
    else:
        raise TypeError(f"unsupported dtype {contrib.dtype}")
    if G > max_num_groups(contrib.dtype):
        raise ValueError(
            f"{G} groups: one column of the table exceeds {TABLE_BYTES} bytes"
        )
    flat = contrib.reshape(B, math.prod(contrib.shape[1:])).contiguous()
    ids = ids.contiguous()
    d = flat.shape[1]
    out = torch.zeros((G + 1, d), dtype=flat.dtype, device=flat.device)
    if d == 0 or B == 0:
        return out.reshape((G + 1,) + tuple(contrib.shape[1:]))
    fn = getattr(_library(), name)
    stream = torch.cuda.current_stream(contrib.device).cuda_stream
    err = fn(
        flat.data_ptr(), ids.data_ptr(), out.data_ptr(), B, d, G + 1,
        TABLE_BYTES, THREADS, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches += 1
    return out.reshape((G + 1,) + tuple(contrib.shape[1:]))
