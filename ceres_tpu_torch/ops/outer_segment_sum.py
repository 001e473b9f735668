"""Fused pair-outer segment sum (K4): the CUDA kernel and its plain version.

Port of ``ceres_tpu/ops/pallas_segment.py``'s ``outer_segment_sum_blocked``:
for a cell-sorted list of pairs (a_idx[p], b_idx[p]) into the rows of two
slabs W (N+1, K*T1) and Y (N+1, K*T2),

    out[g, i*T2 + j] = sum over the pairs p of cell g, and over k, of
                       W[a_idx[p], k*T1 + i] * Y[b_idx[p], k*T2 + j]

-> (G+1, T1*T2), row G being the dummy cell. The kernel gathers the operand
rows itself and forms the outer products in registers: neither the gathered
(pairs, K*T) rows nor the (pairs, T1*T2) products reach device memory. The
kernel source and its design note are in
``ceres_tpu_torch/csrc/outer_segment_sum.cu``: the gathered 108-byte rows, not
the slabs read once, bound it on the card, so the shape bundle adjustment
gives it (K = 3, T1 = T2 = 9) is compiled for that shape alone (a 3 x 3
register block per lane, three pairs per warp step, cp.async staging two
buffers deep) and every other shape takes the run-time form. One warp owns a
cell and adds its pairs in a fixed order: the same bits on every run.

The plan is the CSR row pointer of the cells (``segment_sum.build_row_ptr``)
and the two int32 pair lists (:func:`pair_rows_int32`: half the bytes of
int64 lists). :func:`outer_segment_sum` launches the kernel for CUDA tensors
and takes :func:`outer_segment_sum_plain` for CPU tensors; there is no other
route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceres_tpu_torch.ops import cuda_build
from ceres_tpu_torch.ops.segment_sum import segment_sum_sorted_plain
from ceres_tpu_torch.utils import cuda_graph

# Kernel launches made by outer_segment_sum (a plain counter: a run can show
# that its main path went through the kernel).
launches = 0


def _credit(n: int) -> None:
    """Add n launches (``utils.cuda_graph.launched``)."""
    global launches
    launches += n


_SOURCE = "outer_segment_sum.cu"
# (K, T1, T2) compiled as constants in the source; others take its run-time
# form.
TILED_SHAPES = frozenset({(3, 9, 9)})
# Threads per block, and pairs per staging buffer of the compile-time form by
# element size, from tools/sweep_kernels.py on an H100 80GB HBM3 at 700 W
# (from a CUDA graph, the large bundle-adjustment case's 3.0 M pairs; more
# in PERF.md): float32 at 128 threads 0.2876 / 0.2575 / 0.2545 / 0.2930 ms
# for 3 / 6 / 9 / 12 pairs, float64 0.4625 / 0.4361 / 0.4907 / 0.5196 ms; 256
# threads within 2% of that, 512 slower (0.2634 and 0.5377 ms at best).
THREADS = 128
STAGE_PAIRS = {4: 9, 8: 6}


def pair_rows_int32(rows) -> np.ndarray:
    """Slab row numbers of a pair list as the kernel reads them: a
    contiguous int32 vector. Raises when a row number is negative or does
    not fit (2**31 and above)."""
    rows = np.asarray(rows)
    if rows.ndim != 1 or rows.dtype.kind not in "iu":
        raise ValueError("pair rows must be a vector of integers")
    if rows.size and (rows.min() < 0 or rows.max() > np.iinfo(np.int32).max):
        raise ValueError("pair rows must lie in [0, 2**31)")
    return np.ascontiguousarray(rows, dtype=np.int32)


def flat_outer(A: torch.Tensor, Bm: torch.Tensor, K: int, T1: int, T2: int):
    """Flat ``out[p, i*T2+j] = sum_k A[p, k*T1+i] * B[p, k*T2+j]``."""
    P = A.shape[0]
    return torch.einsum(
        "pki,pkj->pij", A.reshape(P, K, T1), Bm.reshape(P, K, T2)
    ).reshape(P, T1 * T2)


def outer_segment_sum_plain(W, Y, a_idx, b_idx, row_ptr, num_groups, K, T1, T2):
    """Plain PyTorch version: row gathers, einsum, ``index_add_``."""
    contrib = flat_outer(W[a_idx], Y[b_idx], K, T1, T2)
    return segment_sum_sorted_plain(contrib, row_ptr, num_groups)


@functools.cache
def _library():
    """The loaded library with its argument types set (once per process)."""
    lib = cuda_build.load_library("outer_segment_sum", [_SOURCE])
    for fn in (lib.outer_segment_sum_f32, lib.outer_segment_sum_f64):
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _library()


def outer_segment_sum(
    W: torch.Tensor,
    Y: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    row_ptr: torch.Tensor,
    num_groups: int,
    K: int,
    T1: int,
    T2: int,
) -> torch.Tensor:
    """Slabs W (N+1, K*T1), Y (N+1, K*T2), cell-sorted int32 pair rows
    ``a_idx``/``b_idx`` (Pp,) and the cells' (G+2,) int32 row pointer ->
    (G+1, T1*T2) cell sums. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    G = int(num_groups)
    dev = W.device
    for name, t in (("Y", Y), ("a_idx", a_idx), ("b_idx", b_idx), ("row_ptr", row_ptr)):
        if t.device != dev:
            raise ValueError(f"plan on {t.device} but slabs on {dev} ({name})")
    if W.ndim != 2 or Y.ndim != 2 or W.shape[1] != K * T1 or Y.shape[1] != K * T2:
        raise ValueError(
            f"slabs must be (rows, {K * T1}) and (rows, {K * T2}), got "
            f"{tuple(W.shape)} and {tuple(Y.shape)}"
        )
    if Y.dtype != W.dtype:
        raise TypeError(f"slab dtypes differ: {W.dtype} and {Y.dtype}")
    if a_idx.dtype != torch.int32 or b_idx.dtype != torch.int32 or a_idx.shape != b_idx.shape or a_idx.ndim != 1:
        raise ValueError("a_idx and b_idx must be int32 vectors of one length")
    if row_ptr.dtype != torch.int32 or row_ptr.shape != (G + 2,):
        raise ValueError(
            f"row_ptr must be int32 of shape ({G + 2},), got "
            f"{row_ptr.dtype} {tuple(row_ptr.shape)}"
        )
    if dev.type == "cpu":
        return outer_segment_sum_plain(W, Y, a_idx, b_idx, row_ptr, G, K, T1, T2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if W.dtype == torch.float32:
        name = "outer_segment_sum_f32"
    elif W.dtype == torch.float64:
        name = "outer_segment_sum_f64"
    else:
        raise TypeError(f"unsupported dtype {W.dtype}")
    W, Y = W.contiguous(), Y.contiguous()
    a_idx, b_idx = a_idx.contiguous(), b_idx.contiguous()
    out = torch.empty((G + 1, T1 * T2), dtype=W.dtype, device=dev)
    fn = getattr(_library(), name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        W.data_ptr(), Y.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
        row_ptr.data_ptr(), out.data_ptr(), G + 1, K, T1, T2,
        int((K, T1, T2) in TILED_SHAPES), THREADS,
        STAGE_PAIRS[W.element_size()], stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    cuda_graph.launched(_credit)
    return out
