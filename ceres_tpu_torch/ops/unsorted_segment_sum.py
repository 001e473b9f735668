"""Unsorted segment sum (K3): the hand-written CUDA kernel and its plain version.

Port of ``ceres_tpu/ops/pallas_segment.py``'s ``segment_sum_onehot_tiled``
(wrapper ``segment_sum_onehot``): reduce (B, ...) contributions whose
segment ids come in ANY order into (G+1, ...) group sums, row G being the
dummy group for ids outside [0, G). The caller neither sorts nor gathers its
rows. The kernel source and its design note are in
``ceres_tpu_torch/csrc/unsorted_segment_sum.cu``.

The plan (:class:`UnsortedPlan`) is built once on the host from the ids: the
rows of every segment in ascending order (``perm``), each segment's list cut
evenly into pieces (``piece_ptr``), as few as it takes for all the pieces
together to number no more than the warps the card holds at one time, and
each segment's pieces (``seg_piece_ptr``). On the card one warp gathers and
sums the rows of one piece and a second small kernel adds each segment's
pieces in their order.
:func:`segment_sum_unsorted` launches the kernels for CUDA tensors and takes
:func:`segment_sum_unsorted_plain` for CPU tensors; there is no other route.
No atomics: every sum is taken in one fixed order, the same bits on every
run.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ceres_tpu_torch.ops import cuda_build

# Kernel launches made by segment_sum_unsorted (a plain counter: a run can
# show that its main path went through the kernel). One call is one launch
# of the kernel pair (gather, then sum of the pieces).
launches = 0
# The same launches by the width d of the contributions.
launches_by_width: collections.Counter = collections.Counter()

_SOURCE = "unsorted_segment_sum.cu"

# Pieces (one warp each) per SM that a plan cuts its segments into at the
# most, so that all warps are resident together and end together: every form
# of the kernel stays within the 48 registers that 40 warps an SM allow. A
# few pieces more than the card holds at once and the time jumps by a
# quarter. tools/sweep_kernels.py k3, table ``k3_warps``, on an NVIDIA H100
# 80GB HBM3 at 700 W (B = 1.2 M, G = 464, from a CUDA graph), at 32 / 40 / 44
# / 48 / 52 pieces an SM: d = 9 float32 0.0279 / 0.0283 / 0.0353 / 0.0359 /
# 0.0367 ms (its form takes 44 registers: 40 warps an SM), d = 9 float64
# 0.0450 / 0.0474 / 0.0481 / 0.0488 / 0.0486, d = 81 float32 0.1764 / 0.1684 /
# 0.1663 / 0.1647 / 0.1626, d = 81 float64 0.2874 / 0.2857 / 0.2856 / 0.2864 /
# 0.3363.
WARPS_PER_SM = 40
# SMs of the card a CPU plan is cut for (the tests; an H100 has 132).
DEFAULT_SMS = 132
# No piece is cut shorter than this unless its segment is: a warp takes up 32
# rows at once.
MIN_PIECE_ROWS = 32
# Widths compiled as constants; every other width takes the run-time form.
COMPILED_WIDTHS = frozenset({9, 81})


def piece_rows_for(counts: np.ndarray, max_pieces: int) -> int:
    """Most rows of one piece: the least L >= MIN_PIECE_ROWS for which the
    segments, ``counts`` rows each, cut into ceil(count / L) pieces, make no
    more than ``max_pieces`` pieces. When even one piece per segment is too
    many, the longest segment's length: one piece per segment."""
    counts = np.asarray(counts, dtype=np.int64)
    lo, hi = MIN_PIECE_ROWS, max(MIN_PIECE_ROWS, int(counts.max(initial=0)))
    while lo < hi:  # pieces(L) does not grow with L
        mid = (lo + hi) // 2
        if int((-(-counts // mid)).sum()) <= max_pieces:
            hi = mid
        else:
            lo = mid + 1
    return lo


def build_plan_arrays(seg_ids: np.ndarray, num_groups: int, max_pieces: int):
    """(perm, piece_ptr, seg_piece_ptr), int32 numpy arrays, for (B,) ids.

    ``perm`` holds the rows of segment 0, then 1, ..., then the dummy
    segment G (ids outside [0, G)), each in ascending order; piece p is
    ``perm[piece_ptr[p]:piece_ptr[p + 1]]``, rows of one segment; segment g
    owns pieces ``seg_piece_ptr[g]`` up to ``seg_piece_ptr[g + 1]`` (none
    when it is empty), of lengths that differ by at most one row. The
    pieces are as short as :func:`piece_rows_for` allows for ``max_pieces``
    pieces in all."""
    G = int(num_groups)
    seg = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    B = seg.shape[0]
    if max_pieces < 1:
        raise ValueError(f"max_pieces must be positive, got {max_pieces}")
    if B >= 2**31 or G + 1 >= 2**31:
        raise ValueError("the unsorted segment sum indexes rows with int32")
    seg = np.where((seg < 0) | (seg >= G), G, seg)
    # numpy sorts 16-bit keys by radix: several times faster than int64
    key = seg.astype(np.uint16) if G < 2**16 else seg
    perm = np.argsort(key, kind="stable").astype(np.int32)
    counts = np.bincount(seg, minlength=G + 1)
    pieces = -(-counts // piece_rows_for(counts, max_pieces))
    seg_piece_ptr = np.concatenate([[0], np.cumsum(pieces)])
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    owner = np.repeat(np.arange(G + 1), pieces)
    within = np.arange(owner.shape[0]) - seg_piece_ptr[owner]
    piece_ptr = np.concatenate(
        [row_ptr[owner] + within * counts[owner] // pieces[owner], [B]]
    )
    return perm, piece_ptr.astype(np.int32), seg_piece_ptr.astype(np.int32)


@dataclasses.dataclass
class UnsortedPlan:
    """Host-built plan of one id array; the index arrays are int32 tensors
    on the device of the contributions they will reduce."""

    num_groups: int
    perm: torch.Tensor  # (B,)
    piece_ptr: torch.Tensor  # (num_pieces + 1,)
    seg_piece_ptr: torch.Tensor  # (G + 2,)

    def __post_init__(self):
        # What the kernels take as they are: raise here, once, on anything else.
        for name in ("perm", "piece_ptr", "seg_piece_ptr"):
            index = getattr(self, name)
            if index.dtype != torch.int32 or index.dim() != 1 or not index.is_contiguous():
                raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
            if index.device != self.perm.device:
                raise ValueError(f"{name} on {index.device} but perm on {self.perm.device}")
        if self.seg_piece_ptr.shape[0] != self.num_groups + 2 or self.piece_ptr.shape[0] < 1:
            raise ValueError("seg_piece_ptr must hold G + 2 entries, piece_ptr at least one")

    @property
    def num_rows(self) -> int:
        return self.perm.shape[0]

    @property
    def num_pieces(self) -> int:
        return self.piece_ptr.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def segment_of_piece(self) -> torch.Tensor:
        """(num_pieces,) int64: the segment each piece belongs to."""
        groups = torch.arange(self.num_groups + 1, device=self.device)
        per_segment = self.seg_piece_ptr[1:] - self.seg_piece_ptr[:-1]
        return torch.repeat_interleave(groups, per_segment.long())

    def piece_of_sorted_row(self) -> torch.Tensor:
        """(B,) int64: the piece of each entry of ``perm``."""
        pieces = torch.arange(self.num_pieces, device=self.device)
        per_piece = self.piece_ptr[1:] - self.piece_ptr[:-1]
        return torch.repeat_interleave(pieces, per_piece.long())

    def segment_ids(self) -> torch.Tensor:
        """The (B,) int64 ids the plan was built from (dummy id = G)."""
        ids = torch.empty(self.num_rows, dtype=torch.int64, device=self.device)
        ids[self.perm.long()] = self.segment_of_piece()[self.piece_of_sorted_row()]
        return ids


def build_unsorted_plan(
    seg_ids: np.ndarray, num_groups: int, device, max_pieces: int | None = None
) -> UnsortedPlan:
    """Plan for reducing rows with ids ``seg_ids`` into ``num_groups``
    groups, its arrays on ``device``; cut for the warps that card holds at
    a time unless ``max_pieces`` is given."""
    device = torch.device(device)
    if max_pieces is None:
        sms = DEFAULT_SMS
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        max_pieces = sms * WARPS_PER_SM
    arrays = build_plan_arrays(seg_ids, num_groups, max_pieces)
    return UnsortedPlan(int(num_groups), *(torch.from_numpy(a).to(device) for a in arrays))


def segment_sum_unsorted_plain(contrib: torch.Tensor, plan: UnsortedPlan) -> torch.Tensor:
    """Plain PyTorch version, through the plan's arrays as the kernels go:
    rows gathered by ``perm`` and added into their pieces, pieces added into
    their segments (two ``index_add_``)."""
    G = plan.num_groups
    B = contrib.shape[0]
    flat = contrib.reshape(B, math.prod(contrib.shape[1:]))
    d = flat.shape[1]
    partial = torch.zeros((plan.num_pieces, d), dtype=flat.dtype, device=flat.device)
    partial.index_add_(0, plan.piece_of_sorted_row(), flat[plan.perm.long()])
    out = torch.zeros((G + 1, d), dtype=flat.dtype, device=flat.device)
    out.index_add_(0, plan.segment_of_piece(), partial)
    return out.reshape((G + 1,) + tuple(contrib.shape[1:]))


@functools.cache
def _library():
    """The loaded library with its argument types set (once per process)."""
    lib = cuda_build.load_library("unsorted_segment_sum", [_SOURCE])
    for fn in (lib.unsorted_segment_sum_f32, lib.unsorted_segment_sum_f64):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.unsorted_segment_sum_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.unsorted_segment_sum_stream.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _library()


def _launch(flat, plan, partial, out, stages: int = 3) -> None:
    """Enqueue the kernels on the current stream: (B, d) ``flat`` through
    ``plan`` into (num_pieces, d) ``partial`` and (G+1, d) ``out``.
    ``stages``: 3, or for the measuring tools 1 (gather only) or 2 (sum of
    the pieces only)."""
    name = {torch.float32: "unsorted_segment_sum_f32",
            torch.float64: "unsorted_segment_sum_f64"}[flat.dtype]
    d = flat.shape[1]
    err = getattr(_library(), name)(
        flat.data_ptr(), plan.perm.data_ptr(), plan.piece_ptr.data_ptr(),
        plan.seg_piece_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
        plan.num_pieces, d, plan.num_groups + 1, int(d in COMPILED_WIDTHS),
        stages, torch.cuda.current_stream(flat.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def segment_sum_unsorted(contrib: torch.Tensor, plan: UnsortedPlan) -> torch.Tensor:
    """(B, ...) contributions with ids in any order -> (G+1, ...) sums.

    ``plan`` is the :class:`UnsortedPlan` of the ids, on the contributions'
    device. CPU tensors take the plain version; CUDA tensors launch the
    kernels (or raise)."""
    global launches
    G = plan.num_groups
    B = contrib.shape[0]
    if plan.device != contrib.device:
        raise ValueError(
            f"plan on {plan.device} but contributions on {contrib.device}"
        )
    if plan.num_rows != B:
        raise ValueError(f"plan of {plan.num_rows} rows but {B} contributions")
    if contrib.device.type == "cpu":
        return segment_sum_unsorted_plain(contrib, plan)
    if contrib.device.type != "cuda":
        raise ValueError(f"unsupported device {contrib.device}")
    if contrib.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {contrib.dtype}")
    flat = contrib.reshape(B, math.prod(contrib.shape[1:])).contiguous()
    d = flat.shape[1]
    tail = tuple(contrib.shape[1:])
    if d == 0 or B == 0:
        return torch.zeros((G + 1,) + tail, dtype=flat.dtype, device=flat.device)
    # Both are written in full by the kernels: no zeroing launch.
    partial = torch.empty((plan.num_pieces, d), dtype=flat.dtype, device=flat.device)
    out = torch.empty((G + 1, d), dtype=flat.dtype, device=flat.device)
    _launch(flat, plan, partial, out)
    launches += 1
    launches_by_width[d] += 1
    return out.reshape((G + 1,) + tail)
