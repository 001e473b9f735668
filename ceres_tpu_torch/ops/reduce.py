"""Segment-reduction plans (port of ``ceres_tpu/ops/reduce.py``).

A :class:`ReducePlan` is built once on the host from the integer segment
ids of a (B, ...) contribution array and reduces it to (G+1, ...) group
sums, row G being the dummy group (ids outside [0, G): callers slice
``[:G]``). Kinds:

- ``onehot``: one matmul against a (G+1, B) one-hot matrix, for few groups
  (the BA cameras, the explicit-S cells);
- ``sorted``: sorted ids, many groups, on CUDA: the hand-written kernel K1
  (``ops/segment_sum.py``), which serves both of the JAX package's sorted
  kinds (``sorted`` and ``sorted_blocked``);
- ``unsorted``: ids in any order, a few hundred to a few thousand groups,
  on CUDA: the hand-written kernel K3 (``ops/unsorted_segment_sum.py``), the
  counterpart of the JAX package's ``onehot_tiled`` kind. Its callers skip
  the cell-sorting row gather a sorted kind would need (the kernel reads
  the rows where they lie, through a row list the host builds once);
- ``scatter``: ``index_add_`` (the JAX package's ``ell`` and ``scatter``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ceres_tpu_torch.ops.segment_sum import build_row_ptr, segment_sum_sorted
from ceres_tpu_torch.ops.unsorted_segment_sum import (
    UnsortedPlan,
    build_unsorted_plan,
    segment_sum_unsorted,
)

ONEHOT_MAX_GROUPS = 288  # one-hot matmul: B x (G+1) operand stays small
SORTED_MIN_ROWS = 4096  # below this a kernel launch buys nothing over index_add_
# Most rows (G+1) of the ``unsorted`` kind's output: the range of the JAX
# package's ``onehot_tiled`` kind. The kernel keeps no table, so nothing in
# it depends on the cap; against ``index_add_`` on an NVIDIA H100 80GB HBM3
# at 700 W (tools/sweep_kernels.py k3, table ``k3_cap``: B = 1.2 M rows,
# G+1 = 512 ... 16384, d = 3, 9, 81, float32 and float64, from a CUDA graph)
# it takes 0.11 to 0.67 of the library call's time at every one of the 36
# shapes, e.g. at G+1 = 4096: d = 9 0.027 against 0.084 ms, d = 81 0.179
# against 0.664 ms (float32), d = 3 0.021 against 0.038 ms (float64); the
# closest is d = 3, float64, G+1 = 16384: 0.023 against 0.034 ms. So every
# width of an ``unsorted`` plan goes to the kernel.
UNSORTED_MAX_GROUPS = 4096


def choose_plan_kind(seg: np.ndarray, num_groups: int, device_type: str) -> str:
    """Plan kind for reducing ``seg`` (ids, any int array) into
    ``num_groups`` groups on a device of type ``device_type`` ("cpu" or
    "cuda"). Pure: a CPU test can check what a CUDA device would get."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {device_type!r}")
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    G = int(num_groups)
    if G + 1 <= ONEHOT_MAX_GROUPS:
        return "onehot"
    seg = np.where((seg < 0) | (seg >= G), G, seg)
    if device_type == "cuda" and seg.shape[0] >= SORTED_MIN_ROWS:
        if np.all(seg[1:] >= seg[:-1]):
            return "sorted"
        if G + 1 <= UNSORTED_MAX_GROUPS:
            return "unsorted"
    return "scatter"


@dataclasses.dataclass
class ReducePlan:
    """Host-built plan reducing (B, ...) by segment id to (G+1, ...)."""

    kind: str
    num_groups: int
    # onehot: (G+1, B) int8; cast copies are cached per dtype.
    onehot: Optional[torch.Tensor] = None
    # sorted: (G+2,) int32 CSR row pointer (ops/segment_sum.build_row_ptr).
    row_ptr: Optional[torch.Tensor] = None
    # scatter: (B,) int64 segment ids (dummy = G).
    seg: Optional[torch.Tensor] = None
    # unsorted: the rows of each segment, cut into pieces
    # (ops/unsorted_segment_sum.UnsortedPlan).
    unsorted: Optional[UnsortedPlan] = None
    _onehot_cast: dict = dataclasses.field(default_factory=dict, repr=False)

    def onehot_as(self, dtype: torch.dtype) -> torch.Tensor:
        m = self._onehot_cast.get(dtype)
        if m is None:
            m = self.onehot.to(dtype)
            self._onehot_cast[dtype] = m
        return m


def build_reduce_plan(
    seg_ids: np.ndarray, num_groups: int, device: torch.device
) -> ReducePlan:
    """Plan for reducing B rows into ``num_groups`` groups; its index
    arrays live on ``device``, the device of the contributions it will
    reduce."""
    device = torch.device(device)
    seg = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    B = seg.shape[0]
    G = int(num_groups)
    seg = np.where((seg < 0) | (seg >= G), G, seg)
    kind = choose_plan_kind(seg, G, device.type)
    if kind == "onehot":
        onehot = np.zeros((G + 1, B), dtype=np.int8)
        onehot[seg, np.arange(B)] = 1
        return ReducePlan(
            kind=kind, num_groups=G, onehot=torch.from_numpy(onehot).to(device)
        )
    if kind == "sorted":
        return ReducePlan(
            kind=kind,
            num_groups=G,
            row_ptr=torch.from_numpy(build_row_ptr(seg, G)).to(device),
        )
    if kind == "unsorted":
        return ReducePlan(
            kind=kind, num_groups=G, unsorted=build_unsorted_plan(seg, G, device)
        )
    return ReducePlan(
        kind=kind, num_groups=G, seg=torch.from_numpy(seg).to(device)
    )


def apply_reduce(plan: ReducePlan, contrib: torch.Tensor) -> torch.Tensor:
    """Reduce (B, ...) contributions to (G+1, ...) group sums."""
    B = contrib.shape[0]
    tail = tuple(contrib.shape[1:])
    G = plan.num_groups
    if plan.kind == "sorted":
        return segment_sum_sorted(contrib, plan.row_ptr, G)
    if plan.kind == "unsorted":
        return segment_sum_unsorted(contrib, plan.unsorted)
    index = plan.onehot if plan.kind == "onehot" else plan.seg
    if index.device != contrib.device:
        raise ValueError(
            f"plan on {index.device} but contributions on {contrib.device}"
        )
    flat = contrib.reshape(B, math.prod(contrib.shape[1:]))
    if plan.kind == "onehot":
        out = plan.onehot_as(flat.dtype) @ flat
    else:
        out = torch.zeros(
            (G + 1, flat.shape[1]), dtype=flat.dtype, device=flat.device
        )
        out.index_add_(0, plan.seg, flat)
    return out.reshape((G + 1,) + tail)
