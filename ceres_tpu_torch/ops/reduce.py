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

A gather plan (:func:`build_gather_plan`) sums the gradients of a row
gather back into the gathered table's rows, the backward of the evaluator's
``table[index]``. It takes only the kinds that add in one fixed order on
the card (``onehot``, ``sorted``, ``unsorted``; never ``scatter``, whose
atomics add in no fixed order), so a reverse-mode gradient has the same
bits on every run, captured into a CUDA graph or not.

A reduce plan adds in one fixed order on the card too
(:func:`reduce_plan_kind`): where ``scatter`` would add more than two rows
into a group there, it is a gather plan, which leaves the dummy group's
rows out (row G is then zero; every caller drops it). Two rows a group
keep ``scatter``: 0 + a + b and 0 + b + a have the same bits. On the CPU
``index_add_`` adds in row order, so a CPU plan keeps ``scatter``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def choose_gather_plan_kind(seg: np.ndarray, num_groups: int) -> str:
    """Gather-plan kind for rows gathered from table rows ``seg`` (ids
    outside [0, G): rows whose gradient is dropped) of a ``num_groups``-row
    table: ``onehot`` for few rows, ``sorted`` (K1, through a stable row
    list unless the ids already are sorted and none is dropped), or
    ``unsorted`` (K3) for ids in any order and a few thousand rows at most.
    Never ``scatter``. The same on every device, so a CPU test runs the plan
    a card gets through the plain versions. Pure, as
    :func:`choose_plan_kind`."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    G = int(num_groups)
    if G + 1 <= ONEHOT_MAX_GROUPS:
        return "onehot"
    if np.all((seg >= 0) & (seg < G)) and np.all(seg[1:] >= seg[:-1]):
        return "sorted"
    if G + 1 <= UNSORTED_MAX_GROUPS:
        return "unsorted"
    return "sorted"


@dataclasses.dataclass
class ReducePlan:
    """Host-built plan reducing (B, ...) by segment id to (G+1, ...)."""

    kind: str
    num_groups: int
    # onehot: (G+1, B) int8; cast copies are cached per dtype.
    onehot: Optional[torch.Tensor] = None
    # sorted: (G+2,) int32 CSR row pointer (ops/segment_sum.build_row_ptr).
    row_ptr: Optional[torch.Tensor] = None
    # sorted (gather plans): (B',) int64 rows in id order, the rows kept
    # (a stable permutation of them); None when every row is, in order.
    rows: Optional[torch.Tensor] = None
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


def _mapped(seg_ids: np.ndarray, num_groups: int) -> np.ndarray:
    """(B,) int64 ids with those outside [0, G) mapped to the dummy id G."""
    seg = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    return np.where((seg < 0) | (seg >= num_groups), num_groups, seg)


def _build_plan(kind: str, seg: np.ndarray, G: int, device: torch.device) -> ReducePlan:
    """The plan of ``kind`` for mapped ids ``seg`` (``_mapped``)."""
    B = seg.shape[0]
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


def reduce_plan_kind(seg: np.ndarray, num_groups: int, device_type: str) -> Tuple[str, bool]:
    """(kind, gather) of the plan :func:`build_reduce_plan` builds for
    ``seg`` on a device of type ``device_type``: :func:`choose_plan_kind`'s
    kind, unless that is ``scatter`` on the card with more than two rows in
    some group (the dummy group aside): then the gather plan's
    (:func:`choose_gather_plan_kind`), which adds in one fixed order. Pure,
    as :func:`choose_plan_kind`."""
    G = int(num_groups)
    seg = _mapped(seg, G)
    kind = choose_plan_kind(seg, G, device_type)
    if device_type == "cuda" and kind == "scatter" and max_group_rows(seg, G) > 2:
        return choose_gather_plan_kind(seg, G), True
    return kind, False


def max_group_rows(seg: np.ndarray, num_groups: int) -> int:
    """The most rows any group 0..G-1 takes (ids outside it are the dummy
    group's)."""
    G = int(num_groups)
    return int(np.bincount(_mapped(seg, G), minlength=G + 1)[:G].max(initial=0))


def build_reduce_plan(
    seg_ids: np.ndarray, num_groups: int, device: torch.device
) -> ReducePlan:
    """Plan for reducing B rows into ``num_groups`` groups
    (:func:`reduce_plan_kind`); its index arrays live on ``device``, the
    device of the contributions it will reduce."""
    device = torch.device(device)
    G = int(num_groups)
    seg = _mapped(seg_ids, G)
    kind, gather = reduce_plan_kind(seg, G, device.type)
    if gather:
        return build_gather_plan(seg, G, device)
    return _build_plan(kind, seg, G, device)


def build_gather_plan(
    seg_ids: np.ndarray, num_groups: int, device: torch.device
) -> ReducePlan:
    """Gather plan (:func:`choose_gather_plan_kind`) summing B gathered
    rows' gradients into the ``num_groups`` rows they came from; rows with
    ids outside [0, G) add nothing to rows 0..G-1 (a ``sorted`` plan leaves
    them out, so that no long dummy segment is walked). Its arrays live on
    ``device``."""
    device = torch.device(device)
    G = int(num_groups)
    seg = _mapped(seg_ids, G)
    kind = choose_gather_plan_kind(seg, G)
    if kind != "sorted":
        return _build_plan(kind, seg, G, device)
    order = np.nonzero(seg < G)[0]
    order = order[np.argsort(seg[order], kind="stable")]
    plan = _build_plan(kind, seg[order], G, device)
    if not np.array_equal(order, np.arange(seg.shape[0])):
        plan.rows = torch.from_numpy(order).to(device)
    return plan


def apply_reduce(plan: ReducePlan, contrib: torch.Tensor) -> torch.Tensor:
    """Reduce (B, ...) contributions to (G+1, ...) group sums."""
    B = contrib.shape[0]
    tail = tuple(contrib.shape[1:])
    G = plan.num_groups
    if plan.kind == "sorted":
        rows = contrib if plan.rows is None else contrib[plan.rows]
        return segment_sum_sorted(rows, plan.row_ptr, G)
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
