"""Problem construction: parameter blocks + residual families (port of the
bundle-adjustment subset of ``ceres_tpu/problem.py``).

Residual blocks added by one batched :meth:`Problem.add_residual_blocks`
call form one **family**: the blocks share a residual function and block
sizes, and are evaluated with one ``vmap(jacfwd)`` call. Parameters live
in one flat ambient vector laid out exactly as the JAX package lays it out
(``ambient_offset``), so a state vector means the same in both packages.

This slice supports Euclidean, non-constant parameter blocks and the
trivial loss. A loss function, a manifold, bounds or a constant block
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceres_tpu_torch.ops.reduce import build_reduce_plan

_MODELING_API = "ROADMAP Queue 1 item 15 (modeling API)"


@dataclasses.dataclass
class _ResidualBatchRec:
    """One add_residual_blocks call: B residual blocks stored as arrays."""

    fn: Callable
    cols: np.ndarray  # (B, k) parameter block ids
    data: Optional[np.ndarray]  # (B, ...) per-instance data


@dataclasses.dataclass
class PlusStructure:
    """Index arrays of the batched plus operator. ``eu_identity``: every
    coordinate is Euclidean and tangent order equals ambient order, so plus
    is a plain vector add (always the case in this slice)."""

    eu_amb: torch.Tensor  # (nE,) ambient coords of Euclidean blocks
    eu_tan: torch.Tensor  # (nE,) matching tangent coords
    eu_identity: bool = False


def plus_apply(ps: PlusStructure, x: torch.Tensor, delta: torch.Tensor):
    """x [+] delta over all active blocks (program.cc:114)."""
    if ps.eu_identity:
        return x + delta.to(x.dtype)
    return x.index_add(0, ps.eu_amb, delta[ps.eu_tan].to(x.dtype))


def cast_program(program: "Program", dtype) -> "Program":
    """Cast a Program's floating evaluation arrays (family data) to
    ``dtype`` in place — ``SolverOptions.evaluation_dtype``. A no-op when
    already at ``dtype``; otherwise cached solve structures are dropped."""
    dtype = _torch_dtype(dtype)
    if program.eval_dtype == dtype:
        return program
    for fam in program.families:
        if fam.data is not None and fam.data.is_floating_point():
            fam.data = fam.data.to(dtype)
    program.eval_dtype = dtype
    program.solve_aux_cache.clear()
    program.schur_structure = None
    return program


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype))
    if name not in ("float32", "float64"):
        raise ValueError(f"evaluation dtype must be float32 or float64: {name}")
    return getattr(torch, name)


class BlockGroups:
    """Block-diagonal group coordinates {tangent_size: (G_T, T) int64}
    plus each group's contiguity: ``slice_of(T) = (start, G)`` when the
    group's coordinates are one ascending range of the tangent vector."""

    def __init__(self, idx: Dict[int, torch.Tensor], slices: Dict):
        self.idx = dict(idx)
        self.slices = dict(slices)

    def items(self):
        return self.idx.items()

    def __getitem__(self, T):
        return self.idx[T]

    def slice_of(self, T):
        return self.slices.get(T)


def _contiguous_start(tab: np.ndarray) -> Optional[int]:
    flat = np.asarray(tab).ravel()
    if not flat.size:
        return None
    start = int(flat[0])
    if np.array_equal(flat, np.arange(start, start + flat.size)):
        return start
    return None


class Problem:
    """Nonlinear least-squares problem: min 0.5 sum_i ||r_i||^2, built
    with the batched API (problem.h:70-553 analog)."""

    def __init__(self):
        # One (n, size) f64 array per add_parameter_blocks call; block ids
        # count through them in order. No per-block Python object exists:
        # a bundle-adjustment problem has 10^5 blocks and more.
        self._value_arrays: List[np.ndarray] = []
        self._first_pid: List[int] = []  # id of each array's first block
        self._num_blocks = 0
        self._residual_batches: List[_ResidualBatchRec] = []
        self._next_rid = 0
        self._programs: Dict[torch.device, Program] = {}

    def add_parameter_blocks(
        self, values: np.ndarray, manifold=None, constant: bool = False
    ) -> np.ndarray:
        """Batched: values (B, size) -> array of B block ids."""
        if manifold is not None:
            raise NotImplementedError(f"manifolds: {_MODELING_API}")
        if constant:
            raise NotImplementedError(f"constant blocks: {_MODELING_API}")
        values = np.array(values, dtype=np.float64)  # the problem's own copy
        if values.ndim != 2:
            raise ValueError("expected (num_blocks, block_size)")
        base = self._num_blocks
        self._value_arrays.append(values)
        self._first_pid.append(base)
        self._num_blocks += values.shape[0]
        self._programs.clear()
        return base + np.arange(values.shape[0], dtype=np.int64)

    def block_sizes(self) -> np.ndarray:
        """(num_blocks,) int64 size of every parameter block."""
        parts = [np.full(a.shape[0], a.shape[1], dtype=np.int64) for a in self._value_arrays]
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    def add_residual_blocks(
        self,
        fn: Callable,
        loss,
        param_ids: Sequence[np.ndarray],
        data: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Batched: ``param_ids`` is a list of per-argument id arrays
        (length B each); ``data`` has leading axis B. ``fn(*blocks, data)``
        returns ONE instance's residual vector in torch ops."""
        if loss is not None:
            raise NotImplementedError(f"loss functions: {_MODELING_API}")
        cols = [np.atleast_1d(np.asarray(c, dtype=np.int64)) for c in param_ids]
        B = cols[0].shape[0]
        if any(c.shape[0] != B for c in cols):
            raise ValueError("param id arrays must have equal length")
        cols = np.stack(cols, axis=1)
        if cols.size:
            if cols.min() < 0 or cols.max() >= self._num_blocks:
                raise KeyError("parameter block id out of range")
            block_sizes = self.block_sizes()
            for j in range(cols.shape[1]):
                sizes = set(np.unique(block_sizes[cols[:, j]]).tolist())
                if len(sizes) != 1:
                    raise ValueError(
                        f"argument {j}: mixed block sizes {sizes} in one "
                        "add_residual_blocks call; split into separate calls"
                    )
            if _has_duplicates(cols):
                # problem_impl.cc CHECK: a residual block may not reference
                # the same parameter block twice.
                raise ValueError("duplicate parameter blocks in a residual block")
        base = self._next_rid
        self._next_rid += B
        self._residual_batches.append(
            _ResidualBatchRec(
                fn=fn,
                cols=cols,
                data=None if data is None else np.asarray(data),
            )
        )
        self._programs.clear()
        return base + np.arange(B, dtype=np.int64)

    def num_parameter_blocks(self) -> int:
        return self._num_blocks

    def parameter_block_value(self, pid: int) -> np.ndarray:
        if not 0 <= pid < self._num_blocks:
            raise KeyError(f"parameter block id {pid} out of range")
        k = bisect.bisect_right(self._first_pid, pid) - 1
        return self._value_arrays[k][pid - self._first_pid[k]].copy()

    def state(self) -> np.ndarray:
        """Every block's current values as one flat f64 ambient vector."""
        parts = [a.reshape(-1) for a in self._value_arrays]
        return np.concatenate(parts) if parts else np.zeros(0)

    def program(self, device) -> "Program":
        """Freeze into an evaluation-ready Program on ``device``."""
        device = torch.device(device)
        prog = self._programs.get(device)
        if prog is None:
            prog = Program(self, device)
            self._programs[device] = prog
        return prog

    def write_back(self, x_ambient: np.ndarray) -> None:
        """Copy a solved flat ambient vector back into the blocks."""
        x_ambient = np.asarray(x_ambient, dtype=np.float64)
        off = 0
        for a in self._value_arrays:
            a[:] = x_ambient[off : off + a.size].reshape(a.shape)
            off += a.size


def _has_duplicates(cols: np.ndarray) -> bool:
    k = cols.shape[1]
    return any(
        np.any(cols[:, a] == cols[:, b]) for a in range(k) for b in range(a + 1, k)
    )


@dataclasses.dataclass(frozen=True)
class FamilyStructure:
    """Static part of a residual family."""

    fn: Callable
    residual_size: int
    block_sizes: Tuple[int, ...]
    tangent_sizes: Tuple[int, ...]
    has_data: bool


@dataclasses.dataclass
class Family:
    """One batched residual family on a device.

    - ``bd_pos[j]``: (B,) row of each instance's block of arg j in its
      size group (``Program.groups``). Every block is Euclidean and
      non-constant here, so the same row indexes the block's ambient
      values (the evaluator's gather) and its tangent coordinates;
    - ``reduce_plans[j]``: the batch -> group reduction of arg j.
    """

    structure: FamilyStructure
    batch: int
    data: Optional[torch.Tensor]
    block_ids: np.ndarray  # (B, k) parameter block ids
    bd_pos: Tuple[torch.Tensor, ...]
    reduce_plans: Tuple

    @property
    def residual_size(self) -> int:
        return self.structure.residual_size

    @property
    def num_args(self) -> int:
        return len(self.structure.block_sizes)


class Program:
    """Frozen, evaluation-ready view of a Problem on one device
    (internal/ceres/program.{h,cc} analog)."""

    def __init__(self, problem: Problem, device: torch.device):
        self._problem = problem
        self.device = device
        self.eval_dtype = torch.float64
        self.solve_aux_cache: dict = {}
        self.schur_structure = None
        self.fixed_cost = 0.0

        # Per block (block id = position): size and offset in the flat
        # ambient vector. No constant blocks and no manifolds: the tangent
        # layout is the ambient one.
        sizes = problem.block_sizes()
        n_pid = sizes.shape[0]
        offsets = np.cumsum(sizes) - sizes
        self.block_sizes = sizes
        self.block_offsets = offsets
        self.ambient_offset: Dict[int, int] = dict(enumerate(offsets.tolist()))
        self.num_ambient = int(sizes.sum())
        self.num_tangent = self.num_ambient

        # Block-diagonal grouping by size (block_jacobi layout; sizes in the
        # order they first appear); with ambient == tangent it also gives
        # the evaluator's block gathers.
        self.bd_groups: Dict[int, np.ndarray] = {}
        row_of_pid = np.zeros(n_pid, dtype=np.int64)
        cand, first = np.unique(sizes, return_index=True)
        for T in cand[np.argsort(first)].tolist():
            pids = np.nonzero(sizes == T)[0]
            row_of_pid[pids] = np.arange(pids.shape[0])
            self.bd_groups[T] = offsets[pids][:, None] + np.arange(T, dtype=np.int64)
        starts = {T: _contiguous_start(t) for T, t in self.bd_groups.items()}
        self.groups = BlockGroups(
            {T: torch.from_numpy(t).to(device) for T, t in self.bd_groups.items()},
            {
                T: None if starts[T] is None else (starts[T], t.shape[0])
                for T, t in self.bd_groups.items()
            },
        )

        n = self.num_ambient
        self.plus_struct = PlusStructure(
            eu_amb=torch.arange(n, device=device),
            eu_tan=torch.arange(n, device=device),
            eu_identity=True,
        )

        self.families: List[Family] = []
        for batch in problem._residual_batches:
            cols = batch.cols
            B, k = cols.shape
            sizes = tuple(int(self.block_sizes[cols[0, j]]) for j in range(k))
            bd_pos, plans = [], []
            for j in range(k):
                pj = row_of_pid[cols[:, j]]
                bd_pos.append(torch.from_numpy(pj).to(device))
                plans.append(
                    build_reduce_plan(pj, self.bd_groups[sizes[j]].shape[0], device)
                )
            data = None
            if batch.data is not None:
                data = torch.from_numpy(np.ascontiguousarray(batch.data)).to(device)
            structure = FamilyStructure(
                fn=batch.fn,
                residual_size=_infer_residual_size(batch.fn, sizes, batch.data),
                block_sizes=sizes,
                tangent_sizes=sizes,
                has_data=data is not None,
            )
            self.families.append(
                Family(
                    structure=structure,
                    batch=B,
                    data=data,
                    block_ids=cols,
                    bd_pos=tuple(bd_pos),
                    reduce_plans=tuple(plans),
                )
            )

    def initial_ambient(self) -> np.ndarray:
        """The blocks' current values as one flat f64 vector (host)."""
        return self._problem.state()

    def num_parameter_blocks(self) -> int:
        return int(self.block_sizes.shape[0])

    def num_residuals(self) -> int:
        return sum(f.batch * f.residual_size for f in self.families)


def _infer_residual_size(fn, sizes, data) -> int:
    args = [torch.ones(s, dtype=torch.float64) for s in sizes]
    if data is not None:
        args.append(torch.as_tensor(np.asarray(data)[0]))
    out = fn(*args)
    if out.ndim != 1:
        raise ValueError(
            f"residual function must return a 1-D vector, got {tuple(out.shape)}"
        )
    return int(out.shape[0])
