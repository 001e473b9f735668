"""Problem construction: parameter blocks + residual families (port of
``ceres_tpu/problem.py``; the reference's ``include/ceres/problem.h:70-553``,
``internal/ceres/program.{h,cc}``).

Residual blocks that share a residual function, parameter block sizes,
manifolds and loss structure form one **family**: they are stacked along a
batch axis and evaluated with one ``vmap(jacfwd)`` call. One batched
:meth:`Problem.add_residual_blocks` call is one family; blocks added one by
one are grouped by that key. Parameters live in one flat ambient vector laid
out exactly as the JAX package lays it out (``ambient_offset``), so a state
vector means the same in both packages.

Constant blocks are not dropped from the program: they keep their place in
the ambient vector (residual functions read them) and map to the dummy row
of their tangent group, which every reduction discards. Residual blocks
whose every parameter block is constant contribute a constant cost
(``Program.fixed_cost``) and leave the evaluated families.

Parameter blocks are stored as arrays, one per ``add_parameter_block(s)``
call, never as one Python object per block: a bundle-adjustment problem has
10^5 blocks and more.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ceres_tpu_torch.loss import (
    LossFunction,
    loss_structure,
    loss_take,
    loss_to,
    stack_losses,
)
from ceres_tpu_torch.manifold import EuclideanManifold, Manifold
from ceres_tpu_torch.ops.reduce import build_gather_plan, build_reduce_plan


@dataclasses.dataclass(eq=False)
class _BlockChunk:
    """The blocks of one add_parameter_block(s) call: equal size, one
    manifold."""

    values: np.ndarray  # (n, size) f64, the problem's own copy
    manifold: Optional[Manifold]
    constant: np.ndarray  # (n,) bool
    removed: np.ndarray  # (n,) bool
    lower: Optional[np.ndarray] = None  # (n, size), allocated on first use
    upper: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return self.values.shape[0]

    @property
    def size(self) -> int:
        return self.values.shape[1]

    @property
    def tangent_size(self) -> int:
        return self.size if self.manifold is None else self.manifold.tangent_size


@dataclasses.dataclass
class _ResidualBlockRec:
    """One add_residual_block call (residual_block.h:69 analog)."""

    rid: int
    fn: Callable
    loss: Optional[LossFunction]
    param_ids: Tuple[int, ...]
    data: Any  # per-instance pytree (leaves without batch axis)
    removed: bool = False


@dataclasses.dataclass
class _ResidualBatchRec:
    """One add_residual_blocks call: B residual blocks stored as arrays."""

    rid_base: int
    fn: Callable
    loss: Optional[LossFunction]
    cols: np.ndarray  # (B, k) parameter block ids
    data: Any  # pytree of host arrays with leading axis B, or None
    removed: np.ndarray  # (B,) bool


@dataclasses.dataclass
class PlusStructure:
    """Index arrays of the batched plus operator. ``eu_identity``: every
    coordinate is Euclidean and active and tangent order equals ambient
    order, so plus is a plain vector add. ``groups[i]`` holds the (G, A)
    ambient and (G, T) tangent coordinates of the blocks on
    ``manifolds[i]``."""

    eu_amb: torch.Tensor  # (nE,) ambient coords of Euclidean blocks
    eu_tan: torch.Tensor  # (nE,) matching tangent coords
    eu_identity: bool = False
    groups: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()
    manifolds: Tuple[Manifold, ...] = ()


def plus_apply(ps: PlusStructure, x: torch.Tensor, delta: torch.Tensor):
    """x [+] delta over all active blocks (program.cc:114)."""
    if ps.eu_identity and not ps.manifolds:
        return x + delta.to(x.dtype)
    x_new = x.index_add(0, ps.eu_amb, delta[ps.eu_tan].to(x.dtype))
    for m, (amb, tan) in zip(ps.manifolds, ps.groups):
        x_new[amb] = torch.func.vmap(m.plus)(x[amb], delta[tan].to(x.dtype))
    return x_new


def cast_program(program: "Program", dtype) -> "Program":
    """Cast a Program's floating evaluation arrays (family data and
    per-instance loss parameters) to ``dtype`` in place —
    ``SolverOptions.evaluation_dtype``. A no-op when already at ``dtype``;
    otherwise cached solve structures are dropped."""
    dtype = _torch_dtype(dtype)
    if program.eval_dtype == dtype:
        return program
    for fam in program.families + (program.comm.full_families if program.comm else []):
        if fam.mask is not None:
            fam.mask = fam.mask.to(dtype)
        if fam.data is not None:
            fam.data = pytree.tree_map(
                lambda a: a.to(dtype) if a.is_floating_point() else a, fam.data
            )
        fam.loss = loss_to(fam.loss, program.device, dtype)
    program.eval_dtype = dtype
    program._cast_bounds()
    program.solve_aux_cache.clear()
    program.schur_structure = None
    program._unsharded_view = None
    return program


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype))
    if name not in ("float32", "float64"):
        raise ValueError(f"evaluation dtype must be float32 or float64: {name}")
    return getattr(torch, name)


class BlockGroups:
    """Coordinates of blocks grouped by size, {size: (G, size) int64}, plus
    each group's contiguity: ``slice_of(size) = (start, G)`` when the
    group's coordinates are one ascending range of the flat vector."""

    def __init__(self, idx: Dict[int, torch.Tensor], slices: Dict):
        self.idx = dict(idx)
        self.slices = dict(slices)

    def items(self):
        return self.idx.items()

    def keys(self):
        return self.idx.keys()

    def __contains__(self, T):
        return T in self.idx

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


def _block_groups(tables: Dict[int, np.ndarray], device) -> BlockGroups:
    slices = {}
    for T, t in tables.items():
        start = _contiguous_start(t)
        slices[T] = None if start is None else (start, t.shape[0])
    return BlockGroups(
        {T: torch.from_numpy(t).to(device) for T, t in tables.items()}, slices
    )


def _host_leaf(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class Problem:
    """Nonlinear least-squares problem: min 0.5 sum_i rho_i(||r_i||^2)
    (problem.h:70-553 analog), with block-at-a-time and batched
    construction. Batched construction (:meth:`add_parameter_blocks`,
    :meth:`add_residual_blocks`) creates a whole residual family in one
    call."""

    def __init__(self):
        self._chunks: List[_BlockChunk] = []
        self._first_pid: List[int] = []  # id of each chunk's first block
        self._num_blocks = 0
        self._residual_blocks: List[_ResidualBlockRec] = []
        self._residual_batches: List[_ResidualBatchRec] = []
        self._next_rid = 0
        # Residual ids in order: (first rid, "s" | "b", index) per single
        # block or batch; a rid is found by bisection.
        self._rid_first: List[int] = []
        self._rid_entry: List[Tuple[str, int]] = []
        self._programs: Dict[torch.device, Program] = {}
        self._sharded: dict = {}  # this rank's programs by (device, mesh, ordering, losses)

    # -- parameter blocks ---------------------------------------------------

    def _add_chunk(self, values: np.ndarray, manifold, constant: bool) -> int:
        if manifold is not None and manifold.ambient_size != values.shape[1]:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != "
                f"block size {values.shape[1]}"
            )
        n = values.shape[0]
        base = self._num_blocks
        self._chunks.append(
            _BlockChunk(
                values=values,
                manifold=manifold,
                constant=np.full(n, bool(constant)),
                removed=np.zeros(n, dtype=bool),
            )
        )
        self._first_pid.append(base)
        self._num_blocks += n
        self._dirty()
        return base

    def add_parameter_block(
        self, values: np.ndarray, manifold: Optional[Manifold] = None,
        constant: bool = False,
    ) -> int:
        """Add one parameter block; returns its id (problem.h:258-270)."""
        values = np.atleast_1d(np.array(values, dtype=np.float64))
        if values.ndim != 1:
            raise ValueError("parameter block must be a vector")
        return self._add_chunk(values[None, :], manifold, constant)

    def add_parameter_blocks(
        self, values: np.ndarray, manifold: Optional[Manifold] = None,
        constant: bool = False,
    ) -> np.ndarray:
        """Batched: values (B, size) -> array of B block ids."""
        values = np.array(values, dtype=np.float64)  # the problem's own copy
        if values.ndim != 2:
            raise ValueError("expected (num_blocks, block_size)")
        base = self._add_chunk(values, manifold, constant)
        return base + np.arange(values.shape[0], dtype=np.int64)

    def _locate(self, pid: int) -> Tuple[_BlockChunk, int]:
        pid = int(pid)
        if not 0 <= pid < self._num_blocks:
            raise KeyError(f"parameter block id {pid} out of range")
        k = bisect.bisect_right(self._first_pid, pid) - 1
        chunk, row = self._chunks[k], pid - self._first_pid[k]
        if chunk.removed[row]:
            raise KeyError(f"parameter block {pid} was removed")
        return chunk, row

    def _chunk_index(self, pid: int) -> int:
        return bisect.bisect_right(self._first_pid, int(pid)) - 1

    def _isolate(self, pid: int) -> _BlockChunk:
        """Give block ``pid`` a chunk of its own (its arrays stay views of
        the original ones) and return it."""
        chunk, row = self._locate(pid)
        if chunk.count == 1:
            return chunk
        k = self._chunk_index(pid)
        first = self._first_pid[k]
        pieces, firsts = [], []
        for a, b in ((0, row), (row, row + 1), (row + 1, chunk.count)):
            if a == b:
                continue
            pieces.append(
                _BlockChunk(
                    values=chunk.values[a:b],
                    manifold=chunk.manifold,
                    constant=chunk.constant[a:b],
                    removed=chunk.removed[a:b],
                    lower=None if chunk.lower is None else chunk.lower[a:b],
                    upper=None if chunk.upper is None else chunk.upper[a:b],
                )
            )
            firsts.append(first + a)
        self._chunks[k : k + 1] = pieces
        self._first_pid[k : k + 1] = firsts
        return self._locate(pid)[0]

    def set_parameter_block_constant(self, pid) -> None:
        for p in np.atleast_1d(pid):
            chunk, row = self._locate(p)
            chunk.constant[row] = True
        self._dirty()

    def set_parameter_block_variable(self, pid) -> None:
        for p in np.atleast_1d(pid):
            chunk, row = self._locate(p)
            chunk.constant[row] = False
        self._dirty()

    def is_parameter_block_constant(self, pid: int) -> bool:
        chunk, row = self._locate(pid)
        return bool(chunk.constant[row])

    def set_manifold(self, pid: int, manifold: Optional[Manifold]) -> None:
        chunk, _ = self._locate(pid)
        if manifold is not None and manifold.ambient_size != chunk.size:
            raise ValueError("manifold ambient size mismatch")
        self._isolate(pid).manifold = manifold
        self._dirty()

    def get_manifold(self, pid: int) -> Optional[Manifold]:
        return self._locate(pid)[0].manifold

    def _set_bound(self, pid: int, index: int, value: float, which: str) -> None:
        chunk, row = self._locate(pid)
        if not 0 <= int(index) < chunk.size:
            raise ValueError(
                f"bound index {index} out of range for block of size "
                f"{chunk.size} (problem.h:333 CHECK)"
            )
        if getattr(chunk, which) is None:
            fill = -np.inf if which == "lower" else np.inf
            setattr(chunk, which, np.full(chunk.values.shape, fill))
        getattr(chunk, which)[row, index] = value
        self._dirty()

    def set_parameter_lower_bound(self, pid: int, index: int, value: float) -> None:
        """problem.h:333-341."""
        self._set_bound(pid, index, value, "lower")

    def set_parameter_upper_bound(self, pid: int, index: int, value: float) -> None:
        self._set_bound(pid, index, value, "upper")

    def get_parameter_lower_bound(self, pid: int, index: int) -> float:
        chunk, row = self._locate(pid)
        return -np.inf if chunk.lower is None else float(chunk.lower[row, index])

    def get_parameter_upper_bound(self, pid: int, index: int) -> float:
        chunk, row = self._locate(pid)
        return np.inf if chunk.upper is None else float(chunk.upper[row, index])

    def parameter_block_value(self, pid: int) -> np.ndarray:
        chunk, row = self._locate(pid)
        return chunk.values[row].copy()

    def set_parameter_block_value(self, pid: int, values: np.ndarray) -> None:
        chunk, row = self._locate(pid)
        values = np.asarray(values, dtype=np.float64)
        if values.shape != chunk.values[row].shape:
            raise ValueError("shape mismatch")
        chunk.values[row] = values
        self._dirty()

    def remove_parameter_block(self, pid: int) -> None:
        """problem.h:291-305: also removes residual blocks that use it."""
        chunk, row = self._locate(pid)
        chunk.removed[row] = True
        for rb in self._residual_blocks:
            if not rb.removed and int(pid) in rb.param_ids:
                rb.removed = True
        for batch in self._residual_batches:
            batch.removed |= (batch.cols == int(pid)).any(axis=1)
        self._dirty()

    def block_sizes(self) -> np.ndarray:
        """(num ids,) int64 size of every parameter block ever added."""
        return self._per_block(lambda c: c.size, np.int64)

    def _per_block(self, of_chunk, dtype) -> np.ndarray:
        """A per-chunk quantity spread over the chunk's blocks."""
        if not self._chunks:
            return np.zeros(0, dtype=dtype)
        counts = np.asarray([c.count for c in self._chunks], dtype=np.int64)
        vals = np.asarray([of_chunk(c) for c in self._chunks], dtype=dtype)
        return np.repeat(vals, counts)

    def _block_flag(self, name: str) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype=bool)
        return np.concatenate([getattr(c, name) for c in self._chunks])

    def ambient_offsets(self) -> Dict[int, int]:
        """id -> offset in the flat ambient vector, for every live block."""
        sizes = self.block_sizes()
        live = ~self._block_flag("removed")
        off = np.cumsum(sizes * live) - sizes * live
        ids = np.nonzero(live)[0]
        return dict(zip(ids.tolist(), off[ids].tolist()))

    # -- residual blocks ----------------------------------------------------

    def add_residual_block(
        self, fn: Callable, loss: Optional[LossFunction],
        param_ids: Sequence[int], data: Any = None,
    ) -> int:
        """Add one residual block (problem.h:230-253). ``fn(*blocks)`` or
        ``fn(*blocks, data)`` returns the residual vector of ONE instance in
        torch ops; blocks arrive as 1-D tensors."""
        _check_loss(loss)
        pids = tuple(int(p) for p in np.atleast_1d(np.asarray(param_ids)).ravel())
        if len(set(pids)) != len(pids):
            # problem_impl.cc CHECK: a residual block may not reference
            # the same parameter block twice.
            raise ValueError(f"duplicate parameter blocks in residual block: {pids}")
        for p in pids:
            self._locate(p)  # validate
        rid = self._next_rid
        self._next_rid += 1
        self._rid_first.append(rid)
        self._rid_entry.append(("s", len(self._residual_blocks)))
        if data is not None:
            data = pytree.tree_map(_host_leaf, data)
        self._residual_blocks.append(_ResidualBlockRec(rid, fn, loss, pids, data))
        self._dirty()
        return rid

    def add_residual_blocks(
        self, fn: Callable, loss: Optional[LossFunction],
        param_ids: Sequence[np.ndarray], data: Any = None,
    ) -> np.ndarray:
        """Batched: ``param_ids`` is a list of per-argument id arrays
        (length B each); ``data`` is an array or a tuple/pytree of arrays
        with leading axis B. ``fn(*blocks, data)`` returns ONE instance's
        residual vector in torch ops. Creates B residual blocks that share
        one family."""
        _check_loss(loss)
        cols = [np.atleast_1d(np.asarray(c, dtype=np.int64)) for c in param_ids]
        B = cols[0].shape[0]
        if any(c.shape[0] != B for c in cols):
            raise ValueError("param id arrays must have equal length")
        cols = np.stack(cols, axis=1)
        if cols.size:
            if cols.min() < 0 or cols.max() >= self._num_blocks:
                raise KeyError("parameter block id out of range")
            if self._block_flag("removed")[cols].any():
                raise KeyError("a parameter block of this call was removed")
            block_sizes = self.block_sizes()
            manifold_of = self._per_block(lambda c: id(c.manifold), np.int64)
            for j in range(cols.shape[1]):
                sizes = set(np.unique(block_sizes[cols[:, j]]).tolist())
                if len(sizes) != 1:
                    raise ValueError(
                        f"argument {j}: mixed block sizes {sizes} in one "
                        "add_residual_blocks call; split into separate calls"
                    )
                if np.unique(manifold_of[cols[:, j]]).size != 1:
                    raise ValueError(
                        f"argument {j}: blocks with different manifolds in "
                        "one add_residual_blocks call"
                    )
            if _has_duplicates(cols):
                raise ValueError("duplicate parameter blocks in a residual block")
        base = self._next_rid
        self._next_rid += B
        self._rid_first.append(base)
        self._rid_entry.append(("b", len(self._residual_batches)))
        self._residual_batches.append(
            _ResidualBatchRec(
                rid_base=base,
                fn=fn,
                loss=loss,
                cols=cols,
                data=None if data is None else pytree.tree_map(_host_leaf, data),
                removed=np.zeros(B, dtype=bool),
            )
        )
        self._dirty()
        return base + np.arange(B, dtype=np.int64)

    def _residual_record(self, rid: int):
        """('s', record) or ('b', batch, row) of a live residual block."""
        rid = int(rid)
        k = bisect.bisect_right(self._rid_first, rid) - 1
        if k < 0 or rid >= self._next_rid:
            raise KeyError(f"residual block id {rid} out of range")
        kind, idx = self._rid_entry[k]
        if kind == "s":
            rb = self._residual_blocks[idx]
            if rb.removed:
                raise KeyError(f"residual block {rid} was removed")
            return "s", rb, 0
        batch = self._residual_batches[idx]
        row = rid - batch.rid_base
        if batch.removed[row]:
            raise KeyError(f"residual block {rid} was removed")
        return "b", batch, row

    def remove_residual_block(self, rid: int) -> None:
        kind, rec, row = self._residual_record(rid)
        if kind == "s":
            rec.removed = True
        else:
            rec.removed[row] = True
        self._dirty()

    # -- introspection ------------------------------------------------------

    def num_parameter_blocks(self) -> int:
        return int((~self._block_flag("removed")).sum())

    def num_parameters(self) -> int:
        return int((self.block_sizes() * ~self._block_flag("removed")).sum())

    def num_residual_blocks(self) -> int:
        return sum(1 for r in self._residual_blocks if not r.removed) + sum(
            int((~b.removed).sum()) for b in self._residual_batches
        )

    def parameter_block_ids(self) -> List[int]:
        return np.nonzero(~self._block_flag("removed"))[0].tolist()

    def state(self) -> np.ndarray:
        """Every live block's current values as one flat f64 ambient vector."""
        parts = [
            (c.values[~c.removed] if c.removed.any() else c.values).reshape(-1)
            for c in self._chunks
        ]
        return np.concatenate(parts) if parts else np.zeros(0)

    # -- program ------------------------------------------------------------

    def _dirty(self) -> None:
        self._programs.clear()
        self._sharded.clear()

    def program(self, device) -> "Program":
        """Freeze into an evaluation-ready Program on ``device`` (the cached
        one): every family whole, also after a sharded solve."""
        device = torch.device(device)
        prog = self._programs.get(device)
        if prog is None:
            prog = Program(self, device)
            self._programs[device] = prog
        return prog

    def sharded_program(self, device, mesh, e_blocks=None) -> "Program":
        """This rank's share of the program on ``device`` over ``mesh``
        (``parallel.shard_program`` by the elimination ordering
        ``e_blocks``): the cached one for that mesh, ordering and the
        whole program's losses, so that a repeat solve replays the CUDA
        graphs its first solve captured, as the JAX package's repeat solve
        reuses its compiled sharded computation (its problem.py:600-604
        rebuilds the program, the port keeps it). Made anew when the
        problem changes."""
        from ceres_tpu_torch.fused_lm import _loss_key
        from ceres_tpu_torch.parallel import shard_program

        device = torch.device(device)
        order = None if e_blocks is None else tuple(int(p) for p in e_blocks)
        key = (device, mesh, order, _loss_key(self.program(device)))
        prog = self._sharded.get(key)
        if prog is None:
            for k in [k for k in self._sharded if k[:3] == key[:3]]:
                del self._sharded[k]  # made for other losses
            prog = self._sharded[key] = shard_program(Program(self, device), mesh,
                                                      e_blocks=order)
        return prog

    def write_back(self, x_ambient: np.ndarray) -> None:
        """Copy a solved flat ambient vector back into the blocks."""
        x_ambient = np.asarray(x_ambient, dtype=np.float64)
        off = 0
        for c in self._chunks:
            if c.removed.any():
                live = ~c.removed
                n = int(live.sum()) * c.size
                c.values[live] = x_ambient[off : off + n].reshape(-1, c.size)
            else:
                n = c.values.size
                c.values[:] = x_ambient[off : off + n].reshape(c.values.shape)
            off += n

    # -- standalone evaluation ----------------------------------------------

    def evaluate_residual_block(
        self, rid: int, apply_loss_function: bool = True, device="cuda"
    ):
        """Evaluate one residual block at the current parameter values
        (Problem::EvaluateResidualBlock, problem.h:514-537). Returns a dict
        with 'cost', 'residuals' and 'jacobians' (per-argument ambient-space
        Jacobians)."""
        from torch.func import jacfwd

        kind, rec, row = self._residual_record(rid)
        if kind == "s":
            fn, loss, pids, data = rec.fn, rec.loss, rec.param_ids, rec.data
        else:
            fn, loss = rec.fn, rec.loss
            pids = tuple(int(v) for v in rec.cols[row])
            data = None if rec.data is None else pytree.tree_map(lambda a: a[row], rec.data)
        device = torch.device(device)
        values = [
            torch.from_numpy(self.parameter_block_value(p)).to(device) for p in pids
        ]
        extra = ()
        if data is not None:
            extra = (pytree.tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device), data),)
        r = fn(*values, *extra)
        jacs = jacfwd(lambda *b: fn(*b, *extra), argnums=tuple(range(len(values))))(*values)
        sq = torch.sum(r * r)
        if apply_loss_function and loss is not None:
            cost = 0.5 * float(loss.evaluate(sq.reshape(1))[0][0])
        else:
            cost = 0.5 * float(sq)
        return {
            "cost": cost,
            "residuals": r.cpu().numpy(),
            "jacobians": [J.cpu().numpy() for J in jacs],
        }

    def evaluate(
        self, residuals: bool = False, gradient: bool = False,
        jacobian: bool = False, apply_loss_function: bool = True, device="cuda",
    ):
        """Standalone evaluation at the current parameter values
        (Problem::Evaluate, problem.h:477-481). Returns a dict with 'cost'
        and optionally 'residuals', 'gradient' (tangent space), 'jacobian'
        (dense, rows = residuals, cols = tangent) with 'jacobian_crs'. Covers
        ALL residual blocks, those of the fixed families too."""
        from ceres_tpu_torch.evaluator import (
            _cost_impl, _full_impl, _residuals_impl, to_crs,
        )

        prog = self.program(device)
        al = apply_loss_function
        x = torch.from_numpy(prog.initial_ambient()).to(prog.device, prog.eval_dtype)
        fixed = prog.fixed_families
        out = {"cost": float(_cost_impl(x, prog.families, al))}
        if fixed:
            out["cost"] += (
                prog.fixed_cost if al else float(_cost_impl(x, fixed, False))
            )
        if residuals:
            r = _residuals_impl(x, prog.families + fixed, al)
            out["residuals"] = r.cpu().numpy()
        if gradient or jacobian:
            _, grad, ctx = _full_impl(x, prog.families, prog.num_tangent, prog.groups, al)
            if gradient:
                out["gradient"] = grad.cpu().numpy()
            if jacobian:
                import scipy.sparse as sp

                J = ctx.to_dense().cpu().numpy()
                Jc = to_crs(ctx)
                if fixed:
                    # Fixed blocks have no varying columns: zero rows.
                    nf = sum(f.batch * f.residual_size for f in fixed)
                    J = np.vstack([J, np.zeros((nf, J.shape[1]))])
                    Jc = sp.vstack([Jc, sp.csr_matrix((nf, Jc.shape[1]))]).tocsr()
                out["jacobian"] = J
                out["jacobian_crs"] = Jc
        return out


def _check_loss(loss) -> None:
    if loss is not None and not isinstance(loss, LossFunction):
        raise TypeError(
            f"loss must be a ceres_tpu_torch.loss.LossFunction or None, got {type(loss).__name__}"
        )


def _has_duplicates(cols: np.ndarray) -> bool:
    """Whether any row names one block twice (each row sorted, neighbours
    compared: O(B k log k), where a test of every pair of columns is
    O(B k^2) and took 7 s for denoising's 24 x 25-argument families)."""
    if cols.shape[1] < 2:
        return False
    s = np.sort(cols, axis=1)
    return bool(np.any(s[:, 1:] == s[:, :-1]))


@dataclasses.dataclass(frozen=True)
class FamilyStructure:
    """Static part of a residual family."""

    fn: Callable
    residual_size: int
    block_sizes: Tuple[int, ...]
    tangent_sizes: Tuple[int, ...]
    manifolds: Tuple[Optional[Manifold], ...]
    has_data: bool
    loss_struct: Any


@dataclasses.dataclass
class Family:
    """One batched residual family on a device.

    - ``amb_pos[j]``: (B,) row of each instance's block of arg j in the
      ambient size group of ``amb_groups`` (the evaluator's gather; constant
      blocks included);
    - ``bd_pos[j]``: (B,) row of the block in its tangent size group
      (``Program.groups``); a constant block points at the dummy row G;
    - ``reduce_plans[j]``: the batch -> tangent group reduction of arg j;
    - ``gather_plans[j]``: the reverse mode's sum of arg j's gathered rows
      back into its ambient size group (``ops/reduce.build_gather_plan``;
      constant blocks and padding rows dropped);
    - ``data``: pytree of tensors with leading axis B, or None;
    - ``loss``: the family's loss (parameters floats, or (B,) tensors);
    - ``mask``: (B,) 1 on real rows, 0 on padding rows (which repeat a real
      row's ids and contribute nothing), in the evaluation dtype; None when
      every row is real (``parallel.pad_family``);
    - ``source_rows``: on a sharded program, the (B,) row of each instance
      in the unsharded family, -1 on padding (``parallel.shard_program``);
    - ``source_index``: beside it, on the family's device, (the real rows,
      their rows in the unsharded family): the fixed index tensors with
      which ``MeshComm.gather_rows`` puts them in place.
    """

    structure: FamilyStructure
    loss: Optional[LossFunction]
    batch: int
    data: Any
    residual_ids: np.ndarray  # (B,) residual block ids
    block_ids: np.ndarray  # (B, k) parameter block ids
    bd_pos: Tuple[torch.Tensor, ...]
    amb_pos: Tuple[torch.Tensor, ...]
    amb_groups: BlockGroups
    reduce_plans: Tuple
    gather_plans: Tuple
    mask: Optional[torch.Tensor] = None
    source_rows: Optional[np.ndarray] = None
    source_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def residual_size(self) -> int:
        return self.structure.residual_size

    @property
    def num_args(self) -> int:
        return len(self.structure.block_sizes)


def _rows_of(offsets: np.ndarray, size: int) -> np.ndarray:
    return offsets[:, None] + np.arange(size, dtype=np.int64)


def _ragged_ranges(starts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Concatenation of arange(start, start + size) over the given blocks."""
    total = int(sizes.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    return np.repeat(starts, sizes) + within


def _groups_by_size(pids: np.ndarray, sizes: np.ndarray, offsets: np.ndarray, n_pid: int):
    """Blocks ``pids`` grouped by ``sizes[pid]`` (sizes in the order they
    first appear, blocks in id order): ({size: (G, size) coords}, row of
    each pid in its group)."""
    tables: Dict[int, np.ndarray] = {}
    row_of = np.zeros(n_pid, dtype=np.int64)
    for T in _unique_in_order(sizes[pids]):
        members = pids[sizes[pids] == T]
        row_of[members] = np.arange(members.shape[0])
        tables[T] = _rows_of(offsets[members], T)
    return tables, row_of


class Program:
    """Frozen, evaluation-ready view of a Problem on one device
    (internal/ceres/program.{h,cc} analog): flat ambient layout over all
    live blocks, tangent layout over the non-constant ones, residual
    families, bounds, and the batched plus operator."""

    def __init__(self, problem: Problem, device: torch.device):
        self._problem = problem
        self.device = device
        self.eval_dtype = torch.float64
        self.solve_aux_cache: dict = {}
        self.schur_structure = None
        # Set by parallel.shard_program: the mesh, its axis names and the
        # collectives of the sharded evaluation (parallel.sharding.MeshComm).
        self.mesh = None
        self.mesh_axis = None
        self.point_axis = None
        self.comm = None
        self._unsharded_view = None

        # Per block id (position = id; removed blocks keep their slot with
        # size 0 in both layouts).
        chunks = problem._chunks
        sizes = problem.block_sizes()
        tsizes = problem._per_block(lambda c: c.tangent_size, np.int64)
        live = ~problem._block_flag("removed")
        constant = problem._block_flag("constant")
        active = live & ~constant
        n_pid = sizes.shape[0]
        self.num_pids = n_pid
        self.live, self.constant, self.active = live, constant, active
        self.block_sizes = sizes
        self.tangent_sizes = tsizes
        self.block_offsets = np.cumsum(sizes * live) - sizes * live
        self.tangent_offsets = np.cumsum(tsizes * active) - tsizes * active
        self.num_ambient = int((sizes * live).sum())
        self.num_tangent = int((tsizes * active).sum())
        self.ambient_offset: Dict[int, int] = problem.ambient_offsets()

        # Distinct manifolds (by structure), -1 = none.
        self.manifolds: List[Manifold] = []
        index_of: Dict[Manifold, int] = {}
        chunk_mid = []
        for c in chunks:
            if c.manifold is None:
                chunk_mid.append(-1)
                continue
            if c.manifold not in index_of:
                index_of[c.manifold] = len(self.manifolds)
                self.manifolds.append(c.manifold)
            chunk_mid.append(index_of[c.manifold])
        counts = np.asarray([c.count for c in chunks], dtype=np.int64)
        self.manifold_index = (
            np.repeat(np.asarray(chunk_mid, dtype=np.int64), counts)
            if chunks else np.zeros(0, dtype=np.int64)
        )

        # Tangent grouping of the active blocks by tangent size: the layout
        # of block-Jacobi preconditioning (block_jacobi_preconditioner.h:55)
        # and of every per-block reduction. Ambient grouping of ALL live
        # blocks by size: the evaluator gathers constant blocks too.
        self.bd_groups, self._bd_row = _groups_by_size(
            np.nonzero(active)[0], tsizes, self.tangent_offsets, n_pid
        )
        self.amb_groups, self._amb_row = _groups_by_size(
            np.nonzero(live)[0], sizes, self.block_offsets, n_pid
        )
        self.groups = _block_groups(self.bd_groups, device)
        self.ambient_groups = _block_groups(self.amb_groups, device)

        self._build_bounds()
        self._build_plus()
        self._build_families()

    def unsharded(self) -> "Program":
        """The program itself, or on a sharded program a view of it with
        every family whole and no collectives: what a solver that takes the
        gathered form (``parallel/sharding.py``) and the block structures
        every rank must agree on (inner-iteration sets, camera clusters) are
        built from."""
        if self.comm is None:
            return self
        if self._unsharded_view is None:
            import copy

            view = copy.copy(self)
            view.families = list(self.comm.full_families)
            view.mesh = view.mesh_axis = view.point_axis = view.comm = None
            view.solve_aux_cache = {}
            view.schur_structure = None
            self._unsharded_view = view
        return self._unsharded_view

    # -- state vectors and bounds -------------------------------------------

    def initial_ambient(self) -> np.ndarray:
        """The blocks' current values as one flat f64 vector (host)."""
        return self._problem.state()

    def _build_bounds(self) -> None:
        """The flat f64 bounds (host, ±inf where a coordinate is free) and,
        with any bound, their copies on the device in the evaluation dtype
        (``device_bounds``, what ``clamp`` reads)."""
        chunks = self._problem._chunks
        self.has_bounds = any(c.lower is not None or c.upper is not None for c in chunks)
        self.lower = np.full(self.num_ambient, -np.inf)
        self.upper = np.full(self.num_ambient, np.inf)
        self.device_bounds = None
        if not self.has_bounds:
            return
        off = 0
        for c in chunks:
            keep = ~c.removed
            n = int(keep.sum()) * c.size
            if c.lower is not None:
                self.lower[off : off + n] = c.lower[keep].reshape(-1)
            if c.upper is not None:
                self.upper[off : off + n] = c.upper[keep].reshape(-1)
            off += n
        self._cast_bounds()

    def _cast_bounds(self) -> None:
        """Bounds in the evaluation dtype, each rounded toward the inside of
        its box: a value clamped in float32 then meets the float64 bound too
        (a bound float32 holds exactly, such as 1.0, is unchanged)."""
        if not self.has_bounds:
            return
        dt = np.float32 if self.eval_dtype == torch.float32 else np.float64
        lo, hi = self.lower.astype(dt), self.upper.astype(dt)
        lo = np.where(lo < self.lower, np.nextafter(lo, dt(np.inf)), lo)
        hi = np.where(hi > self.upper, np.nextafter(hi, dt(-np.inf)), hi)
        self.device_bounds = tuple(torch.from_numpy(b).to(self.device) for b in (lo, hi))

    def clamp(self, x: torch.Tensor) -> torch.Tensor:
        """x projected onto the bounds box (x itself without bounds)."""
        if not self.has_bounds:
            return x
        lo, hi = self.device_bounds
        return torch.clamp(x, lo.to(x.dtype), hi.to(x.dtype))

    def is_feasible(self) -> bool:
        """Initial-point feasibility check (program.cc:194-236)."""
        x = self.initial_ambient()
        return bool(np.all(x >= self.lower) and np.all(x <= self.upper))

    # -- plus ---------------------------------------------------------------

    def _build_plus(self) -> None:
        """Group active blocks for the batched plus operator (program.cc:114)."""
        dev = self.device
        mid = self.manifold_index
        euclid = np.asarray(
            [-1] + [i for i, m in enumerate(self.manifolds) if isinstance(m, EuclideanManifold)]
        )
        is_eu = np.isin(mid, euclid)
        eu = np.nonzero(self.active & is_eu)[0]
        eu_amb = _ragged_ranges(self.block_offsets[eu], self.block_sizes[eu])
        eu_tan = _ragged_ranges(self.tangent_offsets[eu], self.block_sizes[eu])
        groups, manifolds = [], []
        curved = np.nonzero(self.active & ~is_eu)[0]
        for i in _unique_in_order(mid[curved]):
            m = self.manifolds[i]
            members = curved[mid[curved] == i]
            groups.append(
                (
                    torch.from_numpy(_rows_of(self.block_offsets[members], m.ambient_size)).to(dev),
                    torch.from_numpy(_rows_of(self.tangent_offsets[members], m.tangent_size)).to(dev),
                )
            )
            manifolds.append(m)
        n = self.num_ambient
        eu_identity = (
            not manifolds
            and n == self.num_tangent
            and eu_amb.shape[0] == n
            and np.array_equal(eu_amb, np.arange(n))
            and np.array_equal(eu_tan, np.arange(n))
        )
        self.plus_struct = PlusStructure(
            eu_amb=torch.from_numpy(eu_amb).to(dev),
            eu_tan=torch.from_numpy(eu_tan).to(dev),
            eu_identity=bool(eu_identity),
            groups=tuple(groups),
            manifolds=tuple(manifolds),
        )

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """x_new = x [+] delta: batched manifold plus over all active blocks."""
        return plus_apply(self.plus_struct, x, delta)

    # -- families -----------------------------------------------------------

    def _manifold_of(self, pid: int) -> Optional[Manifold]:
        i = int(self.manifold_index[pid])
        return None if i < 0 else self.manifolds[i]

    def _build_families(self) -> None:
        problem = self._problem
        # (fn, loss, cols, host data pytree, residual ids) per family, the
        # blocks added one by one first (grouped by structure, in order of
        # first appearance), then the batches: the JAX package's order.
        specs = []
        grouped: Dict[Any, List[_ResidualBlockRec]] = {}
        for rb in problem._residual_blocks:
            if rb.removed:
                continue
            key = (
                rb.fn,
                tuple(int(self.block_sizes[p]) for p in rb.param_ids),
                tuple(self._manifold_of(p) for p in rb.param_ids),
                loss_structure(rb.loss),
                None if rb.data is None else pytree.tree_structure(rb.data),
            )
            grouped.setdefault(key, []).append(rb)
        for rbs in grouped.values():
            data = None
            if rbs[0].data is not None:
                data = pytree.tree_map(
                    lambda *leaves: np.stack([np.asarray(l) for l in leaves]),
                    *[rb.data for rb in rbs],
                )
            specs.append(
                (
                    rbs[0].fn,
                    stack_losses([rb.loss for rb in rbs]),
                    np.asarray([rb.param_ids for rb in rbs], dtype=np.int64).reshape(
                        len(rbs), len(rbs[0].param_ids)
                    ),
                    data,
                    np.asarray([rb.rid for rb in rbs], dtype=np.int64),
                )
            )
        for batch in problem._residual_batches:
            keep = ~batch.removed
            if not keep.any():
                continue
            data = batch.data
            if data is not None and not keep.all():
                data = pytree.tree_map(lambda a: a[keep], data)
            specs.append(
                (batch.fn, batch.loss, batch.cols[keep], data,
                 batch.rid_base + np.nonzero(keep)[0])
            )

        # Reduced program (program.cc:291-415 CreateReducedProgram):
        # residual blocks whose every parameter block is constant
        # contribute a CONSTANT cost; they leave the evaluated families and
        # their cost is folded into ``fixed_cost`` once.
        self.families: List[Family] = []
        self.fixed_families: List[Family] = []
        for fn, loss, cols, data, rids in specs:
            fixed_mask = self.constant[cols].all(axis=1)
            if not fixed_mask.any():
                self.families.append(self._make_family(fn, loss, cols, data, rids, None))
            elif fixed_mask.all():
                self.fixed_families.append(self._make_family(fn, loss, cols, data, rids, None))
            else:
                self.families.append(self._make_family(fn, loss, cols, data, rids, ~fixed_mask))
                self.fixed_families.append(
                    self._make_family(fn, loss, cols, data, rids, fixed_mask)
                )
        self.fixed_cost = 0.0
        if self.fixed_families:
            from ceres_tpu_torch.evaluator import _cost_impl

            x = torch.from_numpy(self.initial_ambient()).to(self.device)
            self.fixed_cost = float(_cost_impl(x, self.fixed_families))

    def _make_family(self, fn, loss, cols, data, rids, rows) -> Family:
        """One family from the given residual blocks (``rows``: a bool mask
        selecting some of them, or None for all)."""
        dev = self.device
        if rows is not None:
            cols, rids = cols[rows], rids[rows]
            if data is not None:
                data = pytree.tree_map(lambda a: a[rows], data)
            loss = loss_take(loss, torch.from_numpy(rows))
        B, k = cols.shape
        sizes = tuple(int(self.block_sizes[cols[0, j]]) for j in range(k))
        tsizes = tuple(int(self.tangent_sizes[cols[0, j]]) for j in range(k))
        manifolds = tuple(self._manifold_of(cols[0, j]) for j in range(k))
        bd_pos, amb_pos, plans, gather_plans = [], [], [], []
        for j in range(k):
            col = cols[:, j]
            dummy = self.bd_groups[tsizes[j]].shape[0] if tsizes[j] in self.bd_groups else 0
            pj = np.where(self.constant[col], dummy, self._bd_row[col])
            bd_pos.append(torch.from_numpy(pj).to(dev))
            amb_pos.append(torch.from_numpy(self._amb_row[col]).to(dev))
            plans.append(build_reduce_plan(pj, dummy, dev))
            num_amb = self.amb_groups[sizes[j]].shape[0]
            gather_plans.append(build_gather_plan(
                np.where(self.constant[col], num_amb, self._amb_row[col]), num_amb, dev))
        residual_size = _infer_residual_size(fn, sizes, data)
        if data is not None:
            data = pytree.tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), data
            )
        structure = FamilyStructure(
            fn=fn,
            residual_size=residual_size,
            block_sizes=sizes,
            tangent_sizes=tsizes,
            manifolds=manifolds,
            has_data=data is not None,
            loss_struct=loss_structure(loss),
        )
        return Family(
            structure=structure,
            loss=loss_to(loss, dev, self.eval_dtype),
            batch=B,
            data=data,
            residual_ids=rids,
            block_ids=cols,
            bd_pos=tuple(bd_pos),
            amb_pos=tuple(amb_pos),
            amb_groups=self.ambient_groups,
            reduce_plans=tuple(plans),
            gather_plans=tuple(gather_plans),
        )

    # -- reporting ----------------------------------------------------------

    def num_parameter_blocks(self) -> int:
        return int(self.live.sum())

    def num_active_parameter_blocks(self) -> int:
        return int(self.active.sum())

    def num_residuals(self) -> int:
        return sum(f.batch * f.residual_size for f in self.families + self.fixed_families)

    def num_residual_blocks(self) -> int:
        return sum(f.batch for f in self.families + self.fixed_families)

    def num_residuals_reduced(self) -> int:
        """Rows in the reduced program (program.cc:291 analog)."""
        return sum(f.batch * f.residual_size for f in self.families)

    def num_residual_blocks_reduced(self) -> int:
        return sum(f.batch for f in self.families)


def _unique_in_order(a: np.ndarray) -> List[int]:
    """Distinct values of ``a`` in the order they first appear."""
    vals, first = np.unique(a, return_index=True)
    return vals[np.argsort(first)].tolist()


def _infer_residual_size(fn, sizes, data) -> int:
    args = [torch.ones(s, dtype=torch.float64) for s in sizes]
    if data is not None:
        args.append(pytree.tree_map(lambda a: torch.as_tensor(np.asarray(a)[0]), data))
    out = fn(*args)
    if out.ndim != 1:
        raise ValueError(
            f"residual function must return a 1-D vector, got {tuple(out.shape)}"
        )
    return int(out.shape[0])
