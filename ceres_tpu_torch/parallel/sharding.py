"""Residual-row sharding over the ranks of a process group (port of
``ceres_tpu/parallel/sharding.py`` on ``torch.distributed``).

The model is SPMD, as ``torchrun`` runs it: every rank builds the same
problem and calls the same ``solve`` with the same mesh, a
``torch.distributed.device_mesh.DeviceMesh`` over all the ranks of an
initialised process group (the backend is the caller's: NCCL for one card
per rank, gloo for the CPU or for two ranks on one card).

**Who holds which rows.** The JAX package places every family's batch axis
on the mesh and lets GSPMD insert a collective at every sum. Here each rank
keeps a share of each family's rows, and the sums are explicit. Most sums of
the solve are linear in the rows, and the sum over ranks of the local ones
is the whole one: the cost, J' w, the column norms, the J'J blocks, the
F side of the Schur complement. Three things are not: the per-point
(E'E + D_e^2)^-1, Y = M^-1 W, and the W' M^-1 W cells over pairs of rows
of one point. So :func:`shard_program` gives every e-block (point) of the
solve's elimination ordering one owner rank and sends every row that
touches it, in every family, to that owner. The e-side work (E'E, E'w,
M^-1, the pair cells, back-substitution) is then whole on the owner, and
only f-side (camera) quantities are all-reduced. Points are dealt out in
the order of their first row, by row count, so a point-sorted BAL family is
cut only at point boundaries; rows without an e-block are dealt out one by
one in the same pass. The cut is the same for any row order and any number
of families: a point in two families, or on a constant/free split, goes
whole to its owner.

**A 2-D mesh** (:func:`make_mesh_2d`, axes ``obs`` x ``pt``) is treated as
its obs x pt ranks under the same rule: under the owner rule point-space
work is already local on every rank, which is what the JAX package's
``pt`` axis is for (its S alone is reduced over the whole mesh).

**Solvers.** Each linear solver takes one form under a mesh, fixed by its
type. Distributed (each rank its rows, all-reduced products): DENSE_SCHUR
and ITERATIVE_SCHUR (S or each S x all-reduced, every preconditioner),
CGNR (J'J x all-reduced), and the host loop's SPARSE_NORMAL_CHOLESKY and
SPARSE_SCHUR steps, as the JAX package computes them: each rank reduces
its rows into the whole program's J'J or S cells, one all-reduce sums
them, every rank factors the same cells on the host, and rank 0's
solution is broadcast (``linear/inner_product.CellLayout``; under
``dynamic_sparsity`` the rows are gathered instead, as the Jacobian goes to
the host). Gathered (every rank all-gathers the Jacobian and runs the
one-process solver; rank 0's result is broadcast): DENSE_QR and
DENSE_NORMAL_CHOLESKY. Inner iterations, DOGLEG (its sparse Gauss-Newton
solve as the LM step's) and the line-search minimizer are distributed. Every
host decision (CG's stop, the accept test, the tolerances) reads values
that are all-reduced, or computed from all-reduced values in the same way
on every rank, so every rank takes the same branch; a time budget is read
from rank 0's clock.

:class:`MeshComm` holds the collectives and counts their calls, bytes and
seconds (``stats``).

**On CUDA graphs.** Over NCCL the collectives run on the device, on
NCCL's stream ordered against the caller's with events, so a CUDA graph
captures them where they are issued, inside the conditional IF and WHILE
bodies of ``utils/cuda_graph.py`` too: a sharded solve on an NCCL mesh runs
as the same graphs as a one-process solve, with its all-reduces and
broadcasts inside them, as the JAX package's GSPMD computation holds its
collectives (``fused_lm.regions_capturable``). Over gloo they run through
the host, and the solve runs eagerly. Under a mesh every ``run_if`` and
``run_while`` predicate is computed from all-reduced or broadcast values
only, so every rank's graph takes the same branches and enters the same
collectives in the same order.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ceres_tpu_torch.loss import loss_take
from ceres_tpu_torch.ops.reduce import build_gather_plan, build_reduce_plan
from ceres_tpu_torch.problem import Family, Program
from ceres_tpu_torch.utils import cuda_graph

OBS_AXIS = "obs"
PT_AXIS = "pt"

# The JAX package pads large batches to a multiple of its evaluation bucket
# (one compiled bucket body on the TPU); ``bucket_program`` keeps its size.
EVAL_BUCKET_SIZE = 131072

# A time budget at or above this many seconds is no budget, as ``solve``
# treats it (``fused_lm.fused_traced_eligible`` runs the fused loop, which
# never reads the clock): the ranks agree on rank 0's clock only below it.
NO_TIME_BUDGET = 1e6


def _require_process_group() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: call "
            "torch.distributed.init_process_group on every rank first"
        )
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = OBS_AXIS,
              device_type: str = "cuda"):
    """1-D mesh over the ranks of the initialised process group.
    ``n_devices`` defaults to the world size and must equal it."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _require_process_group()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a world size of {n}, not {world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def make_mesh_2d(obs: int, pt: int, axis_names: Sequence[str] = (OBS_AXIS, PT_AXIS),
                 device_type: str = "cuda"):
    """2-D mesh (obs x pt) over the ranks of the process group; obs * pt
    must equal the world size. A sharded solve treats it as its obs x pt
    ranks (see the module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _require_process_group()
    if obs * pt != world:
        raise ValueError(f"a {obs} x {pt} mesh needs a world size of {obs * pt}, not {world}")
    return init_device_mesh(device_type, (obs, pt), mesh_dim_names=tuple(axis_names))


def _mesh_ranks(mesh) -> List[int]:
    """The mesh's global ranks in row-major order; it must span the world."""
    ranks = mesh.mesh.reshape(-1).tolist()
    world = _require_process_group()
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"the mesh must span all {world} ranks, got {ranks}")
    return ranks


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class MeshComm:
    """The collectives of one sharded program: this rank's position in the
    mesh (``rank``), the unsharded families (``full_families``), the
    elimination ordering it was sharded by (``e_blocks``), the e-block
    owners (``e_owner``, per parameter block id, -1 for a block that is no
    e-block) and the process group's backend (``backend``, "nccl" or
    "gloo"). Every collective spans the world group.

    ``stats`` counts the calls, bytes and seconds of each kind of
    collective ("all_reduce", "broadcast"); ``new_stats`` starts a solve's.
    Calls and bytes are counted as the kernels' launches are
    (``cuda_graph.launched``): at once where a collective runs eagerly,
    and for one captured into a CUDA graph once for each run of its region
    on the device, credited with the graph's launches; a warm-up before a
    capture counts nowhere. So a captured solve counts what an eager one
    does. ``seconds`` is measured only where a collective runs eagerly:
    with ``timed`` (a class attribute, so that a measurement can set it
    before a solve creates its program's MeshComm) the device is
    synchronized before and after each one, so that the seconds are the
    collective's own (an NCCL call returns before its work is done); off,
    they are the host's time in the call. A captured collective adds no
    seconds (its time is inside the graph's replay)."""

    timed = False

    def __init__(self, rank: int, full_families, e_blocks: np.ndarray, e_owner: np.ndarray,
                 root: int, backend: str):
        self.rank = rank
        self.full_families = list(full_families)
        self.e_blocks = e_blocks
        self.e_owner = e_owner
        self.backend = backend
        self._root = root  # global rank of position 0
        self.new_stats()

    @property
    def on_device(self) -> bool:
        """Whether the collectives run on the device (NCCL), so that a CUDA
        graph holds them; gloo's go through the host."""
        return self.backend == "nccl"

    def new_stats(self) -> dict:
        """Start counting anew (a solve's ``SolverSummary.collectives``)."""
        self.stats = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                      for k in ("all_reduce", "broadcast")}
        return self.stats

    def _credit(self, n: int, kind: str, nbytes: int) -> None:
        st = self.stats[kind]
        st["calls"] += n
        st["bytes"] += n * nbytes

    def _run(self, kind: str, op, t: torch.Tensor) -> None:
        captured = t.is_cuda and torch.cuda.is_current_stream_capturing()
        sync = self.timed and t.is_cuda and not captured
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        op(t)
        if sync:
            torch.cuda.synchronize(t.device)
        if not captured:
            self.stats[kind]["seconds"] += time.perf_counter() - t0
        cuda_graph.launched(self._credit, kind, t.numel() * t.element_size())

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` summed over the ranks (a new tensor; the same bits on every
        rank)."""
        out = a.detach().clone(memory_format=torch.contiguous_format)
        self._run("all_reduce", lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM), out)
        return out

    def sum_all(self, arrays: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each of ``arrays`` (one dtype) summed over the ranks, in one
        collective."""
        if not arrays:
            return []
        flat = self.sum(torch.cat([a.reshape(-1) for a in arrays]))
        out, k = [], 0
        for a in arrays:
            out.append(flat[k : k + a.numel()].reshape(a.shape))
            k += a.numel()
        return out

    def broadcast(self, a: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``a`` on every rank (a new tensor)."""
        out = a.detach().clone(memory_format=torch.contiguous_format)
        self._run("broadcast", lambda t: dist.broadcast(t, src=self._root), out)
        return out

    def over_budget(self, over: bool, budget: float, device) -> bool:
        """Rank 0's ``over`` (its clock past the time budget ``budget``) on
        every rank, which each rank's own clock would decide apart: a
        broadcast and a host read, between regions, for a budget below
        ``NO_TIME_BUDGET``; at or above it no rank stops for time. The
        options are the same on every rank, so every rank makes that call or
        none does."""
        if budget >= NO_TIME_BUDGET:
            return False
        t = torch.tensor([1.0 if over else 0.0], dtype=torch.float64, device=device)
        return bool(self.broadcast(t)[0].item() > 0.5)

    def gather_rows(self, families, full_families, residuals, jacs):
        """The whole families' residuals (and Jacobian blocks, unless
        ``jacs`` is None) on every rank, rows in the user's order: each rank
        puts its rows in place in zeros (``Family.source_index``, fixed
        index tensors on the device), and one all-reduce adds them (each
        row is held by one rank, so the sum is the row itself). Returns
        (residuals, jacs or None) as tuples per family."""
        parts = []
        for fi, (fam, full) in enumerate(zip(families, full_families)):
            arrays = [residuals[fi]] + ([] if jacs is None else list(jacs[fi]))
            rows, dst = fam.source_index
            for a in arrays:
                out = a.new_zeros((full.batch,) + tuple(a.shape[1:]))
                parts.append(out.index_copy_(0, dst, a.index_select(0, rows)))
        whole = iter(self.sum_all(parts))
        res, jac = [], []
        for fam in families:
            res.append(next(whole))
            if jacs is not None:
                jac.append(tuple(next(whole) for _ in range(fam.num_args)))
        return tuple(res), (None if jacs is None else tuple(jac))


def _family_float_dtype(fam: Family, dtype=None) -> torch.dtype:
    """The dtype a validity mask must take: the evaluation dtype (an f64
    mask would promote an f32 evaluation). The given one, else the existing
    mask's, else that of a floating data leaf, else f64."""
    if dtype is not None:
        return dtype
    if fam.mask is not None:
        return fam.mask.dtype
    if fam.data is not None:
        for leaf in pytree.tree_leaves(fam.data):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                return leaf.dtype
    return torch.float64


def _take_rows(fam: Family, rows: np.ndarray, real: np.ndarray, dtype) -> Family:
    """The family's instances ``rows`` (in that order), those with ``real``
    False as padding (mask 0, source row -1). The reduce and gather plans
    are rebuilt on the kept rows, for the family's device (a gather plan
    drops the padding rows, as it drops constant blocks)."""
    first = fam.bd_pos[0] if fam.bd_pos else fam.amb_pos[0]
    dev = first.device
    rows_t = torch.from_numpy(rows).to(dev)
    mask = None
    if fam.mask is not None or not real.all():
        mdt = _family_float_dtype(fam, dtype)
        m = torch.from_numpy(real.astype(np.float64)).to(dev, mdt)
        mask = m if fam.mask is None else fam.mask[rows_t].to(mdt) * m
    source = np.where(real, rows if fam.source_rows is None else fam.source_rows[rows], -1)
    kept = np.nonzero(source >= 0)[0]
    plans = tuple(
        build_reduce_plan(b.cpu().numpy()[rows], p.num_groups, dev)
        for b, p in zip(fam.bd_pos, fam.reduce_plans)
    )
    # a row with a tangent (bd_pos short of its plan's dummy) that is real
    gather_plans = tuple(
        build_gather_plan(
            np.where((b.cpu().numpy()[rows] < p.num_groups) & (source >= 0),
                     a.cpu().numpy()[rows], g.num_groups), g.num_groups, dev)
        for b, p, a, g in zip(fam.bd_pos, fam.reduce_plans, fam.amb_pos, fam.gather_plans)
    )
    return Family(
        structure=fam.structure,
        loss=loss_take(fam.loss, rows_t),
        batch=int(rows.shape[0]),
        data=None if fam.data is None else pytree.tree_map(lambda a: a[rows_t], fam.data),
        residual_ids=np.where(real, fam.residual_ids[rows], -1),
        block_ids=fam.block_ids[rows],
        bd_pos=tuple(b[rows_t] for b in fam.bd_pos),
        amb_pos=tuple(a[rows_t] for a in fam.amb_pos),
        amb_groups=fam.amb_groups,
        reduce_plans=plans,
        gather_plans=gather_plans,
        mask=mask,
        source_rows=source,
        source_index=(torch.from_numpy(kept).to(dev), torch.from_numpy(source[kept]).to(dev)),
    )


def pad_family(fam: Family, multiple: int, dtype=None) -> Family:
    """Pad a family's batch to a multiple of ``multiple``: padded rows
    repeat row 0's ids and carry mask 0 in the evaluation dtype
    (``dtype``, else the family's own, see ``_family_float_dtype``)."""
    B = fam.batch
    Bp = int(math.ceil(B / multiple) * multiple)
    if Bp == B and fam.mask is None:
        return fam
    rows = np.concatenate([np.arange(B, dtype=np.int64), np.zeros(Bp - B, dtype=np.int64)])
    real = np.arange(Bp) < B
    out = _take_rows(fam, rows, real, _family_float_dtype(fam, dtype))
    if fam.source_rows is None:
        out.source_rows = out.source_index = None  # an unsharded family stays one
    return out


def bucket_program(program: Program, bucket_size: Optional[int] = None) -> Program:
    """Pad each family batch longer than the bucket to a multiple of it, in
    place (the JAX package's fixed-size evaluation buckets; the port
    evaluates a family in one call whatever its size, so this changes
    shapes, not results)."""
    b = bucket_size or EVAL_BUCKET_SIZE
    if b <= 0:
        return program
    program.families = [
        pad_family(f, b, dtype=program.eval_dtype) if f.batch > b else f
        for f in program.families
    ]
    _invalidate_structure_caches(program)
    return program


def _invalidate_structure_caches(program: Program) -> None:
    """Drop every structure built on the old rows: the Schur structure (and
    its explicit-S plan), the per-options solve structures and the
    unsharded view."""
    program.schur_structure = None
    program.solve_aux_cache = {}
    program._unsharded_view = None


def replicate(x: torch.Tensor, mesh, device=None) -> torch.Tensor:
    """Rank 0's ``x`` on every rank, on the rank's device (``device``, else
    the mesh's device type on the current device), so that every rank
    starts from the same bits."""
    ranks = _mesh_ranks(mesh)
    out = x.detach().to(device or _mesh_device(mesh)).clone(
        memory_format=torch.contiguous_format)
    dist.broadcast(out, src=ranks[0])
    return out


def _row_owners(program: Program, e_blocks: np.ndarray, n: int):
    """Owner rank of every row of every family, and of every e-block (the
    module docstring's rule). Returns (per-family (B,) owners, (num_pids,)
    e-block owners, -1 for the other blocks)."""
    P = e_blocks.shape[0]
    pt_of = np.full(program.num_pids, -1, dtype=np.int64)
    pt_of[e_blocks] = np.arange(P)
    row_pt, base = [], 0
    for fam in program.families:
        pts = np.full(fam.batch, -1, dtype=np.int64)
        for j in range(fam.block_ids.shape[1]):
            hit = pt_of[fam.block_ids[:, j]]
            pts = np.where(hit >= 0, hit, pts)
        row_pt.append(pts)
    pts = np.concatenate(row_pt) if row_pt else np.zeros(0, np.int64)
    total = pts.shape[0]
    gidx = np.arange(total, dtype=np.int64)
    on_pt = pts >= 0
    # A point's key is its first row; a point without rows goes first.
    first = np.full(P, total, dtype=np.int64)
    np.minimum.at(first, pts[on_pt], gidx[on_pt])
    first[first == total] = -1
    count = np.bincount(pts[on_pt], minlength=P)
    free = gidx[~on_pt]
    keys = np.concatenate([first, free])
    weights = np.concatenate([count, np.ones(free.shape[0], dtype=np.int64)])
    by_key = np.argsort(keys, kind="stable")
    start = np.cumsum(weights[by_key]) - weights[by_key]
    unit_owner = np.empty(keys.shape[0], dtype=np.int64)
    unit_owner[by_key] = np.minimum(n - 1, (start * n) // max(total, 1))
    pt_owner = unit_owner[:P]
    owner = np.empty(total, dtype=np.int64)
    owner[on_pt] = pt_owner[pts[on_pt]]
    owner[~on_pt] = unit_owner[P:]
    e_owner = np.full(program.num_pids, -1, dtype=np.int64)
    e_owner[e_blocks] = pt_owner
    out, k = [], 0
    for fam in program.families:
        out.append(owner[k : k + fam.batch])
        k += fam.batch
    return out, e_owner


def shard_program(program: Program, mesh, axis_name: str = OBS_AXIS,
                  e_blocks: Optional[Sequence[int]] = None) -> Program:
    """Keep only this rank's rows of each family, in place: every row of an
    e-block goes to the e-block's owner (module docstring). ``e_blocks``:
    the elimination ordering the solve will use (default: the automatic
    Schur ordering of the whole program). Each family keeps its row order
    and gets its reduce plans rebuilt on its rows (so the CUDA kernels run
    per rank); a family with no rows here keeps one padding row. Sets
    ``program.mesh``, ``mesh_axis``, ``point_axis`` and ``comm`` (with the
    process group's backend, which decides whether the solve's regions
    run as CUDA graphs: ``fused_lm.regions_capturable``)."""
    if program.comm is not None:
        raise ValueError("the program is sharded already")
    ranks = _mesh_ranks(mesh)
    n = len(ranks)
    shard = ranks.index(dist.get_rank())
    if e_blocks is None:
        from ceres_tpu_torch.linear.schur import compute_schur_ordering

        e_blocks = compute_schur_ordering(program)
    e_blocks = np.asarray([int(p) for p in e_blocks], dtype=np.int64)
    owners, e_owner = _row_owners(program, e_blocks, n)
    full = program.families
    local = []
    for fam, own in zip(full, owners):
        rows = np.nonzero(own == shard)[0]
        real = np.ones(rows.shape[0], dtype=bool)
        if not rows.size:
            rows, real = np.zeros(1, dtype=np.int64), np.zeros(1, dtype=bool)
        local.append(_take_rows(fam, rows, real, program.eval_dtype))
    program.families = local
    program.mesh = mesh
    program.mesh_axis = axis_name
    names = mesh.mesh_dim_names or ()
    program.point_axis = PT_AXIS if PT_AXIS in names and axis_name != PT_AXIS else None
    program.comm = MeshComm(shard, full, e_blocks, e_owner, ranks[0],
                           str(dist.get_backend()))
    _invalidate_structure_caches(program)
    return program
