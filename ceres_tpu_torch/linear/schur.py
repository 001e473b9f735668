"""Schur-complement solve for bundle adjustment (port of the main-path
subset of ``ceres_tpu/linear/schur.py``).

The e-blocks (points) are found by a greedy maximal independent set
(parameter_block_ordering.h:74-82) and eliminated:

    S x = (F'F + D_f^2) x - F'E (E'E + D_e^2)^{-1} E'F x

DENSE_SCHUR factors an explicitly assembled S (``schur_explicit.py``), and
so does SPARSE_SCHUR here, for the callers that hold a (ctx, D) pair
(DOGLEG, mixed-precision refinement, the fused loop); the host loop's
SPARSE_SCHUR step factors the sparse S on the host (``sparse_schur.py``).
ITERATIVE_SCHUR runs PCG on the assembled S when the reduced camera system
is small (nf <= EXPLICIT_S_AUTO_MAX_NF, or ``use_explicit_schur_complement``)
and on the implicit product ``SchurOperator.s_times`` above that, with the
IDENTITY, JACOBI / SCHUR_JACOBI (block diagonal of S),
SCHUR_POWER_SERIES_EXPANSION, CLUSTER_JACOBI (block diagonal of S over
camera clusters) or CLUSTER_TRIDIAGONAL (block tridiagonal along chains of
clusters) preconditioner and, optionally, a power-series initial guess. The
camera clusters and their chains come from the native core
(``utils/native.py``). Both solvers take an explicit tangent right-hand side
(the mixed-precision refinement of ``trust_region._linear_solve``).

On a sharded program (``parallel/sharding.py``) every row of a point lies
on the point's owner rank: the point side ((E'E + D_e^2)^-1, E'w, the
back-substitution) is computed by the owner alone, and the camera side
(S, each S x, the right-hand side, the SCHUR_JACOBI blocks) is all-reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.evaluator import JacobianContext
from ceres_tpu_torch.linear.cg import conjugate_gradients, direct_termination
from ceres_tpu_torch.linear.schur_explicit import (
    _flat_apply_minv,
    _pair_product,
    assemble_reduced_system,
)
from ceres_tpu_torch.ops.outer_segment_sum import flat_outer
from ceres_tpu_torch.ops.reduce import apply_reduce, build_reduce_plan
from ceres_tpu_torch.ops.small_linalg import contract, spd_inverse, spd_solve
from ceres_tpu_torch.types import LinearSolverType, PreconditionerType
from ceres_tpu_torch.utils.cuda_graph import run_if

# Below this many f coordinates ITERATIVE_SCHUR materializes S once per
# linear solve and runs CG on the dense matrix (the JAX package's policy).
EXPLICIT_S_AUTO_MAX_NF = 2048

# The cluster preconditioners read their blocks of an implicit S from
# probes S e_i, computed in chunks of columns: each per-observation
# intermediate of a chunk, (B, max(r, T), k) over all families, takes at most
# this many bytes (a chunk holds about six of them at once). The JAX package
# computes every probe at once, about 80 GB at the 464-camera case.
PROBE_CHUNK_BYTES = 1 << 30


def compute_schur_ordering(program) -> List[int]:
    """Greedy maximal independent set of parameter blocks -> e-block pids
    (ComputeStableSchurOrdering analog): e-blocks must not share a
    residual block. The non-constant blocks are visited by (tangent size,
    -degree, pid), so BA picks the points (3) over the cameras (9).

    The greedy set in a fixed visiting order is computed in rounds of
    array operations: in each round every undecided block that comes
    first, in visiting order, among the undecided blocks of each of its
    residual blocks is taken, and the blocks sharing a residual block
    with a taken one are dropped. That gives the same set as visiting the
    blocks one by one (bundle adjustment ends after one round)."""
    n = program.num_pids
    occ_pid, occ_inst, base = [], [], 0
    for fam in program.families:
        B, k = fam.block_ids.shape
        for j in range(k):
            occ_pid.append(fam.block_ids[:, j])
            occ_inst.append(base + np.arange(B, dtype=np.int64))
        base += B
    if occ_pid:
        occ_pid, occ_inst = np.concatenate(occ_pid), np.concatenate(occ_inst)
    else:
        occ_pid = occ_inst = np.zeros(0, dtype=np.int64)
    degree = np.bincount(occ_pid, minlength=n)
    order = np.lexsort((-degree, program.tangent_sizes))  # stable: ties by pid
    order = order[program.active[order]]
    # Constant blocks are never candidates and block nobody: they rank last
    # and start out decided.
    rank = np.full(n, n, dtype=np.int64)
    rank[order] = np.arange(order.shape[0])
    occ_rank = rank[occ_pid]
    undecided = program.active.copy()
    taken = np.zeros(n, dtype=bool)
    while undecided.any():
        live = undecided[occ_pid]
        first = np.full(base, n, dtype=np.int64)
        np.minimum.at(first, occ_inst[live], occ_rank[live])
        beaten = np.zeros(n, dtype=bool)
        beaten[occ_pid[live & (first[occ_inst] != occ_rank)]] = True
        new = undecided & ~beaten
        taken |= new
        undecided &= ~new
        hit = np.zeros(base, dtype=bool)
        hit[occ_inst[new[occ_pid]]] = True
        undecided[occ_pid[hit[occ_inst]]] = False
    return order[taken[order]].tolist()


@dataclasses.dataclass
class SchurStructure:
    """Host-built index structure for Schur elimination."""

    num_points: int
    e_tangent_size: int
    e_group: torch.Tensor  # (P, Te) tangent indices of e-blocks
    f_mask: torch.Tensor  # (num_tangent,) 1 on f coords, 0 on e coords
    f_idx: torch.Tensor  # (nf,) tangent indices of f coords
    e_arg: Tuple[int, ...]  # per family: the e-block arg, or -1
    e_pos: Tuple[Optional[torch.Tensor], ...]  # (B,) point row per family
    f_groups: Dict[int, torch.Tensor]  # {T: (G, T)} f block coords
    # per family/arg: the f block row of each instance (dummy = the size
    # group's count; None for the e-arg) and its camera-side reduce plan
    f_pos: Tuple[Tuple[Optional[torch.Tensor], ...], ...]
    f_plan: Tuple[Tuple, ...]
    e_plan: Tuple  # per family: point-side reduce plan
    e_slice: Optional[int]  # start when e coords are one ascending range
    # host copies of e_pos and of the per family/arg f block positions
    # (schur_explicit.build_explicit_plan reads them)
    host_e_pos: Tuple[Optional[np.ndarray], ...]
    host_f_pos: Tuple[Tuple[Optional[np.ndarray], ...], ...]
    host_e_pids: np.ndarray  # (P,) the e-block ids, in point order
    explicit: Optional[object] = None  # schur_explicit.ExplicitSchurPlan
    # CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL (attach_clusters): (C, m) tangent
    # coordinates of each camera cluster padded with num_tangent, the (R, 2)
    # (cluster, slot) of each of its R real coordinates (static, so that
    # reading the table shapes nothing at solve time), and the
    # (num_chains, L) cluster ids of each chain padded with C
    cluster_groups: Optional[torch.Tensor] = None
    cluster_slots: Optional[torch.Tensor] = None
    chain_clusters: Optional[torch.Tensor] = None
    # SPARSE_SCHUR's CSC assembly of upper(S) (sparse_schur.py), and on a
    # sharded program where this rank's cells go in the whole program's
    # (inner_product.CellLayout)
    sparse_assembly: Optional[object] = None
    sparse_layout: Optional[object] = None
    # on a sharded program: (P,) bool, the points this rank owns
    e_owned: Optional[torch.Tensor] = None

    def to_dtype(self, dtype: torch.dtype) -> "SchurStructure":
        """The structure with its one floating array, ``f_mask``, in
        ``dtype`` (the mixed-precision solve; everything else is indices
        and plans, which serve every dtype)."""
        return dataclasses.replace(self, f_mask=self.f_mask.to(dtype))


def build_schur_structure(program, ordering: Optional[List[int]] = None,
                          device=None) -> SchurStructure:
    """Build the elimination structure on the program's device, or on
    ``device`` (the explicit-S plan is attached by the caller when S is to
    be assembled). ``ordering``: the e-block ids to eliminate (group 0 of
    ``SolverOptions.linear_solver_ordering``) in place of the automatic
    independent set; on a sharded program, the ordering it was sharded by).
    On a sharded program every e-block must have an owner rank."""
    dev = program.device if device is None else torch.device(device)
    comm = program.comm
    if ordering is None:
        ordering = compute_schur_ordering(program) if comm is None else comm.e_blocks
    e_pids = np.asarray([int(p) for p in ordering], dtype=np.int64)
    if not e_pids.size:
        raise ValueError("no e-blocks found for Schur elimination")
    sizes, offsets = program.tangent_sizes, program.tangent_offsets
    n = program.num_pids
    # Uniform e tangent size: keep the majority size (ties: the size met
    # first in the ordering).
    e_sizes = sizes[e_pids]
    cand, first, counts = np.unique(e_sizes, return_index=True, return_counts=True)
    Te = int(cand[np.lexsort((first, -counts))[0]])
    e_pids = e_pids[e_sizes == Te]
    P = e_pids.shape[0]
    e_group = offsets[e_pids][:, None] + np.arange(Te)
    e_owned = None
    if comm is not None:
        owner = comm.e_owner[e_pids]
        if np.any(owner < 0):
            raise ValueError(
                "the elimination ordering names e-blocks the program was not "
                "sharded by (shard_program's e_blocks)"
            )
        e_owned = owner == comm.rank

    f_mask = np.ones(program.num_tangent)
    f_mask[e_group.reshape(-1)] = 0.0
    f_idx = np.nonzero(f_mask > 0)[0]

    # f blocks by size (sizes in the order they first appear), block order
    # inside a size; lookup tables pid -> point row / f block row (dummy =
    # the group's size).
    in_e_lut = np.zeros(n, dtype=bool)
    in_e_lut[e_pids] = True
    pt_idx_lut = np.full(n, P, dtype=np.int64)
    pt_idx_lut[e_pids] = np.arange(P)
    f_pids = np.nonzero(program.active & ~in_e_lut)[0]
    f_sizes = sizes[f_pids]
    f_cand, f_first = np.unique(f_sizes, return_index=True)
    f_rows: Dict[int, np.ndarray] = {}
    fpos_lut: Dict[int, np.ndarray] = {}
    for T in f_cand[np.argsort(f_first)].tolist():
        pids_T = f_pids[f_sizes == T]
        f_rows[T] = offsets[pids_T][:, None] + np.arange(T)
        fpos_lut[T] = np.full(n, pids_T.shape[0], dtype=np.int64)
        fpos_lut[T][pids_T] = np.arange(pids_T.shape[0])
    f_group_sizes = {T: rows.shape[0] for T, rows in f_rows.items()}

    e_arg: List[int] = []
    e_pos: List[Optional[np.ndarray]] = []
    f_pos: List[Tuple[Optional[np.ndarray], ...]] = []
    for fam in program.families:
        bids = fam.block_ids
        ea, ep = -1, None
        for j in range(bids.shape[1]):
            in_e = in_e_lut[bids[:, j]]
            if in_e.any():
                # Constant blocks are variable-free: they may share an
                # e-column (their contributions drop at the dummy row).
                if not np.all(in_e | program.constant[bids[:, j]]):
                    raise ValueError(
                        "mixed e/f blocks in one family argument position; "
                        "regroup the problem"
                    )
                if ea != -1:
                    raise ValueError(
                        "two e-blocks in one residual block — invalid "
                        "elimination ordering (schur_eliminator.h:143)"
                    )
                ea, ep = j, pt_idx_lut[bids[:, j]]
        e_arg.append(ea)
        e_pos.append(ep)
        fp: List[Optional[np.ndarray]] = []
        for j in range(bids.shape[1]):
            if j == ea:
                fp.append(None)
                continue
            T = fam.structure.tangent_sizes[j]
            lut = fpos_lut.get(T)
            fp.append(
                np.full(bids.shape[0], f_group_sizes.get(T, 0), dtype=np.int64)
                if lut is None
                else lut[bids[:, j]]
            )
        f_pos.append(tuple(fp))

    e_plan = tuple(
        None if ep is None else build_reduce_plan(ep, P, dev) for ep in e_pos
    )
    # Camera-side plans (the JAX package's f_plan). Where an arg's f block
    # rows are its block-diagonal rows, as for BA's cameras, the family's
    # own plan is the same plan and is shared.
    f_plan = []
    for fam, fps in zip(program.families, f_pos):
        plans = []
        for j, fp in enumerate(fps):
            if fp is None:
                plans.append(None)
                continue
            own = fam.reduce_plans[j]
            G = f_group_sizes.get(fam.structure.tangent_sizes[j], 0)
            col = fam.block_ids[:, j]
            bd_pos = np.where(program.constant[col], own.num_groups, program._bd_row[col])
            same = own.num_groups == G and np.array_equal(bd_pos, fp)
            plans.append(own if same else build_reduce_plan(fp, G, dev))
        f_plan.append(tuple(plans))

    e_flat = e_group.ravel()
    e_slice = (
        int(e_flat[0])
        if np.array_equal(e_flat, np.arange(e_flat[0], e_flat[0] + e_flat.size))
        else None
    )

    def to_dev(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    return SchurStructure(
        num_points=P,
        e_tangent_size=Te,
        e_group=to_dev(e_group),
        f_mask=torch.from_numpy(f_mask).to(dev, program.eval_dtype),
        f_idx=to_dev(f_idx),
        e_arg=tuple(e_arg),
        e_pos=tuple(to_dev(ep) for ep in e_pos),
        f_groups={T: to_dev(rows) for T, rows in f_rows.items()},
        f_pos=tuple(tuple(to_dev(p) for p in fp) for fp in f_pos),
        f_plan=tuple(f_plan),
        e_plan=e_plan,
        e_slice=e_slice,
        host_e_pos=tuple(e_pos),
        host_f_pos=tuple(f_pos),
        host_e_pids=e_pids,
        e_owned=to_dev(e_owned),
    )


def attach_clusters(program, ss: SchurStructure, with_forest: bool = False) -> None:
    """Cluster the f blocks (the cameras) by visibility and set
    ``ss.cluster_groups`` and, ``with_forest``, ``ss.chain_clusters``
    (``_build_cluster_groups`` of the JAX package's ``linear/schur.py``).

    Canonical views (canonical_views_clustering.h:98, the clustering
    visibility_based_preconditioner.cc uses) in the native core over the
    (camera, point) pairs of the observations; with ``with_forest`` the
    core's maximum-weight linear forest over the cluster visibility graph
    (paths: degree at most 2), walked into chains from their ends, a
    cluster outside every edge a chain of its own. Nothing is set when no
    observation joins an f block and an e block. On a sharded program the
    clusters come from the whole program's observations, the same on every
    rank."""
    from ceres_tpu_torch.utils import native

    program = program.unsharded()
    n = program.num_pids
    e_pids = ss.host_e_pids
    in_e = np.zeros(n, dtype=bool)
    in_e[e_pids] = True
    f_pids = np.nonzero(program.active & ~in_e)[0]  # ascending
    cam_lut = np.full(n, -1, dtype=np.int64)
    cam_lut[f_pids] = np.arange(f_pids.shape[0])
    pt_lut = np.zeros(n, dtype=np.int64)  # a non-e block in the e slot: point 0
    pt_lut[e_pids] = np.arange(e_pids.shape[0])
    cam_idx, pt_idx = [], []
    for fam in program.families:
        ids = np.asarray(fam.block_ids, dtype=np.int64)
        e_cols = [j for j in range(ids.shape[1]) if in_e[ids[0, j]]]
        if not e_cols:
            continue
        ej = e_cols[0]
        for j in range(ids.shape[1]):
            if j == ej:
                continue
            cams = cam_lut[ids[:, j]]
            keep = cams >= 0
            cam_idx.append(cams[keep])
            pt_idx.append(pt_lut[ids[keep, ej]])
    cam_arr = np.concatenate(cam_idx) if cam_idx else np.zeros(0, np.int64)
    if not cam_arr.size:
        return
    pt_arr = np.concatenate(pt_idx)
    n_pt = int(pt_arr.max()) + 1
    nclusters, cluster = native.canonical_views_clusters(f_pids.shape[0], n_pt, cam_arr, pt_arr)
    # tangent coordinates per cluster (its blocks ascending), padded
    sizes, offsets = program.tangent_sizes, program.tangent_offsets
    rows = [[] for _ in range(nclusters)]
    for pid, c in zip(f_pids.tolist(), cluster.tolist()):
        rows[c].extend(range(int(offsets[pid]), int(offsets[pid] + sizes[pid])))
    m = max(len(r) for r in rows)
    mat = np.full((nclusters, m), program.num_tangent, dtype=np.int64)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    ss.cluster_groups = torch.from_numpy(mat).to(program.device)
    ss.cluster_slots = torch.from_numpy(np.argwhere(mat < program.num_tangent)).to(program.device)
    ss.chain_clusters = None
    if not (with_forest and nclusters > 1):
        return
    ea, eb = native.cluster_linear_forest(
        nclusters, n_pt, np.asarray(cluster, dtype=np.int64)[cam_arr], pt_arr)
    adj = [[] for _ in range(nclusters)]
    for a, b in zip(ea.tolist(), eb.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    visited = [False] * nclusters
    chains = []
    for c in range(nclusters):  # walk every path from an end
        if visited[c] or len(adj[c]) > 1:
            continue
        path, cur = [c], c
        visited[c] = True
        while True:
            nxt = [v for v in adj[cur] if not visited[v]]
            if not nxt:
                break
            cur = nxt[0]
            visited[cur] = True
            path.append(cur)
        chains.append(path)
    chains += [[c] for c in range(nclusters) if not visited[c]]  # none: the forest is acyclic
    L = max(len(ch) for ch in chains)
    chain_mat = np.full((len(chains), L), nclusters, dtype=np.int64)
    for i, ch in enumerate(chains):
        chain_mat[i, : len(ch)] = ch
    ss.chain_clusters = torch.from_numpy(chain_mat).to(program.device)


class SchurOperator:
    """Schur-space linear maps for one (ctx, D) pair. Vectors live in full
    tangent length; f-space vectors keep zeros on the e coordinates. The
    (E'E + D_e^2) point blocks are inverted once, in closed form."""

    def __init__(self, ctx: JacobianContext, D: torch.Tensor, ss: SchurStructure):
        self.ctx = ctx
        self.ss = ss
        self.D = D
        Te, P = ss.e_tangent_size, ss.num_points
        self.dtype = ctx.residuals[0].dtype
        ete = torch.zeros((P, Te * Te), dtype=self.dtype, device=D.device)
        for fi in range(len(ctx.families)):
            ea = ss.e_arg[fi]
            if ea < 0:
                continue
            E = ctx.jacs[fi][ea]
            ete = ete + self._reduce_e(fi, _pair_product(E, E))
        De = self._gather_e(D)
        ete = ete.reshape(P, Te, Te) + torch.diag_embed(De * De)
        if ss.e_owned is not None:
            # another rank's points: identity, so that their (zero) E'w
            # solves to zero here
            eye = torch.eye(Te, dtype=ete.dtype, device=ete.device)
            ete = torch.where(ss.e_owned[:, None, None], ete, eye)
        self._ete_inv = spd_inverse(ete)
        self._coordinates = None  # s_columns' coordinate tables, made at first use

    @classmethod
    def from_inverse(cls, ctx: JacobianContext, D: torch.Tensor, ss: SchurStructure,
                     ete_inv: torch.Tensor) -> "SchurOperator":
        """The operator of (ctx, D) with its (E'E + D_e^2)^{-1} blocks
        already computed (an earlier operator's ``_ete_inv``)."""
        op = cls.__new__(cls)
        op.ctx, op.ss, op.D = ctx, ss, D
        op.dtype = ctx.residuals[0].dtype
        op._ete_inv = ete_inv
        op._coordinates = None
        return op

    def _gather_e(self, v: torch.Tensor) -> torch.Tensor:
        """(P, Te) view of the e coordinates of a tangent vector."""
        ss = self.ss
        if ss.e_slice is not None:
            n = ss.num_points * ss.e_tangent_size
            return v[ss.e_slice : ss.e_slice + n].view(
                ss.num_points, ss.e_tangent_size
            )
        return v[ss.e_group]

    def _reduce_e(self, fi: int, contrib: torch.Tensor) -> torch.Tensor:
        """Sum per-instance contributions into per-point rows (P, ...)."""
        return apply_reduce(self.ss.e_plan[fi], contrib)[: self.ss.num_points]

    def _edot(self, w) -> torch.Tensor:
        """E' w aggregated per point -> (P, Te)."""
        ss, ctx = self.ss, self.ctx
        t = torch.zeros(
            (ss.num_points, ss.e_tangent_size), dtype=self.dtype, device=self.D.device
        )
        for fi in range(len(ctx.families)):
            ea = ss.e_arg[fi]
            if ea < 0:
                continue
            E = ctx.jacs[fi][ea]
            t = t + self._reduce_e(fi, torch.einsum("bri,br->bi", E, w[fi]))
        return t

    def _solve_ete(self, t: torch.Tensor) -> torch.Tensor:
        """(E'E + D_e^2)^{-1} t, batched (P, Te)."""
        return spd_solve(self._ete_inv, t)

    def _owned_e(self, u: torch.Tensor) -> torch.Tensor:
        """A (P, Te) point-space result whole on every rank: each owner's
        rows, all-reduced (``u`` itself in one process)."""
        comm, owned = self.ctx.comm, self.ss.e_owned
        if comm is None:
            return u
        return comm.sum(torch.where(owned[:, None], u, 0.0))

    def _embed_e(self, u: torch.Tensor) -> torch.Tensor:
        """(P, Te) point vector -> full tangent vector (zero on f)."""
        ss = self.ss
        z = torch.zeros((self.ctx.num_tangent,), dtype=self.dtype, device=u.device)
        if ss.e_slice is not None:
            z[ss.e_slice : ss.e_slice + u.numel()] = u.reshape(-1)
        else:
            z[ss.e_group.reshape(-1)] = u.reshape(-1)
        return z

    def _e_times(self, u: torch.Tensor):
        """E u for a point-space u (P, Te) -> per-family (B, r) blocks."""
        ctx, ss = self.ctx, self.ss
        u_pad = torch.cat([u, u.new_zeros((1, ss.e_tangent_size))], dim=0)
        out = []
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            if ea < 0:
                out.append(u.new_zeros((fam.batch, fam.residual_size)))
                continue
            uj = u_pad[ss.e_pos[fi]]
            out.append(torch.einsum("brt,bt->br", ctx.jacs[fi][ea], uj))
        return tuple(out)

    def s_times(self, x: torch.Tensor) -> torch.Tensor:
        """S x for x supported on f coords (implicit_schur_complement.cc:106)."""
        ctx, ss, D = self.ctx, self.ss, self.D
        x = x * ss.f_mask
        w1 = ctx.matvec(x, skip=ss.e_arg)  # F x
        u = self._solve_ete(self._edot(w1))
        w2 = self._e_times(u)  # E (E'E)^-1 E' F x
        diff = tuple(a - b for a, b in zip(w1, w2))
        out = ctx.rmatvec(diff, skip=ss.e_arg) + (D * D) * x
        return out * ss.f_mask

    def s_columns(self, cols: torch.Tensor) -> torch.Tensor:
        """S[:, cols] (n, k): :meth:`s_times` of the k unit vectors e_cols
        (a column of num_tangent, or of an e coordinate, is zero), every
        per-observation product a (B, r, k) one. F e_i is column i of F's
        block on the observations of i's block, so it is gathered, not
        multiplied; the other products contract their short axis (r, Te) one
        term at a time, where a batched matmul of 1.2 M tiny matrices would
        spend most of its time on them."""
        ctx, ss, D = self.ctx, self.ss, self.D
        n, k = ctx.num_tangent, cols.shape[0]
        dev = cols.device
        colc = torch.clamp(cols, max=n - 1)
        live = (cols < n) & (ss.f_mask[colc] > 0)
        if self._coordinates is None:
            # each tangent coordinate's block size, block row in its size
            # group and offset in the block
            size = torch.zeros((n,), dtype=torch.int64, device=dev)
            row, off = torch.zeros_like(size), torch.zeros_like(size)
            for T, idx in ctx.groups.items():
                flat = idx.reshape(-1)
                size.index_fill_(0, flat, T)  # no host scalar: a capture refuses its copy
                row[flat] = torch.arange(idx.shape[0], device=dev).repeat_interleave(T)
                off[flat] = torch.arange(T, device=dev).repeat(idx.shape[0])
            self._coordinates = (size, row, off)
        c_size, c_row, c_off = (a[colc] for a in self._coordinates)
        w1 = []  # F e_cols per family: (B, r, k)
        for fi, fam in enumerate(ctx.families):
            acc = torch.zeros((fam.batch, fam.residual_size, k), dtype=self.dtype, device=dev)
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if j == ss.e_arg[fi] or T not in ctx.groups:
                    continue
                hit = live & (c_size == T)
                match = (fam.bd_pos[j][:, None] == c_row[None, :]) & hit[None, :]
                acc = acc + ctx.jacs[fi][j][:, :, torch.where(hit, c_off, 0)] * match[:, None, :]
            w1.append(acc)
        t = torch.zeros((ss.num_points, ss.e_tangent_size, k), dtype=self.dtype, device=dev)
        for fi in range(len(ctx.families)):
            ea = ss.e_arg[fi]
            if ea >= 0:  # E' F e_cols per point
                t = t + self._reduce_e(fi, contract(ctx.jacs[fi][ea].transpose(1, 2), w1[fi]))
        u = contract(self._ete_inv, t)  # (E'E + D_e^2)^{-1} E'F e_cols
        u_pad = torch.cat([u, u.new_zeros((1, *u.shape[1:]))], dim=0)
        diff = []
        for fi in range(len(ctx.families)):
            ea = ss.e_arg[fi]
            diff.append(w1[fi] if ea < 0 else
                        w1[fi] - contract(ctx.jacs[fi][ea], u_pad[ss.e_pos[fi]]))
        out = ctx.rmatmat(diff, skip=ss.e_arg)
        lanes = torch.arange(k, device=dev)
        out[colc, lanes] += torch.where(live, D[colc] * D[colc], 0.0)  # D^2 e_cols
        return out * ss.f_mask[:, None]

    def probe(self, cols: torch.Tensor, rows, chunk: Optional[int] = None):
        """Entries of S's columns: for each probed tangent coordinate
        ``cols[p]`` (num_tangent = none) and each (N, m) coordinate table of
        ``rows``, out[p, b] = (S e_cols[p])[rows[p, b]] (0 where either is
        none). The columns come from :meth:`s_columns` in chunks of
        ``chunk`` (default: as many as PROBE_CHUNK_BYTES allows)."""
        ctx = self.ctx
        n = ctx.num_tangent
        N = cols.shape[0]
        if chunk is None:
            width = max(max(fam.residual_size, *fam.structure.tangent_sizes)
                        for fam in ctx.families)
            per_column = sum(fam.batch for fam in ctx.families) * width * self.D.element_size()
            chunk = max(1, PROBE_CHUNK_BYTES // per_column)
        outs = [torch.zeros(tuple(r.shape), dtype=self.dtype, device=self.D.device) for r in rows]
        for start in range(0, N, chunk):
            c = cols[start : start + chunk]
            k = c.shape[0]
            lanes = torch.arange(k, device=c.device)
            SX = self.s_columns(c)
            SX = torch.cat([SX, SX.new_zeros((1, k))], dim=0)
            for out, r in zip(outs, rows):
                out[start : start + k] = SX[r[start : start + k], lanes[:, None]]
        return outs

    def _cluster_reads(self, cluster_groups: torch.Tensor, targets, S=None, chunk=None):
        """For every cluster c and its coordinate slot a, the entries
        S[t[c, b], coords[c, a]] for each (C, m) target table t of
        ``targets``: (C, m, m) per target, [c, a, b]. From the assembled
        reduced S when given, else from probes of the implicit S (the JAX
        package's vmapped S e_i, here in chunks of a static width).
        ``cluster_groups`` is the structure's table (``attach_clusters``),
        whose real coordinates ``ss.cluster_slots`` lists."""
        C, m = cluster_groups.shape
        if S is not None:
            fr = self.ss.explicit.f_reduced  # (n+1,) reduced coordinate, nf = none
            S_pad = torch.nn.functional.pad(S, (0, 1, 0, 1))
            rc = fr[cluster_groups]
            return [S_pad[fr[t][:, None, :], rc[:, :, None]] for t in targets]
        if cluster_groups is not self.ss.cluster_groups:
            raise ValueError("the cluster table is not this structure's (attach_clusters)")
        ca = self.ss.cluster_slots
        out = []
        for o in self.probe(cluster_groups[ca[:, 0], ca[:, 1]], [t[ca[:, 0]] for t in targets],
                            chunk):
            full = o.new_zeros((C, m, m))
            full[ca[:, 0], ca[:, 1]] = o
            out.append(full)
        return out

    def cluster_blocks(self, cluster_groups: torch.Tensor, S=None, chunk=None) -> torch.Tensor:
        """The (C, m, m) diagonal blocks of S over the camera clusters,
        identity on the padding ([c, a, b] = S[coords_b, coords_a], the
        probe's orientation)."""
        n = self.ctx.num_tangent
        (sub,) = self._cluster_reads(cluster_groups, [cluster_groups], S, chunk)
        dummy = cluster_groups >= n
        eye = torch.eye(sub.shape[-1], dtype=sub.dtype, device=sub.device)
        return torch.where(dummy[:, :, None] | dummy[:, None, :], eye, sub)

    def clustered_preconditioner(self, cluster_groups: torch.Tensor, S=None):
        """CLUSTER_JACOBI (visibility_based_preconditioner.h:127): the
        inverse of S's block diagonal over camera clusters."""
        n = self.ctx.num_tangent
        inverses = spd_inverse(self.cluster_blocks(cluster_groups, S))
        f_mask = self.ss.f_mask

        def apply(v: torch.Tensor) -> torch.Tensor:
            v_pad = torch.cat([v, v.new_zeros((1,))])
            sol = torch.einsum("cij,cj->ci", inverses, v_pad[cluster_groups])
            out = v.new_zeros((n + 1,))
            out[cluster_groups] = sol
            return out[:n] * f_mask

        return apply

    def cluster_tridiagonal_preconditioner(self, cluster_groups: torch.Tensor,
                                           chain_clusters: torch.Tensor, S=None, chunk=None):
        """CLUSTER_TRIDIAGONAL (visibility_based_preconditioner.h:127): the
        block-tridiagonal part of S along the chains of clusters (the paths
        of the maximum-weight linear forest), factored per chain as a block
        LDL' and applied by forward and backward block-Thomas sweeps. The
        JAX package's ``lax.scan`` over a chain is a host loop over the
        levels, each a batched (K, m, m) product across the K chains.

        The tridiagonal part of an SPD matrix need not be SPD: where a
        chain's Schur complement D_k stops being SPD (non-finite inverse or a
        non-positive diagonal), that link's coupling is dropped and the
        chain restarts from its diagonal block, as in the JAX package."""
        n = self.ctx.num_tangent
        C, m = cluster_groups.shape
        K, L = chain_clusters.shape
        dev, dt = cluster_groups.device, self.dtype
        # the next cluster of each cluster along its chain (C: none)
        nxt = torch.full((C + 1,), C, dtype=torch.int64, device=dev)
        if L > 1:
            nxt[chain_clusters[:, :-1].reshape(-1)] = chain_clusters[:, 1:].reshape(-1)
        coords_pad = torch.cat([cluster_groups, cluster_groups.new_full((1, m), n)])
        diag, off = self._cluster_reads(
            cluster_groups, [cluster_groups, coords_pad[nxt[:C]]], S, chunk)
        dummy = coords_pad >= n  # (C+1, m)
        eye = torch.eye(m, dtype=dt, device=dev)
        diag = torch.where(dummy[:C, :, None] | dummy[:C, None, :], eye, diag)
        diag = torch.cat([diag, eye[None]])  # the padding cluster C: identity
        # off[c][a, b] = S[coords_nxt(c)_b, coords_c_a]: the link from c to
        # nxt(c) has B = off[c]' (zero on padding)
        off = torch.where(dummy[:C, :, None] | dummy[nxt[:C]][:, None, :], 0.0, off)
        off = torch.cat([off, off.new_zeros((1, m, m))])
        A_seq = diag[chain_clusters]  # (K, L, m, m)
        B_seq = torch.cat([A_seq.new_zeros((K, 1, m, m)),
                           off[chain_clusters[:, :-1]].transpose(-1, -2)], dim=1)

        # D_1 = A_1, W_k = B_k D_{k-1}^{-1}, D_k = A_k - W_k B_k'
        Dinv = spd_inverse(A_seq[:, 0])
        Dinvs, Ws = [Dinv], [A_seq.new_zeros((K, m, m))]
        for lvl in range(1, L):
            A, B = A_seq[:, lvl], B_seq[:, lvl]
            W = B @ Dinv
            Dk = A - W @ B.transpose(-1, -2)
            Dinv_k = spd_inverse(Dk)
            bad = ~torch.isfinite(Dinv_k).all(dim=2).all(dim=1) | (
                torch.diagonal(Dk, dim1=-2, dim2=-1) <= 0.0).any(dim=1)
            Dinv = torch.where(bad[:, None, None], spd_inverse(A), Dinv_k)
            Dinvs.append(Dinv)
            Ws.append(torch.where(bad[:, None, None], 0.0, W))
        Dinvs, Ws = torch.stack(Dinvs, dim=1), torch.stack(Ws, dim=1)  # (K, L, m, m)
        flat_coords = coords_pad[chain_clusters].reshape(-1)
        f_mask = self.ss.f_mask

        def apply(v: torch.Tensor) -> torch.Tensor:
            v_pad = torch.cat([v, v.new_zeros((1,))])
            vk = v_pad[coords_pad][chain_clusters]  # (K, L, m)
            ys = [vk[:, 0]]
            for lvl in range(1, L):  # forward: y_k = v_k - W_k y_{k-1}
                ys.append(vk[:, lvl] - torch.einsum("kij,kj->ki", Ws[:, lvl], ys[-1]))
            zs = torch.einsum("klij,klj->kli", Dinvs, torch.stack(ys, dim=1))
            xs = [zs[:, L - 1]]
            for lvl in range(L - 2, -1, -1):  # backward: x_k = z_k - W_{k+1}' x_{k+1}
                xs.append(zs[:, lvl] - torch.einsum("kji,kj->ki", Ws[:, lvl + 1], xs[-1]))
            xk = torch.stack(xs[::-1], dim=1)
            out = v.new_zeros((n + 1,))
            out[flat_coords] = xk.reshape(-1)  # every real cluster appears once
            return out[:n] * f_mask

        return apply

    def rhs(self) -> torch.Tensor:
        """Reduced rhs F'f - F'E (E'E)^{-1} E'f (implicit_schur_complement.cc:160)."""
        ctx, ss = self.ctx, self.ss
        u = self._solve_ete(self._edot(ctx.residuals))
        w2 = self._e_times(u)
        diff = tuple(a - b for a, b in zip(ctx.residuals, w2))
        return ctx.rmatvec(diff, skip=ss.e_arg) * ss.f_mask

    def rhs_from_tangent(self, r: torch.Tensor) -> torch.Tensor:
        """Reduced rhs for a tangent-space rhs r = [r_e; r_f]:
        r_f - F'E (E'E + D_e^2)^{-1} r_e (the mixed-precision refinement's
        right-hand sides)."""
        ss = self.ss
        u = self._solve_ete(self._gather_e(r))
        corr = self.ctx.rmatvec(self._e_times(u), skip=ss.e_arg)  # F'E u
        return (r - corr) * ss.f_mask

    def back_substitute(self, x_f: torch.Tensor) -> torch.Tensor:
        """Recover the e part: y_e = (E'E)^{-1} E'(f - F x_f)
        (implicit_schur_complement.cc:208)."""
        ctx, ss = self.ctx, self.ss
        x_f = x_f * ss.f_mask
        Jx = ctx.matvec(x_f, skip=ss.e_arg)
        diff = tuple(r - w for r, w in zip(ctx.residuals, Jx))
        return x_f + self._embed_e(self._owned_e(self._solve_ete(self._edot(diff))))

    def back_substitute_tangent(self, x_f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The e part for a tangent rhs r: y_e = (E'E + D_e^2)^{-1}
        (r_e - E'F x_f)."""
        ss = self.ss
        x_f = x_f * ss.f_mask
        etfx = self._edot(self.ctx.matvec(x_f, skip=ss.e_arg))
        return x_f + self._embed_e(self._owned_e(self._solve_ete(self._gather_e(r) - etfx)))

    # -- preconditioners -----------------------------------------------------

    def schur_jacobi_blocks(self) -> Dict[int, torch.Tensor]:
        """Block diagonal of S over the f blocks, damping included
        (schur_jacobi_preconditioner.h:78), without S: per instance
        F'F - W' (E'E + D_e^2)^{-1} W with W = E'F, reduced into the f
        blocks through the camera-side plans. Exact when each (e-block,
        f-block) pair shares at most one residual block (BA: one
        observation per camera-point pair)."""
        ctx, ss = self.ctx, self.ss
        Te = ss.e_tangent_size
        out = {
            T: torch.zeros((idx.shape[0], T, T), dtype=self.dtype, device=self.D.device)
            for T, idx in ss.f_groups.items()
        }
        # Zero row P: an instance whose e-slot is a constant block
        # (e_pos == num_points) contributes no correction.
        minv = self._ete_inv.reshape(-1, Te * Te)
        minv = torch.cat([minv, minv.new_zeros((1, Te * Te))], dim=0)
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if j == ea or T not in out:
                    continue
                F = ctx.jacs[fi][j]
                contrib = _pair_product(F, F)
                if ea >= 0:
                    w = _pair_product(ctx.jacs[fi][ea], F)  # (B, Te*T)
                    y = _flat_apply_minv(minv[ss.e_pos[fi]], w, Te, T)
                    contrib = contrib - flat_outer(w, y, Te, T, T)
                red = apply_reduce(ss.f_plan[fi][j], contrib)[: out[T].shape[0]]
                out[T] = out[T] + red.reshape(-1, T, T)
        if ctx.comm is not None:
            out = dict(zip(out, ctx.comm.sum_all(list(out.values()))))
        for T, idx in ss.f_groups.items():
            df = self.D[idx]
            out[T] = out[T] + torch.diag_embed(df * df)
        return out

    def schur_jacobi_preconditioner(self):
        """SCHUR_JACOBI from the implicit blocks (no S in hand)."""
        blocks = self.schur_jacobi_blocks()
        return self._block_diag_apply({T: spd_inverse(b) for T, b in blocks.items()})

    def schur_jacobi_preconditioner_from_dense(self, S: torch.Tensor):
        """SCHUR_JACOBI from the f block diagonal of a dense S (damping
        included): the blocks ARE S's diagonal cells
        (schur_jacobi_preconditioner.h:78)."""
        ss = self.ss
        fr = ss.explicit.f_reduced  # tangent coord -> reduced (nf = none)
        nf = S.shape[0]
        inverses = {}
        for T, idx in ss.f_groups.items():
            r = fr[idx]  # (G, T) reduced coords
            valid = torch.all(r < nf, dim=1)
            rc = torch.where(r < nf, r, 0)
            blocks = S[rc[:, :, None], rc[:, None, :]]
            eye = torch.eye(T, dtype=S.dtype, device=S.device)
            blocks = torch.where(valid[:, None, None], blocks, eye)
            inverses[T] = spd_inverse(blocks)
        return self._block_diag_apply(inverses)

    def _block_diag_apply(self, inverses: Dict[int, torch.Tensor]):
        """v -> the f blocks of v, each times its inverse (zero on e)."""
        ss = self.ss

        def apply(v: torch.Tensor) -> torch.Tensor:
            out = torch.zeros_like(v)
            for T, idx in ss.f_groups.items():
                out[idx.reshape(-1)] = spd_solve(inverses[T], v[idx]).reshape(-1)
            return out * ss.f_mask

        return apply

    def power_series_preconditioner(self, num_terms: int, tolerance: float = 0.0):
        """Truncated Neumann series S^{-1} ~ sum_k (I - M^{-1} S)^k M^{-1},
        M the block diagonal of S (power_series_expansion_preconditioner.h:44).
        After the leading M^{-1} v, terms are added until ``num_terms`` were
        added or the latest term's norm drops below ``tolerance`` x
        ||M^{-1} v|| (power_series_expansion_preconditioner.cc:60-84).
        ``tolerance = 0`` is the fixed count a preconditioner runs. With a
        tolerance each term runs under ``run_if`` of the last term's test: a
        device value inside a captured loop, one host read per term run
        eagerly."""
        bj = self.schur_jacobi_preconditioner()

        def apply(v: torch.Tensor) -> torch.Tensor:
            acc = bj(v)
            if tolerance <= 0:
                for _ in range(num_terms):
                    acc = acc + bj(v - self.s_times(acc))
                return acc
            threshold = tolerance * torch.linalg.norm(acc)
            going = torch.ones((), dtype=torch.bool, device=acc.device)
            for _ in range(num_terms):
                with run_if(going) as taken:
                    if not taken:
                        break
                    term = bj(v - self.s_times(acc))
                    acc.add_(term)
                    going.copy_(torch.linalg.norm(term) >= threshold)
            return acc

        return apply

    def dense_reduced_system(self):
        """(S (nf, nf), rhs (nf,), f_idx) with S assembled in one pass
        (schur_explicit.assemble_reduced_system)."""
        ss = self.ss
        S = assemble_reduced_system(self, ss.explicit)
        return S, self.rhs()[ss.f_idx], ss.f_idx


def solve_schur(ctx: JacobianContext, D: torch.Tensor, config, ss: SchurStructure,
                rhs: Optional[torch.Tensor] = None):
    """Solve min ||J y - f||^2 + ||D y||^2 by eliminating the e-blocks, or,
    with ``rhs``, (J'J + D^2) y = rhs for a tangent-space rhs. DENSE_SCHUR and
    SPARSE_SCHUR factor the assembled S (schur_complement_solver.cc; the host
    loop's SPARSE_SCHUR step is ``sparse_schur.py``'s); ITERATIVE_SCHUR
    runs PCG (iterative_schur_complement_solver.cc:64-155) on the assembled
    S when the reduced system is small or ``use_explicit_schur_complement``
    asks for it, else on the implicit S x. Returns (y, linear_iterations,
    termination) with linear/cg.py codes."""
    lst = config.linear_solver_type
    op = SchurOperator(ctx, D, ss)
    nt = ctx.num_tangent
    f_idx = ss.f_idx

    def back_substitute(x_f):
        if rhs is None:
            return op.back_substitute(x_f)
        return op.back_substitute_tangent(x_f, rhs)

    def reduced_rhs():
        return op.rhs() if rhs is None else op.rhs_from_tangent(rhs)

    if lst in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR):
        # Cholesky of S as assembled (its lower triangle; no symmetrizing,
        # as in the JAX package). An indefinite S gives a non-finite step
        # and FAILURE, which the LM loop answers by shrinking the radius.
        S = assemble_reduced_system(op, ss.explicit)
        chol, info = torch.linalg.cholesky_ex(S)
        xf_red = torch.cholesky_solve(reduced_rhs()[f_idx][:, None], chol)[:, 0]
        xf_red = torch.where(info == 0, xf_red, torch.nan)
        x_f = torch.zeros((nt,), dtype=op.dtype, device=D.device)
        x_f[f_idx] = xf_red
        y = back_substitute(x_f)
        one = torch.ones((), dtype=torch.int32, device=D.device)
        return y, one, direct_termination(y)

    # The explicit-S policy: the user's flag, or a small reduced system
    # whose assembly plan is in hand (a structure shared with DENSE_SCHUR
    # carries one at any nf).
    S = None
    if config.use_explicit_schur_complement or (
        ss.explicit is not None and int(f_idx.shape[0]) <= EXPLICIT_S_AUTO_MAX_NF
    ):
        S = assemble_reduced_system(op, ss.explicit)
        # S is symmetric in exact arithmetic; the assembled f32 matrix is
        # not exactly so (independent lower/upper accumulation orders), and
        # CG on the raw matrix produces steps with model_cost_change <= 0
        # near the optimum. Symmetrize once. (The implicit S x is run
        # unsymmetrized, as in the JAX package.)
        S = 0.5 * (S + S.T)

    pt = config.preconditioner_type
    if pt in (PreconditionerType.SCHUR_JACOBI, PreconditionerType.JACOBI):
        if S is not None:
            M = op.schur_jacobi_preconditioner_from_dense(S)
        else:
            M = op.schur_jacobi_preconditioner()
    elif pt == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION:
        # As a preconditioner the series runs a fixed term count, so that M
        # is the same linear operator in every CG iteration
        # (iterative_schur_complement_solver.cc:179-183); spse_tolerance
        # belongs to the initialization below. It runs the implicit S x even
        # when S is assembled, as the JAX package does.
        M = op.power_series_preconditioner(config.max_num_spse_iterations, 0.0)
    elif pt in (PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL):
        # The blocks from S when it is assembled, else from probes of the
        # implicit S. Without clusters (no observation joins an f and an e
        # block) SCHUR_JACOBI, and without chains CLUSTER_JACOBI, as in the
        # JAX package.
        if ss.cluster_groups is None:
            M = op.schur_jacobi_preconditioner()
        elif pt == PreconditionerType.CLUSTER_TRIDIAGONAL and ss.chain_clusters is not None:
            M = op.cluster_tridiagonal_preconditioner(ss.cluster_groups, ss.chain_clusters, S)
        else:
            M = op.clustered_preconditioner(ss.cluster_groups, S)
    else:  # IDENTITY
        M = None

    b = reduced_rhs()
    x0 = None
    if config.use_spse_initialization:
        # Power-series initial guess (iterative_schur_complement_solver.cc:101-111).
        x0 = op.power_series_preconditioner(
            config.max_num_spse_iterations, config.spse_tolerance
        )(b)

    s_apply = op.s_times
    if S is not None:

        def s_apply(v):
            out = torch.zeros((nt,), dtype=v.dtype, device=v.device)
            out[f_idx] = S @ v[f_idx]
            return out

    res = conjugate_gradients(
        s_apply,
        b,
        preconditioner=M,
        x0=x0,
        max_num_iterations=config.max_linear_solver_iterations,
        min_num_iterations=config.min_linear_solver_iterations,
        q_tolerance=config.eta,
        r_tolerance=-1.0,
    )
    return back_substitute(res.x), res.num_iterations, res.termination
