"""Schur-complement solve for bundle adjustment (port of the main-path
subset of ``ceres_tpu/linear/schur.py``).

The e-blocks (points) are found by a greedy maximal independent set
(parameter_block_ordering.h:74-82) and eliminated:

    S x = (F'F + D_f^2) x - F'E (E'E + D_e^2)^{-1} E'F x

Two solves run on an explicitly assembled S (``schur_explicit.py``):
ITERATIVE_SCHUR with SCHUR_JACOBI (nf <= EXPLICIT_S_AUTO_MAX_NF) and
DENSE_SCHUR (a Cholesky factorization of S). ``SchurOperator.s_times`` (the
implicit product) is ported and tested; the implicit-S solve, SPARSE_SCHUR
and the other preconditioners are ROADMAP items.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.evaluator import JacobianContext
from ceres_tpu_torch.linear.cg import conjugate_gradients, direct_termination
from ceres_tpu_torch.linear.schur_explicit import _pair_product, assemble_reduced_system
from ceres_tpu_torch.ops.reduce import apply_reduce, build_reduce_plan
from ceres_tpu_torch.ops.small_linalg import spd_inverse, spd_solve
from ceres_tpu_torch.types import LinearSolverType, PreconditionerType

# Below this many f coordinates ITERATIVE_SCHUR materializes S once per
# linear solve and runs CG on the dense matrix (the JAX package's policy).
EXPLICIT_S_AUTO_MAX_NF = 2048

_OTHER_SOLVERS = "ROADMAP Queue 1 item 14 (other linear solvers and preconditioners)"


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
    e_plan: Tuple  # per family: point-side reduce plan
    e_slice: Optional[int]  # start when e coords are one ascending range
    # host copies of e_pos and of the per family/arg f block positions
    # (schur_explicit.build_explicit_plan reads them)
    host_e_pos: Tuple[Optional[np.ndarray], ...]
    host_f_pos: Tuple[Tuple[Optional[np.ndarray], ...], ...]
    explicit: Optional[object] = None  # schur_explicit.ExplicitSchurPlan


def build_schur_structure(program) -> SchurStructure:
    """Build the elimination structure on the program's device (the
    explicit-S plan is attached by the caller when S is to be assembled)."""
    dev = program.device
    e_pids = np.asarray(compute_schur_ordering(program), dtype=np.int64)
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
        e_plan=e_plan,
        e_slice=e_slice,
        host_e_pos=tuple(e_pos),
        host_f_pos=tuple(f_pos),
    )


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
        self._ete_inv = spd_inverse(ete)

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

    def rhs(self) -> torch.Tensor:
        """Reduced rhs F'f - F'E (E'E)^{-1} E'f (implicit_schur_complement.cc:160)."""
        ctx, ss = self.ctx, self.ss
        u = self._solve_ete(self._edot(ctx.residuals))
        w2 = self._e_times(u)
        diff = tuple(a - b for a, b in zip(ctx.residuals, w2))
        return ctx.rmatvec(diff, skip=ss.e_arg) * ss.f_mask

    def back_substitute(self, x_f: torch.Tensor) -> torch.Tensor:
        """Recover the e part: y_e = (E'E)^{-1} E'(f - F x_f)
        (implicit_schur_complement.cc:208)."""
        ctx, ss = self.ctx, self.ss
        x_f = x_f * ss.f_mask
        Jx = ctx.matvec(x_f, skip=ss.e_arg)
        diff = tuple(r - w for r, w in zip(ctx.residuals, Jx))
        return x_f + self._embed_e(self._solve_ete(self._edot(diff)))

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

        def apply(v: torch.Tensor) -> torch.Tensor:
            out = torch.zeros_like(v)
            for T, idx in ss.f_groups.items():
                out[idx.reshape(-1)] = spd_solve(inverses[T], v[idx]).reshape(-1)
            return out * ss.f_mask

        return apply

    def dense_reduced_system(self):
        """(S (nf, nf), rhs (nf,), f_idx) with S assembled in one pass
        (schur_explicit.assemble_reduced_system)."""
        ss = self.ss
        S = assemble_reduced_system(self, ss.explicit)
        return S, self.rhs()[ss.f_idx], ss.f_idx


def solve_schur(ctx: JacobianContext, D: torch.Tensor, config, ss: SchurStructure):
    """Solve min ||J y - f||^2 + ||D y||^2 by eliminating the e-blocks.
    DENSE_SCHUR factors the assembled S (schur_complement_solver.cc);
    ITERATIVE_SCHUR runs PCG on it
    (iterative_schur_complement_solver.cc:64-155 with an explicit S).
    Returns (y, linear_iterations, termination) with linear/cg.py codes."""
    lst = config.linear_solver_type
    if lst not in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
        raise NotImplementedError(f"{lst.name}: {_OTHER_SOLVERS}")
    if (
        lst == LinearSolverType.ITERATIVE_SCHUR
        and config.preconditioner_type != PreconditionerType.SCHUR_JACOBI
    ):
        raise NotImplementedError(
            f"preconditioner {config.preconditioner_type.name}: {_OTHER_SOLVERS}"
        )
    if ss.explicit is None:
        raise NotImplementedError(
            f"ITERATIVE_SCHUR with nf > {EXPLICIT_S_AUTO_MAX_NF} (implicit S "
            f"and its SCHUR_JACOBI blocks): {_OTHER_SOLVERS}"
        )
    op = SchurOperator(ctx, D, ss)
    nt = ctx.num_tangent
    f_idx = ss.f_idx

    if lst == LinearSolverType.DENSE_SCHUR:
        # Cholesky of S as assembled (its lower triangle; no symmetrizing,
        # as in the JAX package). An indefinite S gives a non-finite step
        # and FAILURE, which the LM loop answers by shrinking the radius.
        S, rhs_red, _ = op.dense_reduced_system()
        chol, info = torch.linalg.cholesky_ex(S)
        xf_red = torch.cholesky_solve(rhs_red[:, None], chol)[:, 0]
        xf_red = torch.where(info == 0, xf_red, torch.nan)
        x_f = torch.zeros((nt,), dtype=op.dtype, device=D.device)
        x_f[f_idx] = xf_red
        y = op.back_substitute(x_f)
        one = torch.ones((), dtype=torch.int32, device=D.device)
        return y, one, direct_termination(y)

    S = assemble_reduced_system(op, ss.explicit)
    # S is symmetric in exact arithmetic; the assembled f32 matrix is not
    # exactly so (independent lower/upper accumulation orders), and CG on
    # the raw matrix produces steps with model_cost_change <= 0 near the
    # optimum. Symmetrize once.
    S = 0.5 * (S + S.T)
    M = op.schur_jacobi_preconditioner_from_dense(S)

    def s_apply(v):
        out = torch.zeros((nt,), dtype=v.dtype, device=v.device)
        out[f_idx] = S @ v[f_idx]
        return out

    res = conjugate_gradients(
        s_apply,
        op.rhs(),
        preconditioner=M,
        max_num_iterations=config.max_linear_solver_iterations,
        min_num_iterations=config.min_linear_solver_iterations,
        q_tolerance=config.eta,
        r_tolerance=-1.0,
    )
    return op.back_substitute(res.x), res.num_iterations, res.termination
