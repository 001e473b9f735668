"""One-pass explicit Schur-complement assembly (port of
``ceres_tpu/linear/schur_explicit.py``).

The reduced camera system

    S = F'F + D_f^2 - W' (E'E + D_e^2)^{-1} W,      W = E'F

is assembled in one pass over the residual blocks (the math of
schur_eliminator.h:108-152): the F'F term reduces per-instance products
F_i' F_j into camera-pair cells, and the correction term enumerates, per
point, the pairs of its observations and reduces ``-W_a' M_p^{-1} W_b``
into camera-pair cells. The pair and cell structure is built once on the
host from the visibility pattern; the device work is batched einsums plus
segment reductions (``ops/reduce.py``), and for cell-sorted correction
pairs the fused pair-outer kernel (``ops/outer_segment_sum.py``).

Left out from the JAX package, as devices of the TPU: the MXU
selection-matmul forms of the flat contractions (einsum here), the
scatter-free grid placement (``index_put_`` here), and the uniform-window
host fast path (the pair enumeration below is vectorized numpy for every
visibility pattern).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.ops.outer_segment_sum import (
    flat_outer,
    outer_segment_sum,
    pair_rows_int32,
)
from ceres_tpu_torch.ops.reduce import ReducePlan, apply_reduce, build_reduce_plan


@dataclasses.dataclass
class FtFSite:
    """F'F cell reduction for one (family, oriented arg pair, kind).
    ``perm`` (cell-sorted rows) is None when the plan consumes the
    instances in natural order. ``sym``: diagonal cells receive both
    (j1, j2) and (j2, j1), so the transposed block is added."""

    fi: int
    jA: int
    jB: int
    diagonal: bool
    sym: bool
    perm: Optional[torch.Tensor]
    plan: ReducePlan
    rows: torch.Tensor  # (C, T1) reduced row coords
    cols: torch.Tensor  # (C, T2)


@dataclasses.dataclass
class PairGroup:
    """Correction-term cells for one (T1, T2, diagonal) group: flat
    cell-sorted pair lists into the W slot spaces of f sizes T1 / T2 (pad
    index = the zero row N). Strict-lower cells are mirrored into the upper
    triangle by the assembler. ``self_pairs``: a_idx == b_idx, T1 == T2;
    ``natural``: the plan reduces the slot-order products directly."""

    T1: int
    T2: int
    diagonal: bool
    num_cells: int
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    plan: ReducePlan
    rows: torch.Tensor  # (C, T1)
    cols: torch.Tensor  # (C, T2)
    self_pairs: bool = False
    natural: bool = False


@dataclasses.dataclass
class ExplicitSchurPlan:
    nf: int
    # W slot spaces: per f tangent size, the (fi, j) args concatenated.
    slot_args: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]
    ftf: Tuple[FtFSite, ...]
    corr: Tuple[PairGroup, ...]
    f_reduced: torch.Tensor  # (num_tangent+1,) tangent -> reduced coord (nf = none)


def _cells(pa: np.ndarray, pb: np.ndarray, n2: int):
    """Unique (pa, pb) cells: per-item cell ids and the cells' (pa, pb)."""
    uniq, ids = np.unique(pa * n2 + pb, return_inverse=True)
    return ids.reshape(-1), uniq // n2, uniq % n2


def build_explicit_plan(program, ss, host_only: bool = False) -> ExplicitSchurPlan:
    """Host-side construction of the one-pass assembly plan. ``host_only``:
    the cells alone, on the CPU, without reduce plans or pair lists (the
    whole program's layout of a sharded SPARSE_SCHUR,
    ``sparse_schur.sparse_schur_assembly``)."""
    dev = torch.device("cpu") if host_only else program.device
    families = program.families
    f_idx = ss.f_idx.cpu().numpy()
    nf = f_idx.shape[0]
    f_reduced = np.full(program.num_tangent + 1, nf, dtype=np.int64)
    f_reduced[f_idx] = np.arange(nf)
    f_groups = {T: g.cpu().numpy() for T, g in ss.f_groups.items()}

    def coords(T, pos):  # (n,) block positions -> (n, T) reduced coords
        if T not in f_groups:  # every block of size T is constant: no position
            return np.zeros((0, T), dtype=np.int64)
        return f_reduced[f_groups[T][pos]]

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- F'F sites ---------------------------------------------------------
    ftf: List[FtFSite] = []
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        f_args = [j for j in range(fam.num_args) if j != ea]
        B = fam.batch
        for a_i, j1 in enumerate(f_args):
            for j2 in f_args[a_i:]:
                T1 = fam.structure.tangent_sizes[j1]
                T2 = fam.structure.tangent_sizes[j2]
                p1 = ss.host_f_pos[fi][j1]
                p2 = ss.host_f_pos[fi][j2]
                G1 = f_groups[T1].shape[0] if T1 in f_groups else 0
                G2 = f_groups[T2].shape[0] if T2 in f_groups else 0
                vidx = np.nonzero((p1 < G1) & (p2 < G2))[0]
                s1 = coords(T1, p1[vidx])[:, 0]
                s2 = coords(T2, p2[vidx])[:, 0]
                kinds = np.full(B, -1, dtype=np.int8)
                kinds[vidx] = np.where(s1 == s2, 0, np.where(s1 > s2, 1, 2))
                # kind 0: diagonal cell; 1: strict lower; 2: transposed,
                # F_j2' F_j1 at the swapped (strict lower) cell.
                for kind, jA, jB, pA, pB, TA, TB, diagonal, sym in (
                    (0, j1, j2, p1, p2, T1, T2, True, j1 != j2),
                    (1, j1, j2, p1, p2, T1, T2, False, False),
                    (2, j2, j1, p2, p1, T2, T1, False, False),
                ):
                    sel = np.nonzero(kinds == kind)[0]
                    if sel.size == 0:
                        continue
                    ids, ca, cb = _cells(pA[sel], pB[sel], f_groups[TB].shape[0])
                    C = ca.shape[0]
                    perm, plan = None, None
                    if not host_only and sel.size == B:
                        # Natural instance order when the plan kind does
                        # not need sorted ids (skips a row gather).
                        plan0 = build_reduce_plan(ids, C, dev)
                        if plan0.kind != "scatter":
                            plan = plan0
                    if not host_only and plan is None:
                        order = np.argsort(ids, kind="stable")
                        perm = to_dev(sel[order])
                        plan = build_reduce_plan(ids[order], C, dev)
                    ftf.append(
                        FtFSite(
                            fi=fi, jA=jA, jB=jB, diagonal=diagonal, sym=sym,
                            perm=perm, plan=plan,
                            rows=to_dev(coords(TA, ca)), cols=to_dev(coords(TB, cb)),
                        )
                    )

    # ---- W slot spaces -----------------------------------------------------
    slot_args: Dict[int, List[Tuple[int, int]]] = {}
    slot_offset: Dict[Tuple[int, int], int] = {}
    slot_count: Dict[int, int] = {}
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        if ea < 0:
            continue
        for j in range(fam.num_args):
            if j == ea:
                continue
            T = fam.structure.tangent_sizes[j]
            slot_offset[(fi, j)] = slot_count.get(T, 0)
            slot_count[T] = slot_count.get(T, 0) + fam.batch
            slot_args.setdefault(T, []).append((fi, j))

    # Every observing slot: (point, T, slot, block position, block start),
    # in the (family, arg, instance) order of the JAX package's per-point
    # lists.
    P = ss.num_points
    obs_pt, obs_T, obs_slot, obs_pos, obs_start = [], [], [], [], []
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        if ea < 0:
            continue
        epos = ss.host_e_pos[fi]
        for j in range(fam.num_args):
            if j == ea:
                continue
            T = fam.structure.tangent_sizes[j]
            G = f_groups[T].shape[0] if T in f_groups else 0
            fpos = ss.host_f_pos[fi][j]
            ok = np.nonzero((epos < P) & (fpos < G))[0]
            obs_pt.append(epos[ok])
            obs_T.append(np.full(ok.size, T, dtype=np.int64))
            obs_slot.append(slot_offset[(fi, j)] + ok)
            obs_pos.append(fpos[ok])
            obs_start.append(coords(T, fpos[ok])[:, 0])
    corr: List[PairGroup] = []
    if obs_pt:
        pt, oT, slot, pos, start = (
            np.concatenate(a) for a in (obs_pt, obs_T, obs_slot, obs_pos, obs_start)
        )
        # All ordered pairs (a, b) of observations of one point, a-major
        # (the reference's chunk outer product, schur_eliminator_impl.h).
        order = np.argsort(pt, kind="stable")
        pt_s = pt[order]
        first = np.searchsorted(pt_s, np.arange(P + 1))
        n_of = (first[1:] - first[:-1])[pt_s]
        ia = np.repeat(np.arange(pt_s.size), n_of)
        ib = first[pt_s[ia]] + (
            np.arange(ia.size) - np.repeat(np.cumsum(n_of) - n_of, n_of)
        )
        a, b = order[ia], order[ib]
        same = (oT[a] == oT[b]) & (pos[a] == pos[b])
        lower = ~same & (start[a] > start[b])
        tmax = int(oT.max()) + 1
        for code in np.unique(oT[a] * tmax + oT[b]):
            T1, T2 = int(code) // tmax, int(code) % tmax
            for diagonal, keep in ((True, same), (False, lower)):
                m = keep & (oT[a] == T1) & (oT[b] == T2)
                if not m.any():
                    continue
                corr.append(
                    _pair_group(
                        T1, T2, diagonal, slot[a[m]], slot[b[m]], pos[a[m]],
                        pos[b[m]], slot_count, f_groups, coords, to_dev, dev, host_only,
                    )
                )

    return ExplicitSchurPlan(
        nf=nf,
        slot_args=tuple((T, tuple(args)) for T, args in sorted(slot_args.items())),
        ftf=tuple(ftf),
        corr=tuple(corr),
        f_reduced=to_dev(f_reduced),
    )


def _pair_group(T1, T2, diagonal, sa, sb, pa, pb, slot_count, f_groups, coords,
                to_dev, dev, host_only: bool = False) -> PairGroup:
    ids, ca, cb = _cells(pa, pb, f_groups[T2].shape[0])
    C = ca.shape[0]
    rows, cols = to_dev(coords(T1, ca)), to_dev(coords(T2, cb))
    if host_only:
        return PairGroup(T1=T1, T2=T2, diagonal=diagonal, num_cells=C, a_idx=None,
                         b_idx=None, plan=None, rows=rows, cols=cols)
    # Self-pair mode: every slot appears exactly once as its own partner
    # -> reduce the slot-order outer products with per-slot cell ids (the
    # pad row N goes to the dummy cell), no gather.
    if (
        T1 == T2
        and np.array_equal(sa, sb)
        and sa.shape[0] == slot_count.get(T1, -1)
        and np.array_equal(np.sort(sa), np.arange(sa.shape[0]))
    ):
        seg_nat = np.full(sa.shape[0] + 1, C, dtype=np.int64)
        seg_nat[sa] = ids
        plan0 = build_reduce_plan(seg_nat, C, dev)
        if plan0.kind != "scatter":
            empty = torch.zeros((0,), dtype=torch.int64, device=dev)
            return PairGroup(
                T1=T1, T2=T2, diagonal=diagonal, num_cells=C, a_idx=empty,
                b_idx=empty, plan=plan0, rows=rows, cols=cols,
                self_pairs=True, natural=True,
            )
    order = np.argsort(ids, kind="stable")
    a_idx, b_idx = sa[order], sb[order]
    plan = build_reduce_plan(ids[order], C, dev)
    self_pairs = bool(T1 == T2 and np.array_equal(a_idx, b_idx))
    if plan.kind == "sorted" and not self_pairs:
        # The fused kernel reads the pair lists itself, as int32.
        a_idx, b_idx = pair_rows_int32(a_idx), pair_rows_int32(b_idx)
    return PairGroup(
        T1=T1, T2=T2, diagonal=diagonal, num_cells=C, a_idx=to_dev(a_idx),
        b_idx=to_dev(b_idx), plan=plan, rows=rows, cols=cols,
        self_pairs=self_pairs,
    )


def _pair_product(E: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Flat ``w[b, e*T+t] = sum_r E[b,r,e] F[b,r,t]``."""
    return torch.einsum("bre,brt->bet", E, F).reshape(E.shape[0], -1)


def _flat_apply_minv(minv: torch.Tensor, w: torch.Tensor, Te: int, T: int):
    """Flat ``y[b, e*T+t] = sum_f minv[b, e*Te+f] * w[b, f*T+t]``."""
    B = w.shape[0]
    return torch.einsum(
        "bef,bft->bet", minv.reshape(B, Te, Te), w.reshape(B, Te, T)
    ).reshape(B, Te * T)


def compute_cell_blocks(op, plan: ExplicitSchurPlan):
    """Every reduced cell block of S (without damping) in one pass.
    Returns [(site, blocks)] with site an FtFSite or PairGroup and blocks
    its FLAT (C, T1*T2) values."""
    ctx, ss = op.ctx, op.ss
    Te = ss.e_tangent_size
    out = []
    for s in plan.ftf:
        FA, FB = ctx.jacs[s.fi][s.jA], ctx.jacs[s.fi][s.jB]
        T1, T2 = FA.shape[2], FB.shape[2]
        C = s.rows.shape[0]
        X = _pair_product(FA, FB)
        if s.perm is not None:
            X = X[s.perm]
        blocks = apply_reduce(s.plan, X)[:C]
        if s.sym:
            b3 = blocks.reshape(C, T1, T2)
            blocks = (b3 + b3.transpose(1, 2)).reshape(C, T1 * T2)
        out.append((s, blocks))

    # (E'E + D_e^2)^{-1} per point, flat, with a zero dummy row.
    minv = op._ete_inv.reshape(-1, Te * Te)
    minv = torch.cat([minv, minv.new_zeros((1, Te * Te))], dim=0)
    W: Dict[int, torch.Tensor] = {}
    Y: Dict[int, torch.Tensor] = {}
    for T, args in plan.slot_args:
        ws, ys = [], []
        for fi, j in args:
            E = ctx.jacs[fi][ss.e_arg[fi]]
            w = _pair_product(E, ctx.jacs[fi][j])  # (B, Te*T)
            ws.append(w)
            ys.append(_flat_apply_minv(minv[ss.e_pos[fi]], w, Te, T))
        pad = ws[0].new_zeros((1, Te * T))
        W[T] = torch.cat(ws + [pad], dim=0)
        Y[T] = torch.cat(ys + [pad], dim=0)

    for g in plan.corr:
        if g.self_pairs:
            nat = flat_outer(W[g.T1], Y[g.T1], Te, g.T1, g.T1)
            red = apply_reduce(g.plan, nat if g.natural else nat[g.a_idx])
        elif g.plan.kind == "sorted":
            # Fused: the kernel gathers the operand rows and reduces the
            # outer products into the cells without writing either.
            red = outer_segment_sum(
                W[g.T1], Y[g.T2], g.a_idx, g.b_idx, g.plan.row_ptr,
                g.num_cells, Te, g.T1, g.T2,
            )
        else:
            red = apply_reduce(
                g.plan,
                flat_outer(W[g.T1][g.a_idx], Y[g.T2][g.b_idx], Te, g.T1, g.T2),
            )
        out.append((g, -red[: g.num_cells]))
    return out


def assemble_reduced_system(op, plan: ExplicitSchurPlan) -> torch.Tensor:
    """The dense reduced system S (nf, nf), damping included. ``op`` is a
    SchurOperator (Jacobians, (E'E + D_e^2)^{-1} and the damping D)."""
    nf = plan.nf
    dev = op.D.device
    S_d = torch.zeros((nf, nf), dtype=op.dtype, device=dev)  # diagonal cells
    S_l = torch.zeros((nf, nf), dtype=op.dtype, device=dev)  # strict lower cells
    for site, blocks in compute_cell_blocks(op, plan):
        C, T1, T2 = site.rows.shape[0], site.rows.shape[1], site.cols.shape[1]
        target = S_d if site.diagonal else S_l
        target.index_put_(
            (site.rows[:, :, None], site.cols[:, None, :]),
            blocks.reshape(C, T1, T2),
            accumulate=True,
        )
    S = S_d + S_l + S_l.T
    if op.ctx.comm is not None:
        S = op.ctx.comm.sum(S)  # each rank's cells, from its rows
    df = op.D[op.ss.f_idx]
    return S + torch.diag((df * df).to(op.dtype))
