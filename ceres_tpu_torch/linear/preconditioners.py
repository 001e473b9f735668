"""Preconditioners for the iterative solvers (port of
``ceres_tpu/linear/preconditioners.py``; the reference's
``internal/ceres/preconditioner.h:51``, ``block_jacobi_preconditioner.{h,cc}``,
``subset_preconditioner.h``).

The block-Jacobi preconditioner inverts the block diagonal of J'J + D'D:
blocks are grouped by tangent size into (G, T, T) batches and inverted in
closed form per size group, so applying it is one einsum per group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ceres_tpu_torch.evaluator import JacobianContext, _group_rows, tangent_idx
from ceres_tpu_torch.ops.segment_sum import build_row_ptr, segment_sum_sorted
from ceres_tpu_torch.ops.small_linalg import cholesky_solve, spd_inverse
from ceres_tpu_torch.problem import BlockGroups


def identity_preconditioner() -> Callable[[torch.Tensor], torch.Tensor]:
    """preconditioner.h IdentityPreconditioner."""
    return lambda v: v


def scalar_jacobi_preconditioner(
    ctx: JacobianContext, D: Optional[torch.Tensor] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """M = diag(J'J + D'D)^-1."""
    d = ctx.squared_column_norms()
    if D is not None:
        d = d + D * D
    inv = 1.0 / torch.clamp(d, min=1e-300)
    return lambda v: inv * v


def block_jacobi_preconditioner(
    ctx: JacobianContext, bd_groups: BlockGroups, D: Optional[torch.Tensor] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """M = blockdiag(J'J + D'D)^-1 (block_jacobi_preconditioner.h:55).
    ``bd_groups`` maps tangent size T -> (G_T, T) tangent coordinates
    (``Program.groups``)."""
    blocks = ctx.block_jtj({T: idx.shape[0] for T, idx in bd_groups.items()})
    inverses = {}
    for T, _ in bd_groups.items():
        mat = blocks[T]
        if D is not None:
            Db = _group_rows(bd_groups, D, T)
            mat = mat + torch.diag_embed(Db * Db)
        inverses[T] = spd_inverse(mat)

    def apply(v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(v)
        for T, idx in bd_groups.items():
            sol = torch.einsum("gij,gj->gi", inverses[T], _group_rows(bd_groups, v, T))
            sl = bd_groups.slice_of(T)
            if sl is not None:
                start, G = sl
                out[start : start + G * T] = sol.reshape(G * T).to(out.dtype)
            else:
                out[idx] = sol.to(out.dtype)
        return out

    return apply


@dataclasses.dataclass
class SubsetPlan:
    """The SUBSET preconditioner's J'J cells as a fixed-order sum, built
    once on the host: the per-instance products of :func:`subset_preconditioner`
    flattened in the JAX package's scatter order (family, arg pair,
    instance, row, column), the ones that land in a cell of J'J (not on the
    dummy coordinate) stably sorted by cell, and summed per cell by K1
    (``ops/segment_sum.py``) in that order: the sums of the JAX package's
    ``.at[].add``, the same bits on every run, no atomics."""

    perm: torch.Tensor  # (N,) int64: the contributions, cell by cell
    row_ptr: torch.Tensor  # (U+2,) int32: the CSR row pointer of the U cells
    cells: torch.Tensor  # (U,) int64: each cell's flat index i * n + j


def build_subset_plan(families, groups: BlockGroups, num_tangent: int, subset_masks) -> SubsetPlan:
    """The :class:`SubsetPlan` of a program's families (``subset_masks`` as
    :func:`subset_preconditioner` takes them), on the families' device."""
    n = num_tangent
    cells = []
    for fi, fam in enumerate(families):
        if subset_masks[fi] is None:
            continue
        idx = [tangent_idx(fam, j, groups, n).cpu().numpy() for j in range(fam.num_args)]
        for tj in idx:
            for tk in idx:
                c = tj[:, :, None] * n + tk[:, None, :]
                c = np.where((tj[:, :, None] < n) & (tk[:, None, :] < n), c, -1).reshape(-1)
                cells.append(c)
    flat = np.concatenate(cells)
    kept = np.nonzero(flat >= 0)[0]
    perm = kept[np.argsort(flat[kept], kind="stable")]
    unique, seg = np.unique(flat[perm], return_inverse=True)
    dev = families[0].bd_pos[0].device
    return SubsetPlan(
        perm=torch.from_numpy(perm).to(dev),
        row_ptr=torch.from_numpy(build_row_ptr(seg, unique.size)).to(dev),
        cells=torch.from_numpy(unique).to(dev),
    )


def subset_preconditioner(
    ctx: JacobianContext, subset_masks, D: Optional[torch.Tensor] = None,
    plan: Optional[SubsetPlan] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """M = (J_subset' J_subset + D'D)^-1 for a user-chosen subset of
    residual rows (subset_preconditioner.h:44-80). ``subset_masks`` is a
    per-family (B,) 0/1 tensor selecting member instances (None: none of the
    family). One dense assembly and one dense Cholesky, where the reference
    factors the subset normal matrix with sparse Cholesky: small problems
    only. The assembly sums the masked per-instance products J_j' J_k into
    the cells of J'J through ``plan`` (:func:`build_subset_plan`, built here
    when not given); the solve is two triangular solves. Every operation is
    device work of fixed shape, so a CUDA graph captures it."""
    if plan is None:
        plan = build_subset_plan(ctx.families, ctx.groups, ctx.num_tangent, subset_masks)
    n = ctx.num_tangent
    dt = ctx.dtype
    contribs = []
    for fi, fam in enumerate(ctx.families):
        m = subset_masks[fi]
        if m is None:
            continue
        for j in range(fam.num_args):
            Jm_j = ctx.jacs[fi][j] * m.to(dt)[:, None, None]
            for k in range(fam.num_args):
                contribs.append(torch.einsum("bri,brj->bij", Jm_j, ctx.jacs[fi][k]).reshape(-1))
    U = plan.cells.shape[0]
    vals = torch.cat(contribs)[plan.perm]
    sums = segment_sum_sorted(vals[:, None], plan.row_ptr, U)[:U, 0]
    H = torch.zeros((n * n,), dtype=dt, device=ctx.residuals[0].device)
    H = H.index_copy_(0, plan.cells, sums).reshape(n, n)
    if ctx.comm is not None:
        H = ctx.comm.sum(H)  # this rank's subset rows
    if D is not None:
        H = H + torch.diag(D * D)
    chol = torch.linalg.cholesky_ex(H)[0]

    def apply(v: torch.Tensor) -> torch.Tensor:
        return cholesky_solve(chol, v[:, None])[:, 0]

    return apply
