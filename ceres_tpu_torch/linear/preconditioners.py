"""Preconditioners for the iterative solvers (port of
``ceres_tpu/linear/preconditioners.py``; the reference's
``internal/ceres/preconditioner.h:51``, ``block_jacobi_preconditioner.{h,cc}``,
``subset_preconditioner.h``).

The block-Jacobi preconditioner inverts the block diagonal of J'J + D'D:
blocks are grouped by tangent size into (G, T, T) batches and inverted in
closed form per size group, so applying it is one einsum per group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ceres_tpu_torch.evaluator import JacobianContext, _group_rows
from ceres_tpu_torch.ops.small_linalg import spd_inverse
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


def subset_preconditioner(
    ctx: JacobianContext, subset_masks, D: Optional[torch.Tensor] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """M = (J_subset' J_subset + D'D)^-1 for a user-chosen subset of
    residual rows (subset_preconditioner.h:44-80). ``subset_masks`` is a
    per-family (B,) 0/1 tensor selecting member instances (None: none of the
    family). One dense assembly and one dense Cholesky, where the reference
    factors the subset normal matrix with sparse Cholesky: small problems
    only."""
    n = ctx.num_tangent
    dt = ctx.dtype
    H = torch.zeros((n + 1, n + 1), dtype=dt, device=ctx.residuals[0].device)
    for fi, fam in enumerate(ctx.families):
        m = subset_masks[fi]
        if m is None:
            continue
        for j in range(fam.num_args):
            Jm_j = ctx.jacs[fi][j] * m.to(dt)[:, None, None]
            tj = ctx.tangent_idx(fi, j)
            for k in range(fam.num_args):
                contrib = torch.einsum("bri,brj->bij", Jm_j, ctx.jacs[fi][k])
                tk = ctx.tangent_idx(fi, k)
                H.index_put_((tj[:, :, None], tk[:, None, :]), contrib, accumulate=True)
    H = H[:n, :n]
    if ctx.comm is not None:
        H = ctx.comm.sum(H)  # this rank's subset rows
    if D is not None:
        H = H + torch.diag(D * D)
    chol = torch.linalg.cholesky_ex(H)[0]

    def apply(v: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(v[:, None], chol)[:, 0]

    return apply
