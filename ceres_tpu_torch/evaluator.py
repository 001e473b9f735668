"""Batched residual/Jacobian evaluation (port of ``ceres_tpu/evaluator.py``).

Each residual family is evaluated with one ``torch.func.vmap(jacfwd(fn))``
call over its B instances: forward-mode AD gives the per-instance Jacobian
blocks (B, r, T_j) of every argument. The Jacobian is never assembled
globally: it stays as these per-family blocks (the BlockSparseMatrix
analog), and every product with it reduces per-observation contributions
into per-block rows through the family's reduce plans (``ops/reduce.py``;
on CUDA the point-side ones run the sorted-segment-sum kernel and, from a
few hundred cameras on, the camera-side ones the unsorted one).

Only the trivial loss is in this slice (``problem.py`` rejects others), so
the corrected residuals are the raw residuals.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch.func import jacfwd, vmap

from ceres_tpu_torch.ops.reduce import apply_reduce
from ceres_tpu_torch.problem import BlockGroups, Family


def _group_rows(groups: BlockGroups, v: torch.Tensor, T: int) -> torch.Tensor:
    """(G_T, T) view of size group T's coordinates of the flat vector v
    (a free view when they are one contiguous range)."""
    sl = groups.slice_of(T)
    if sl is not None:
        start, G = sl
        return v[start : start + G * T].view(G, T)
    return v[groups[T]]


def _gather_blocks(family: Family, x: torch.Tensor, groups: BlockGroups):
    """Per-instance parameter blocks (B, A_j) per arg: the size group's
    (G, A) table of x and one row gather."""
    return tuple(
        _group_rows(groups, x, A)[family.bd_pos[j]]
        for j, A in enumerate(family.structure.block_sizes)
    )


def family_residuals(family: Family, x: torch.Tensor, groups: BlockGroups) -> torch.Tensor:
    """Raw residuals (B, r)."""
    data = (family.data,) if family.structure.has_data else ()
    return vmap(family.structure.fn)(*_gather_blocks(family, x, groups), *data)


def family_residuals_and_jacobians(
    family: Family, x: torch.Tensor, groups: BlockGroups
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Raw residuals (B, r) and Jacobians per arg (B, r, T_j) in one
    vmapped forward-mode pass. Blocks are gathered outside the vmapped
    function; every block is Euclidean, so the Jacobian with respect to
    the block is the tangent Jacobian."""
    blocks = _gather_blocks(family, x, groups)
    fn, k = family.structure.fn, family.num_args
    data = (family.data,) if family.structure.has_data else ()

    def one(*args):
        def f(*b):
            out = fn(*b, *args[k:])
            return out, out

        jacs, r = jacfwd(f, argnums=tuple(range(k)), has_aux=True)(*args[:k])
        return r, jacs

    args = blocks + data
    r, jacs = vmap(one)(*args)
    # A residual written with Python floats on 0-dim tensors gets float64
    # tangents under vmap(jacfwd) (see models/bal.py); keep the blocks in
    # the evaluation dtype.
    return r, tuple(J.to(r.dtype) for J in jacs)


@dataclasses.dataclass
class JacobianContext:
    """The problem Jacobian as batched per-family blocks.

    ``jacs[fi][j]`` is (B, r, T_j); ``residuals[fi]`` is (B, r); ``groups``
    are the block-diagonal tangent groups every product reduces into."""

    families: List[Family]
    jacs: Tuple[Tuple[torch.Tensor, ...], ...]
    residuals: Tuple[torch.Tensor, ...]
    num_tangent: int
    groups: BlockGroups

    @property
    def dtype(self) -> torch.dtype:
        return self.residuals[0].dtype

    def _group_pad(self, v: torch.Tensor, fill: float = 0.0) -> dict:
        """Flat tangent vector -> {T: (G_T+1, T)} with a dummy last row."""
        out = {}
        for T, _ in self.groups.items():
            rows = _group_rows(self.groups, v, T)
            pad = torch.full((1, T), fill, dtype=v.dtype, device=v.device)
            out[T] = torch.cat([rows, pad], dim=0)
        return out

    def _ungroup_add(self, acc: dict, dtype: torch.dtype) -> torch.Tensor:
        """{T: (G_T+1, T)} group sums -> flat tangent vector (rows are
        disjoint coordinate sets; the dummy row is dropped)."""
        g = torch.zeros(
            (self.num_tangent,), dtype=dtype, device=self.residuals[0].device
        )
        for T, a in acc.items():
            idx = self.groups[T]
            G = idx.shape[0]
            sl = self.groups.slice_of(T)
            if sl is not None:
                start, _ = sl
                g[start : start + G * T] += a[:G].to(dtype).reshape(G * T)
            else:
                g.index_add_(0, idx.reshape(-1), a[:G].to(dtype).reshape(-1))
        return g

    def matvec(
        self, v: torch.Tensor, skip: Optional[Sequence[int]] = None
    ) -> Tuple[torch.Tensor, ...]:
        """J v -> per-family residual blocks (B, r). ``skip[fi]`` names an
        arg to leave out (-1 = none): with the Schur e-arg skipped this is
        the partitioned F-product."""
        vg = self._group_pad(v)
        out = []
        for fi, fam in enumerate(self.families):
            acc = torch.zeros(
                (fam.batch, fam.residual_size), dtype=v.dtype, device=v.device
            )
            for j in range(fam.num_args):
                if skip is not None and j == skip[fi]:
                    continue
                vj = vg[fam.structure.tangent_sizes[j]][fam.bd_pos[j]]
                acc = acc + torch.einsum("brt,bt->br", self.jacs[fi][j], vj)
            out.append(acc)
        return tuple(out)

    def rmatvec(
        self, w: Sequence[torch.Tensor], skip: Optional[Sequence[int]] = None
    ) -> torch.Tensor:
        """J' w for per-family residual blocks -> tangent vector, reduced
        per block through the family's plans. ``skip`` as in matvec."""
        acc: dict = {}
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                if skip is not None and j == skip[fi]:
                    continue
                T = fam.structure.tangent_sizes[j]
                contrib = torch.einsum("brt,br->bt", self.jacs[fi][j], w[fi])
                red = apply_reduce(fam.reduce_plans[j], contrib)
                acc[T] = red if T not in acc else acc[T] + red
        return self._ungroup_add(acc, w[0].dtype)

    def gradient(self) -> torch.Tensor:
        """g = J' r."""
        return self.rmatvec(self.residuals)

    def squared_column_norms(self) -> torch.Tensor:
        """diag(J'J) (BlockSparseMatrix::SquaredColumnNorm)."""
        acc: dict = {}
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                contrib = torch.sum(self.jacs[fi][j] ** 2, dim=1)
                red = apply_reduce(fam.reduce_plans[j], contrib)
                acc[T] = red if T not in acc else acc[T] + red
        return self._ungroup_add(acc, self.dtype)

    def scale_columns(self, scale: torch.Tensor) -> "JacobianContext":
        """A context with the Jacobian's columns scaled (Jacobi scaling,
        trust_region_minimizer.cc:263-279)."""
        sg = self._group_pad(scale, fill=1.0)
        new_jacs = []
        for fi, fam in enumerate(self.families):
            js = []
            for j in range(fam.num_args):
                sj = sg[fam.structure.tangent_sizes[j]][fam.bd_pos[j]]
                js.append(self.jacs[fi][j] * sj[:, None, :])
            new_jacs.append(tuple(js))
        return dataclasses.replace(self, jacs=tuple(new_jacs))


def _cost_impl(x: torch.Tensor, families, groups: BlockGroups) -> torch.Tensor:
    """0.5 ||r||^2 accumulated in f64 even for f32 evaluation: the LM
    accept/reject and function-tolerance tests compare cost differences,
    which f32 sums over 10^5 residuals would drown."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for fam in families:
        r = family_residuals(fam, x, groups)
        total = total + 0.5 * torch.sum((r * r).to(torch.float64))
    return total


def _full_impl(x: torch.Tensor, families, num_tangent: int, groups: BlockGroups):
    """(cost f64, gradient, JacobianContext) at x."""
    cost = torch.zeros((), dtype=torch.float64, device=x.device)
    all_jacs, all_res = [], []
    for fam in families:
        r, jacs = family_residuals_and_jacobians(fam, x, groups)
        sq_norm = torch.sum(r * r, dim=-1)
        cost = cost + 0.5 * torch.sum(sq_norm.to(torch.float64))
        all_jacs.append(jacs)
        all_res.append(r)
    ctx = JacobianContext(
        list(families), tuple(all_jacs), tuple(all_res), num_tangent, groups
    )
    return cost, ctx.gradient(), ctx
