"""Batched residual/Jacobian evaluation (port of ``ceres_tpu/evaluator.py``).

Each residual family is evaluated with one ``torch.func.vmap(jacfwd(fn))``
call over its B instances: forward-mode AD gives the per-instance Jacobian
blocks (B, r, T_j) of every argument. The Jacobian is never assembled
globally: it stays as these per-family blocks (the BlockSparseMatrix
analog), and every product with it reduces per-observation contributions
into per-block rows through the family's reduce plans (``ops/reduce.py``;
on CUDA the point-side ones run the sorted-segment-sum kernel and, from a
few hundred cameras on, the camera-side ones the unsorted one).

Each instance is differentiated as a function of tangent deltas at
delta = 0, ``r(delta) = fn(plus(x_j, delta_j), ...)``, which folds the cost
function's Jacobian and the manifold's PlusJacobian into one forward-mode
pass (residual_block.cc:136-159 does it in two steps). A family's loss
corrects its residuals and Jacobian blocks (the Triggs correction of
corrector.cc) before any solver sees them: the model cost change and rho
use the corrected arrays, the cost uses rho(s).

On a sharded program (``parallel/sharding.py``) each rank holds its share
of every family's rows, and every sum over rows is finished by one
all-reduce over the ranks: the cost, the products J' w and J' W, the column
norms and the J'J blocks. ``JacobianContext.comm`` and the ``comm`` argument
of the functions below carry the collectives (None: one process). The
residual vector and the dense Jacobian are gathered whole, in the user's
row order. Padding rows (``Family.mask`` 0) are zeroed before the loss.

``Evaluator`` wraps these functions for the host-loop minimizer
(evaluator.h / program_evaluator.h): the entry points, the
``EvaluationCallback`` hook, call statistics, and ``cost_and_gradient``, the
tangent gradient by reverse mode without a Jacobian.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ceres_tpu_torch.loss import (
    correct_jacobian,
    correct_residuals,
    corrector_coefficients,
)
from ceres_tpu_torch.ops.reduce import apply_reduce
from ceres_tpu_torch.ops.small_linalg import contract
from ceres_tpu_torch.problem import BlockGroups, Family, plus_apply


def _group_rows(groups: BlockGroups, v: torch.Tensor, T: int) -> torch.Tensor:
    """(G_T, T) view of size group T's coordinates of the flat vector v
    (a free view when they are one contiguous range)."""
    sl = groups.slice_of(T)
    if sl is not None:
        start, G = sl
        return v[start : start + G * T].view(G, T)
    return v[groups[T]]


class _RowGather(torch.autograd.Function):
    """``table[index]``, whose backward sums each table row's gradients
    through ``plan`` (the family's gather plan, ``ops/reduce.py``) in one
    fixed order: the same bits on every run, captured or not, where the
    index's own backward adds them with atomics in no fixed order on the
    card. Rows the plan drops (constant blocks) get no gradient."""

    @staticmethod
    def forward(table, index, plan):
        return table[index]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, _, ctx.plan = inputs
        ctx.num_rows = table.shape[0]

    @staticmethod
    def backward(ctx, grad):
        return apply_reduce(ctx.plan, grad)[: ctx.num_rows], None, None


def _gather_blocks(family: Family, x: torch.Tensor):
    """Per-instance parameter blocks (B, A_j) per arg: the ambient size
    group's (G, A) table of x and one row gather. Constant blocks are
    gathered like the others. Where x carries a gradient (the reverse mode
    of ``_cost_grad_impl``) the gather is ``_RowGather``: the gradient
    reaches every block with a tangent, none reaches a constant block."""
    differentiated = torch.is_grad_enabled() and x.requires_grad
    blocks = []
    for j, A in enumerate(family.structure.block_sizes):
        table = _group_rows(family.amb_groups, x, A)
        if differentiated:
            blocks.append(_RowGather.apply(table, family.amb_pos[j], family.gather_plans[j]))
        else:
            blocks.append(table[family.amb_pos[j]])
    return tuple(blocks)


def _mask_rows(family: Family, a: torch.Tensor) -> torch.Tensor:
    """``a`` (B, ...) with the padding rows zeroed; the mask is taken in
    a's dtype, so an f64 mask cannot promote an f32 evaluation."""
    if family.mask is None:
        return a
    return a * family.mask.to(a.dtype).reshape((-1,) + (1,) * (a.ndim - 1))


def family_residuals(family: Family, x: torch.Tensor) -> torch.Tensor:
    """Raw residuals (B, r), zero on padding rows."""
    data = (family.data,) if family.structure.has_data else ()
    return _mask_rows(family, vmap(family.structure.fn)(*_gather_blocks(family, x), *data))


def family_residuals_and_jacobians(
    family: Family, x: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Raw residuals (B, r) and tangent Jacobians per arg (B, r, T_j) in
    one vmapped forward-mode pass over the tangent deltas at 0. An arg
    without a manifold is differentiated with respect to the block itself,
    which is the same Jacobian."""
    st = family.structure
    blocks = _gather_blocks(family, x)
    fn, k = st.fn, family.num_args
    data = (family.data,) if st.has_data else ()
    # The variable of differentiation per arg: the block itself, or the
    # tangent delta (at 0) of a block on a manifold.
    variables = tuple(
        blocks[j] if m is None else x.new_zeros((family.batch, st.tangent_sizes[j]))
        for j, m in enumerate(st.manifolds)
    )

    def one(*args):
        bs, rest = args[:k], args[2 * k :]

        def f(*v):
            moved = [
                v[j] if m is None else m.plus(bs[j], v[j])
                for j, m in enumerate(st.manifolds)
            ]
            out = fn(*moved, *rest)
            return out, out

        jacs, r = jacfwd(f, argnums=tuple(range(k)), has_aux=True)(*args[k : 2 * k])
        return r, jacs

    r, jacs = vmap(one)(*blocks, *variables, *data)
    # A residual written with Python floats on 0-dim tensors gets float64
    # tangents under vmap(jacfwd) (see models/bal.py); keep the blocks in
    # the evaluation dtype.
    return _mask_rows(family, r), tuple(_mask_rows(family, J.to(r.dtype)) for J in jacs)


def _apply_loss(family: Family, r: torch.Tensor, jacs):
    """Triggs-correct residuals and Jacobians; returns (cost, r_c, jacs_c)
    (residual_block.cc:160-196 + corrector.cc). With no loss,
    cost = 0.5 ||r||^2 and the arrays pass through. The cost is summed in
    f64 (see _cost_impl)."""
    sq_norm = torch.sum(r * r, dim=-1)
    if family.loss is None:
        return 0.5 * torch.sum(sq_norm.to(torch.float64)), r, jacs
    rho0, rho1, rho2 = family.loss.evaluate(sq_norm)
    cost = 0.5 * torch.sum(rho0.to(torch.float64))
    scale, alpha_sq_norm = corrector_coefficients(sq_norm, rho1, rho2)
    sqrt_rho1 = torch.sqrt(rho1)
    if jacs is not None:
        jacs = tuple(correct_jacobian(J, r, sqrt_rho1, alpha_sq_norm) for J in jacs)
    return cost, correct_residuals(r, scale), jacs


def tangent_idx(fam: Family, j: int, groups: BlockGroups, num_tangent: int) -> torch.Tensor:
    """(B, T_j) tangent coordinates of ``fam``'s arg j blocks; a constant
    block points at the dummy coordinate ``num_tangent``."""
    T = fam.structure.tangent_sizes[j]
    pos = fam.bd_pos[j]
    dummy = torch.full((1, T), num_tangent, dtype=torch.int64, device=pos.device)
    if T not in groups:
        return dummy.expand(fam.batch, T)
    return torch.cat([groups[T], dummy], dim=0)[pos]


@dataclasses.dataclass
class JacobianContext:
    """The problem Jacobian as batched per-family blocks.

    ``jacs[fi][j]`` is (B, r, T_j); ``residuals[fi]`` is (B, r); ``groups``
    are the block-diagonal tangent groups every product reduces into.
    ``comm``: on a sharded program the collectives (the blocks are this
    rank's rows, and every reduction over rows is all-reduced), else None."""

    families: List[Family]
    jacs: Tuple[Tuple[torch.Tensor, ...], ...]
    residuals: Tuple[torch.Tensor, ...]
    num_tangent: int
    groups: BlockGroups
    comm: Optional[object] = None

    def _sum(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` summed over the ranks (itself in one process)."""
        return a if self.comm is None else self.comm.sum(a)

    def gathered(self) -> "JacobianContext":
        """The context of the whole problem on every rank: each family's
        rows put back in the user's order (itself in one process). One
        all-reduce of the rows, each of which one rank holds; memoized."""
        if self.comm is None:
            return self
        # kept outside the fields, so that dataclasses.replace (to_dtype,
        # scale_columns) does not hand it to a context of other values
        g = self.__dict__.get("_gathered")
        if g is None:
            full = self.comm.full_families
            res, jacs = self.comm.gather_rows(self.families, full, self.residuals, self.jacs)
            g = JacobianContext(list(full), jacs, res, self.num_tangent, self.groups)
            self.__dict__["_gathered"] = g
        return g

    @property
    def dtype(self) -> torch.dtype:
        return self.residuals[0].dtype

    def to_dtype(self, dtype: torch.dtype) -> "JacobianContext":
        """The context with its Jacobian blocks and residuals in ``dtype``
        (itself when they already are): the mixed-precision solve's f32
        copy and f64 refinement copy."""
        if self.dtype == dtype:
            return self
        return dataclasses.replace(
            self,
            jacs=tuple(tuple(J.to(dtype) for J in js) for js in self.jacs),
            residuals=tuple(r.to(dtype) for r in self.residuals),
        )

    def _group_pad(self, v: torch.Tensor, fill: float = 0.0) -> dict:
        """Flat tangent vector -> {T: (G_T+1, T)} with a dummy last row."""
        out = {}
        for T, _ in self.groups.items():
            rows = _group_rows(self.groups, v, T)
            pad = torch.full((1, T), fill, dtype=v.dtype, device=v.device)
            out[T] = torch.cat([rows, pad], dim=0)
        return out

    def _ungroup_add(self, acc: dict, dtype: torch.dtype, cols: tuple = ()) -> torch.Tensor:
        """{T: (G_T+1, T, *cols)} group sums -> tangent vector (n, *cols)
        (rows are disjoint coordinate sets; the dummy row is dropped)."""
        g = torch.zeros(
            (self.num_tangent, *cols), dtype=dtype, device=self.residuals[0].device
        )
        for T, a in acc.items():
            idx = self.groups[T]
            G = idx.shape[0]
            sl = self.groups.slice_of(T)
            if sl is not None:
                start, _ = sl
                g[start : start + G * T] += a[:G].to(dtype).reshape(G * T, *cols)
            else:
                g.index_add_(0, idx.reshape(-1), a[:G].to(dtype).reshape(-1, *cols))
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
                T = fam.structure.tangent_sizes[j]
                if T not in vg:
                    continue  # every block of this size is constant
                acc = acc + torch.einsum(
                    "brt,bt->br", self.jacs[fi][j], vg[T][fam.bd_pos[j]]
                )
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
                if T not in self.groups:
                    continue  # every block of this size is constant
                contrib = torch.einsum("brt,br->bt", self.jacs[fi][j], w[fi])
                red = apply_reduce(fam.reduce_plans[j], contrib)
                acc[T] = red if T not in acc else acc[T] + red
        return self._sum(self._ungroup_add(acc, w[0].dtype))

    def rmatmat(
        self, W: Sequence[torch.Tensor], skip: Optional[Sequence[int]] = None
    ) -> torch.Tensor:
        """J' W for per-family (B, r, k) blocks -> (n, k) (the column form
        of :meth:`rmatvec`, through the same plans; the short axis r summed
        term by term, not as 1.2 M tiny matrix products)."""
        acc: dict = {}
        k = W[0].shape[2]
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                if skip is not None and j == skip[fi]:
                    continue
                T = fam.structure.tangent_sizes[j]
                if T not in self.groups:
                    continue
                contrib = contract(self.jacs[fi][j].transpose(1, 2), W[fi])
                red = apply_reduce(fam.reduce_plans[j], contrib)
                acc[T] = red if T not in acc else acc[T] + red
        return self._sum(self._ungroup_add(acc, W[0].dtype, (k,)))

    def matmat(self, V: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """J V for an (n, k) block of tangent columns -> per-family (B, r, k)
        (the column form of :meth:`matvec`)."""
        k = V.shape[1]
        Vg = {
            T: torch.cat([V[idx], V.new_zeros((1, T, k))], dim=0)
            for T, idx in self.groups.items()
        }
        out = []
        for fi, fam in enumerate(self.families):
            acc = V.new_zeros((fam.batch, fam.residual_size, k))
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if T in Vg:
                    acc = acc + torch.einsum("brt,btk->brk", self.jacs[fi][j], Vg[T][fam.bd_pos[j]])
            out.append(acc)
        return tuple(out)

    def normal_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """J'J v in one pass (the CGNR product)."""
        return self.rmatvec(self.matvec(v))

    def normal_matmat(self, V: torch.Tensor) -> torch.Tensor:
        """J'J V for (n, k) columns."""
        return self.rmatmat(self.matmat(V))

    def gradient(self) -> torch.Tensor:
        """g = J' r (with corrected arrays this equals rho' J' r)."""
        return self.rmatvec(self.residuals)

    def squared_column_norms(self) -> torch.Tensor:
        """diag(J'J) (BlockSparseMatrix::SquaredColumnNorm)."""
        acc: dict = {}
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if T not in self.groups:
                    continue
                contrib = torch.sum(self.jacs[fi][j] ** 2, dim=1)
                red = apply_reduce(fam.reduce_plans[j], contrib)
                acc[T] = red if T not in acc else acc[T] + red
        return self._sum(self._ungroup_add(acc, self.dtype))

    def scale_columns(self, scale: torch.Tensor) -> "JacobianContext":
        """A context with the Jacobian's columns scaled (Jacobi scaling,
        trust_region_minimizer.cc:263-279)."""
        sg = self._group_pad(scale, fill=1.0)
        new_jacs = []
        for fi, fam in enumerate(self.families):
            js = []
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if T not in sg:
                    js.append(self.jacs[fi][j])
                    continue
                js.append(self.jacs[fi][j] * sg[T][fam.bd_pos[j]][:, None, :])
            new_jacs.append(tuple(js))
        return dataclasses.replace(self, jacs=tuple(new_jacs))

    def block_jtj(self, group_sizes) -> dict:
        """Block diagonal of J'J grouped by tangent size
        (block_jacobi_preconditioner.h:55): {T: (G_T, T, T)} batched
        matrices, one einsum and one plan reduction per family arg.
        ``group_sizes`` is {tangent_size: num_blocks}."""
        dev = self.residuals[0].device
        out = {
            T: torch.zeros((G, T, T), dtype=self.dtype, device=dev)
            for T, G in group_sizes.items()
        }
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if T not in out:
                    continue
                Jj = self.jacs[fi][j]
                contrib = torch.einsum("bri,brj->bij", Jj, Jj)
                red = apply_reduce(fam.reduce_plans[j], contrib)
                out[T] = out[T] + red[: out[T].shape[0]]
        if self.comm is not None:
            out = dict(zip(out, self.comm.sum_all(list(out.values()))))
        return out

    def residual_vector(self) -> torch.Tensor:
        """Flat corrected residual vector (M,), the whole problem's."""
        if self.comm is not None:
            return self.gathered().residual_vector()
        return torch.cat([r.reshape(-1) for r in self.residuals])

    @property
    def num_rows(self) -> int:
        return sum(f.batch * f.residual_size for f in self.families)

    def tangent_idx(self, fi: int, j: int) -> torch.Tensor:
        """(B, T_j) tangent coordinates of arg j's blocks; a constant block
        points at the dummy coordinate ``num_tangent``."""
        return tangent_idx(self.families[fi], j, self.groups, self.num_tangent)

    def to_dense(self) -> torch.Tensor:
        """The dense Jacobian (M, num_tangent): dense solvers and small
        problems only (dense_jacobian_writer.h analog), the whole problem's."""
        if self.comm is not None:
            return self.gathered().to_dense()
        dev = self.residuals[0].device
        nt = self.num_tangent
        dense = torch.zeros((self.num_rows, nt + 1), dtype=self.dtype, device=dev)
        row = 0
        for fi, fam in enumerate(self.families):
            B, r = fam.batch, fam.residual_size
            rows = row + torch.arange(B * r, device=dev).reshape(B, r)
            for j in range(fam.num_args):
                dense.index_put_(
                    (rows[:, :, None], self.tangent_idx(fi, j)[:, None, :]),
                    self.jacs[fi][j],
                    accumulate=True,
                )
            row += B * r
        return dense[:, :nt]


def crs_from_blocks(families, blocks, tidx, num_tangent: int):
    """Scipy CSR of a block Jacobian from host arrays: ``blocks`` the
    families' (B, r, T_j) Jacobian blocks and ``tidx`` their (B, T_j)
    tangent coordinates (``num_tangent``: a constant block, left out), both
    in (family, arg) order."""
    import scipy.sparse as sp

    rows_l, cols_l, vals_l = [], [], []
    row0, k = 0, 0
    for fam in families:
        B, r = fam.batch, fam.residual_size
        rows_f = row0 + np.arange(B * r).reshape(B, r)
        for _ in range(fam.num_args):
            tj, Jj = tidx[k], blocks[k]
            k += 1
            T = tj.shape[1]
            kk = np.broadcast_to((tj < num_tangent)[:, None, :], (B, r, T))
            rows_l.append(np.broadcast_to(rows_f[:, :, None], (B, r, T))[kk])
            cols_l.append(np.broadcast_to(tj[:, None, :], (B, r, T))[kk])
            vals_l.append(Jj[kk])
        row0 += B * r
    if not rows_l:
        return sp.csr_matrix((0, num_tangent))
    return sp.csr_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(row0, num_tangent),
    )


def to_crs(ctx: JacobianContext):
    """Scipy CSR of the block Jacobian (include/ceres/crs_matrix.h analog
    for Problem.evaluate), assembled on the host from the per-family
    (B, r, T_j) blocks without the dense matrix; the whole problem's on a
    sharded context."""
    if ctx.comm is not None:
        return to_crs(ctx.gathered())
    blocks, tidx = [], []
    for fi, fam in enumerate(ctx.families):
        for j in range(fam.num_args):
            tidx.append(ctx.tangent_idx(fi, j).cpu().numpy())
            blocks.append(ctx.jacs[fi][j].cpu().numpy())
    return crs_from_blocks(ctx.families, blocks, tidx, ctx.num_tangent)


def _cost_impl(x: torch.Tensor, families, apply_loss: bool = True, comm=None) -> torch.Tensor:
    """0.5 sum rho(||r||^2) accumulated in f64 even for f32 evaluation: the
    LM accept/reject and function-tolerance tests compare cost differences,
    which f32 sums over 10^5 residuals would drown. ``comm``: the families
    are this rank's share, and the sum is all-reduced."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for fam in families:
        r = family_residuals(fam, x)
        if apply_loss and fam.loss is not None:
            rho0, _, _ = fam.loss.evaluate(torch.sum(r * r, dim=-1))
            total = total + 0.5 * torch.sum(rho0.to(torch.float64))
        else:
            total = total + 0.5 * torch.sum((r * r).to(torch.float64))
    return total if comm is None else comm.sum(total)


def _residuals_impl(x: torch.Tensor, families, apply_loss: bool = True,
                    comm=None) -> torch.Tensor:
    """Flat residual vector of the given families, loss-corrected when
    ``apply_loss``; with ``comm``, of the whole problem, gathered in the
    user's row order."""
    outs = []
    for fam in families:
        r = family_residuals(fam, x)
        if apply_loss and fam.loss is not None:
            sq = torch.sum(r * r, dim=-1)
            _, rho1, rho2 = fam.loss.evaluate(sq)
            scale, _ = corrector_coefficients(sq, rho1, rho2)
            r = correct_residuals(r, scale)
        outs.append(r)
    if comm is not None:
        outs, _ = comm.gather_rows(families, comm.full_families, outs, None)
    outs = [r.reshape(-1) for r in outs]
    return torch.cat(outs) if outs else x.new_zeros((0,))


def _context_impl(x: torch.Tensor, families, num_tangent: int, groups: BlockGroups,
                  apply_loss: bool = True, comm=None):
    """(cost f64, JacobianContext) at x; residuals and Jacobian blocks of the
    context are loss-corrected. ``comm``: see _cost_impl."""
    cost = torch.zeros((), dtype=torch.float64, device=x.device)
    all_jacs, all_res = [], []
    for fam in families:
        r, jacs = family_residuals_and_jacobians(fam, x)
        if apply_loss:
            c, r, jacs = _apply_loss(fam, r, jacs)
        else:
            c = 0.5 * torch.sum((r * r).to(torch.float64))
        cost = cost + c
        all_jacs.append(jacs)
        all_res.append(r)
    ctx = JacobianContext(
        list(families), tuple(all_jacs), tuple(all_res), num_tangent, groups, comm
    )
    return cost if comm is None else comm.sum(cost), ctx


def _full_impl(x: torch.Tensor, families, num_tangent: int, groups: BlockGroups,
               apply_loss: bool = True, comm=None):
    """(cost f64, gradient, JacobianContext) at x (see _context_impl)."""
    cost, ctx = _context_impl(x, families, num_tangent, groups, apply_loss, comm)
    return cost, ctx.gradient(), ctx


def _cost_grad_impl(x: torch.Tensor, families, plus_struct, apply_loss: bool,
                    num_tangent: int, comm=None):
    """(cost f64, tangent gradient) by reverse mode: the gradient of
    cost(plus(x, delta)) at delta = 0, with no Jacobian formed
    (program_evaluator.h:266-284 analog), its sums over rows in a fixed
    order (``_RowGather``). The gradient has x's dtype; the
    inputs are detached, and grad is enabled here, so an outer
    ``torch.no_grad()`` does not stop it. ``comm``: this rank's cost and
    gradient are differentiated, then both all-reduced."""
    with torch.enable_grad():
        delta = torch.zeros((num_tangent,), dtype=x.dtype, device=x.device, requires_grad=True)
        cost = _cost_impl(plus_apply(plus_struct, x.detach(), delta), families, apply_loss)
        (grad,) = torch.autograd.grad(cost, delta)
    cost = cost.detach()
    if comm is not None:
        cost, grad = comm.sum(cost), comm.sum(grad)
    return cost, grad


@dataclasses.dataclass
class FullEval:
    cost: torch.Tensor
    gradient: torch.Tensor
    jacobian_context: JacobianContext


class Evaluator:
    """Evaluation entry points over a frozen Program (analog of Evaluator,
    evaluator.h, and ProgramEvaluator, program_evaluator.h:118): ``cost``,
    ``residuals``, ``cost_and_gradient`` and ``cost_gradient_jacobian``,
    each of them device work that returns without waiting for the device.

    ``evaluation_callback`` (an ``EvaluationCallback``) is told before every
    evaluation whether the point is new — by the identity of x, as the
    reference tells it by its parameter pointers — and whether Jacobians
    are wanted. ``statistics()`` holds the calls and host seconds of each
    entry point (execution_summary.h). With ``graphs``
    (``host_loop_graphs.HostLoopGraphs``, the host loop's) the entry points
    but ``residuals`` run from its regions: ``cost_gradient_jacobian``'s
    point becomes its current point, and the gradient and context it
    returns are its current buffers, valid until the next such call. The
    line search's (``host_loop_graphs.LineSearchGraphs``) serve
    ``cost_and_gradient`` alone."""

    def __init__(self, program, apply_loss_function: bool = True, evaluation_callback=None,
                 graphs=None):
        from ceres_tpu_torch.utils.observability import ExecutionSummary

        self.program = program
        self.apply_loss = apply_loss_function
        self.evaluation_callback = evaluation_callback
        self.graphs = graphs
        self._last_x = None
        self.execution_summary = ExecutionSummary()

    def _notify(self, x, evaluate_jacobians: bool, new_point: Optional[bool] = None) -> None:
        """EvaluationCallback hook (evaluation_callback.h:63-80); x's identity
        says whether the point is new unless ``new_point`` does (a static
        buffer that holds a new point)."""
        if self.evaluation_callback is None:
            return
        if new_point is None:
            new_point = self._last_x is not x
        self._last_x = x
        self.evaluation_callback.prepare_for_evaluation(new_point, evaluate_jacobians)

    def _timer(self, name: str):
        from ceres_tpu_torch.utils.observability import ScopedExecutionTimer

        return ScopedExecutionTimer(name, self.execution_summary)

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        self._notify(x, False)
        with self._timer("Evaluator::Residual"):
            if self.graphs is not None:
                return self.graphs.cost(x)
            return _cost_impl(x, self.program.families, self.apply_loss, self.program.comm)

    def residuals(self, x: torch.Tensor) -> torch.Tensor:
        self._notify(x, False)
        with self._timer("Evaluator::Residual"):
            return _residuals_impl(x, self.program.families, self.apply_loss, self.program.comm)

    def cost_and_gradient(self, x: torch.Tensor):
        """(cost, tangent gradient) without forming the Jacobian."""
        self._notify(x, False)
        p = self.program
        with self._timer("Evaluator::Gradient"):
            if self.graphs is not None:
                return self.graphs.cost_and_gradient(x)
            return _cost_grad_impl(x, p.families, p.plus_struct, self.apply_loss, p.num_tangent,
                                   p.comm)

    def cost_gradient_jacobian(self, x: torch.Tensor) -> FullEval:
        self._notify(x, True)
        p = self.program
        with self._timer("Evaluator::Jacobian"):
            if self.graphs is not None:
                cost, grad, ctx = self.graphs.full(x)
            else:
                cost, grad, ctx = _full_impl(x, p.families, p.num_tangent, p.groups,
                                             self.apply_loss, p.comm)
        return FullEval(cost=cost, gradient=grad, jacobian_context=ctx)

    def statistics(self):
        """Evaluator::Statistics analog (program_evaluator.h:143-147)."""
        return self.execution_summary

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        return self.program.plus(x, delta)
