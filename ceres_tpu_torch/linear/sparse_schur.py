"""SPARSE_SCHUR: the block-sparse reduced camera system factored on the host
(port of ``ceres_tpu/linear/sparse_schur.py``; the reference's
SparseSchurComplementSolver, ``schur_complement_solver.h:169-183``).

The reduced camera system S has a cell only for the camera pairs that
observe a common point. A dense S costs O(nf^2) memory (1.9 GB in f64 at
nf = 15 507); the sparse path scales with the visibility instead. The work
is split as follows:

- the card computes every reduced cell block in one pass
  (``schur_explicit.compute_cell_blocks``: F'F and self-pair cells through
  the unsorted segment sum K3 or one-hot matmuls, the W'M^-1 W correction
  through the fused pair-outer kernel K4, the point side through K1);
- the host places the cell values into the upper-triangular CSC pattern
  with one ``np.bincount`` (the pattern is built once per structure), adds
  the damping and factors with the native core's simplicial Cholesky,
  analyzed once and refactored every iteration (``sparse_cholesky.py``);
- the card back-substitutes the points (implicit_schur_complement.cc:208)
  and forms the step.

Per iteration the host receives O(nnz(S cells)) values, what the
reference's eliminator writes, not the Jacobian. This is the host loop's
step; a caller of ``linear/schur.solve_schur`` (DOGLEG, mixed-precision
refinement, the fused loop) takes the dense-S route, as in the JAX package.

On a sharded program every row of a point lies on its owner rank
(``parallel/sharding.py``), so the eliminator pass runs as DENSE_SCHUR's
does there: each rank computes the cells of its own rows, whose sum over
the ranks is S (the F'F cells are linear in the rows, and each point's
W' M^-1 W pairs are whole on its owner). The cells are placed in the whole
program's cell list (``inner_product.CellLayout``, built from
``Program.unsharded`` with the same ordering on every rank) and summed by
one all-reduce inside the prep; the reduced rhs and the damping are sums
already. Every rank factors the same summed system, and the finish
broadcasts rank 0's reduced solution before the owners back-substitute
their points.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.linear.cg import CG_SUCCESS
from ceres_tpu_torch.linear.inner_product import (
    CscAssembly,
    cell_layout,
    csc_assembly,
    host_normal_factor_solve,
    place_cells,
    summed_cells,
)
from ceres_tpu_torch.linear.schur import SchurOperator, build_schur_structure
from ceres_tpu_torch.linear.schur_explicit import FtFSite, build_explicit_plan, compute_cell_blocks


def build_sparse_schur_assembly(plan) -> CscAssembly:
    """The CSC pattern of upper(S) and the place of every cell value, from
    the explicit plan's cells (``schur_explicit.build_explicit_plan``
    enumerates the camera-pair cells that ARE S's block pattern; this only
    scalarizes it). Values are listed in ``compute_cell_blocks`` order; the
    strict lower triangle of a diagonal cell goes to the trash slot (block
    symmetry repeats it), an off-diagonal cell to its upper-triangle
    place."""
    nf = plan.nf
    keys_parts, valid_parts = [], []
    for site in (*plan.ftf, *plan.corr):
        rows = site.rows.cpu().numpy().astype(np.int64)
        cols = site.cols.cpu().numpy().astype(np.int64)
        C, T1 = rows.shape
        T2 = cols.shape[1]
        r = np.broadcast_to(rows[:, :, None], (C, T1, T2))
        c = np.broadcast_to(cols[:, None, :], (C, T1, T2))
        if site.diagonal:
            valid = r <= c
            key = c * nf + r
        else:
            valid = np.ones((C, T1, T2), dtype=bool)
            key = np.maximum(r, c) * nf + np.minimum(r, c)
        keys_parts.append(key.reshape(-1))
        valid_parts.append(valid.reshape(-1))
    return csc_assembly(nf, keys_parts, valid_parts)


def _site_keys(plan) -> list:
    """(identity, cell keys, flat block shape) of each cell site of an
    explicit plan, in ``compute_cell_blocks`` order (``cell_layout``)."""
    out = []
    for site in (*plan.ftf, *plan.corr):
        if isinstance(site, FtFSite):
            ident = ("ftf", site.fi, site.jA, site.jB, site.diagonal)
        else:
            ident = ("corr", site.T1, site.T2, site.diagonal)
        rows = site.rows[:, 0].cpu().numpy().astype(np.int64)
        cols = site.cols[:, 0].cpu().numpy().astype(np.int64)
        out.append((ident, rows * (plan.nf + 1) + cols,
                    (site.rows.shape[1] * site.cols.shape[1],)))
    return out


def sparse_schur_assembly(program, ss) -> None:
    """Set ``ss.sparse_assembly`` (once): the CSC pattern of the whole
    program's S, and on a sharded program ``ss.sparse_layout``, where this
    rank's cells go in the whole program's (the whole program's cells from
    its unsharded view, by the same ordering, on the host)."""
    if ss.sparse_assembly is not None:
        return
    if program.comm is None:
        ss.sparse_assembly = build_sparse_schur_assembly(ss.explicit)
        return
    whole = program.unsharded()
    whole_ss = build_schur_structure(whole, ordering=list(ss.host_e_pids), device="cpu")
    whole_plan = build_explicit_plan(whole, whole_ss, host_only=True)
    ss.sparse_layout = cell_layout(_site_keys(ss.explicit), _site_keys(whole_plan),
                                   program.device)
    ss.sparse_assembly = build_sparse_schur_assembly(whole_plan)


def _sparse_schur_prep_impl(ctx, radius: torch.Tensor, ss, config):
    """The card's half before the factorization: the LM damping, the point
    blocks, every reduced cell and the reduced rhs (the eliminator pass,
    schur_eliminator_impl.h:177-330). Returns (op, cells, rhs_red, df)."""
    from ceres_tpu_torch.trust_region import _lm_damping

    diag = torch.clamp(ctx.squared_column_norms(), config.min_lm_diagonal,
                       config.max_lm_diagonal)
    op = SchurOperator(ctx, _lm_damping(diag, radius), ss)
    cells = [blocks for _, blocks in compute_cell_blocks(op, ss.explicit)]
    if ss.sparse_layout is not None:  # a rank's cells, in the whole layout and summed
        cells = summed_cells(ctx, place_cells(ss.sparse_layout, cells, ctx.residuals[0]))
    return op, cells, op.rhs()[ss.f_idx], op.D[ss.f_idx]


def _sparse_schur_finish_impl(op: SchurOperator, xf_red: torch.Tensor):
    """The card's half after the solve: the points back-substituted, the step
    and its model cost change. On a sharded program rank 0's ``xf_red``,
    broadcast."""
    from ceres_tpu_torch.trust_region import _model_cost_change

    if op.ctx.comm is not None:
        xf_red = op.ctx.comm.broadcast(xf_red)
    x_f = torch.zeros((op.ctx.num_tangent,), dtype=op.dtype, device=xf_red.device)
    x_f[op.ss.f_idx] = xf_red
    step = -op.back_substitute(x_f)
    return step, _model_cost_change(op.ctx, step)


class SparseSchurStep:
    """The host-driven SPARSE_SCHUR LM step for the trust-region loop:
    f(ctx, radius) -> (step, model cost change, linear iterations,
    termination). The CSC assembly and the factor's symbolic analysis live
    on the Schur structure across solves (sparse_cholesky.h:71-112). The
    card's halves run on ``regions`` (``host_loop_graphs.SparseRegions``:
    the host loop's, captured where it is, or eager ones of the step's
    own): the prep into one of two buffer sets, the finish with that set's
    point blocks.

    Unlike J'J, S's cells depend on the radius (the eliminated point blocks
    carry D_e^2), so a rejected step cannot reuse the transfer. Inside a
    reject streak the step instead enqueues the card's work for the
    predicted next radius into the other set after reading this step's
    cells and before factoring them: the card computes the next system
    while the host factors this one. On a sharded program the cells are the
    whole program's (:func:`sparse_schur_assembly`), summed inside the
    prep, and the finish broadcasts rank 0's reduced solution."""

    def __init__(self, config, solve_aux, program, regions=None):
        from ceres_tpu_torch.host_loop_graphs import SparseRegions

        ss = solve_aux["ss"]
        if ss.explicit is None:
            raise ValueError("SPARSE_SCHUR needs the explicit cell plan")
        sparse_schur_assembly(program, ss)
        self.config, self.ss, self.assembly = config, ss, ss.sparse_assembly
        self.regions = regions or SparseRegions(program.device, False, config)
        self._state: dict = {"ctx": None}

    def __call__(self, ctx, radius: float):
        from ceres_tpu_torch.trust_region import _failed_step, _step_result

        state, ss, c, regions = self._state, self.ss, self.config, self.regions
        in_streak = state["ctx"] is ctx
        if in_streak:
            prev = state.get("prev_radius")
            if prev and radius < prev:
                state["pred_factor"] = (prev / radius) * 2.0
        else:
            state.update(ctx=ctx, pred_factor=2.0, prev_radius=None, spec=None)
        spec = state.pop("spec", None)
        if spec is not None and abs(spec[0] - radius) <= 1e-9 * max(radius, 1.0):
            k = spec[1]  # the set enqueued during the last factorization
        else:
            k = 0
            regions.sparse_schur_prep(ctx, radius, ss, k)
        rhs_h, df_h, *cells_h = regions.read_flat(f"sparse_schur_cells_{k}")
        if in_streak:
            r_pred = radius / state["pred_factor"]
            regions.sparse_schur_prep(ctx, r_pred, ss, 1 - k)
            state["spec"] = (r_pred, 1 - k)
        state["prev_radius"] = radius
        # the host half: the normal equations' with the reduced system's damping
        xf, term = host_normal_factor_solve(
            self.assembly, cells_h, df_h, rhs_h, ordering=c.ordering_type,
            use_postordering=c.use_postordering, mixed_precision=c.use_mixed_precision_solves,
            num_refinement_iterations=c.num_refinement_iterations,
        )
        if term != CG_SUCCESS:
            return _failed_step(ctx.num_tangent, ctx.dtype, ctx.residuals[0].device, term)
        return _step_result(*regions.sparse_schur_finish(ctx, xf, ss, k), term)
