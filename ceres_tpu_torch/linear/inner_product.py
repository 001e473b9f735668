"""The normal-equation blocks H = J'J reduced on the card (port of
``ceres_tpu/linear/inner_product.py``; analog of the reference's
``InnerProductComputer``, ``inner_product_computer.h:64``).

Instead of shipping the block Jacobian to the host every LM iteration
(O(nnz(J)) bytes), the card reduces the per-instance ``J_i' J_j`` products
into the unique parameter-block-pair cells of H through reduce plans built
once on the host (``ops/reduce.py``: the sorted-segment kernel K1 where the
ids are sorted, the unsorted one K3 for a few hundred to a few thousand
cells, a one-hot matmul for fewer, ``index_add_`` otherwise), and only the
reduced cell values (O(nnz(H))) cross to the host, where the native
simplicial Cholesky factors them (``sparse_normal_cholesky_solver.cc:51-120``).

A host plan lists the cell sites (per family arg pair: diagonal, upper, and
lower cells moved to the upper triangle by a transpose on the card); a host
assembly maps every cell value into the upper-triangular CSC pattern of H,
so that one ``np.bincount`` builds the matrix.

On a sharded program (``parallel/sharding.py``) J'J is linear in the rows,
as the JAX package's GSPMD sums its partial cells: each rank reduces its
own rows into its own sites, places them in the cell list of the whole
program (``Program.unsharded``, the same list on every rank,
:class:`CellLayout`), and one all-reduce sums them, so that only the
O(nnz(H)) cells cross between ranks and to the host. The cells' plans add
in one fixed order on the card (``ops/reduce.reduce_plan_kind``), so the
cells have the same bits on every run, captured or not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.ops.reduce import ReducePlan, apply_reduce, build_reduce_plan


@dataclasses.dataclass
class NormalSite:
    """The cells of one (family, arg pair, orientation). ``transpose``: the
    instance's product is J_j1' J_j2 but its j1 block comes after its j2
    block in the tangent order, so the block is transposed into the upper
    triangle's cell."""

    fi: int
    j1: int
    j2: int
    diagonal: bool
    transpose: bool
    plan: Optional[ReducePlan]  # None: the whole program's layout (host only)
    rows: np.ndarray  # (C, Tr) tangent coordinates of each cell's row block
    cols: np.ndarray  # (C, Tc)


@dataclasses.dataclass
class CellLayout:
    """Where a rank's cells go in the whole program's cell list (a sharded
    program's): ``shapes``, the whole program's sites' (C, ...) block
    shapes, in its order; ``places``, for each site of this rank, the whole
    site it adds to and the (C_local,) places of its cells there. Every cell
    of a rank has one place, so placing them adds nothing and the order is
    fixed; the ranks' placed cells are then all-reduced."""

    shapes: Tuple[Tuple[int, ...], ...]
    places: Tuple[Tuple[int, torch.Tensor], ...]


def cell_layout(local, whole, device) -> CellLayout:
    """The :class:`CellLayout` of a rank's sites ``local`` in the whole
    program's ``whole``, each a list of (identity, (C,) int64 cell keys,
    block shape): a local site adds to the whole site of its identity, a
    cell to the whole cell of its key (built on the host, once)."""
    index = {ident: (w, keys) for w, (ident, keys, _) in enumerate(whole)}
    places = []
    for ident, keys, _ in local:
        w, wkeys = index[ident]
        order = np.argsort(wkeys, kind="stable")
        slot = order[np.searchsorted(wkeys, keys, sorter=order)]
        if not np.array_equal(wkeys[slot], keys):
            raise ValueError(f"a cell of site {ident} is not in the whole program's layout")
        places.append((w, torch.from_numpy(slot).to(device)))
    shapes = tuple((keys.shape[0],) + tuple(shape) for _, keys, shape in whole)
    return CellLayout(shapes=shapes, places=tuple(places))


def place_cells(layout: CellLayout, cells, like: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A rank's cell blocks (one tensor per local site) in the whole
    layout, zero where the rank has no cell (in ``like``'s dtype and
    device)."""
    out = [like.new_zeros(shape) for shape in layout.shapes]
    for (w, slot), blocks in zip(layout.places, cells):
        out[w] = out[w].index_copy(0, slot, blocks)
    return tuple(out)


def summed_cells(ctx, cells) -> Tuple[torch.Tensor, ...]:
    """The cells summed over the ranks in one all-reduce (themselves in one
    process)."""
    if ctx.comm is None:
        return tuple(cells)
    return tuple(ctx.comm.sum_all(list(cells)))


@dataclasses.dataclass
class NormalPlan:
    """The J'J cell sites of a program's rows. On a sharded program
    ``layout`` places this rank's cells in those of the whole program,
    whose sites (``whole``: host arrays, no reduce plan) the assembly is
    built from."""

    sites: Tuple[NormalSite, ...]
    num_tangent: int
    whole: Optional[Tuple[NormalSite, ...]] = None
    layout: Optional[CellLayout] = None


def _first_seen_ids(r: np.ndarray, c: np.ndarray, n: int):
    """Cell id of each (r, c) key, numbered by first appearance, and the
    position of each cell's first instance."""
    uniq, first, inverse = np.unique(r * (n + 1) + c, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return rank[inverse.reshape(-1)], first[order]


def host_tangent_idx(program, fam, j: int) -> np.ndarray:
    """(B, T_j) tangent coordinates of arg j's blocks; a constant block
    points at the dummy coordinate ``num_tangent``."""
    T = fam.structure.tangent_sizes[j]
    col = np.asarray(fam.block_ids[:, j], dtype=np.int64)
    idx = program.tangent_offsets[col][:, None] + np.arange(T)
    return np.where(program.constant[col][:, None], program.num_tangent, idx)


def _normal_sites(program, device) -> List[NormalSite]:
    """The unique block-pair cells of H per family arg pair, with their
    reduce plans on ``device``, or without plans (None: the host's half
    only)."""
    nt = program.num_tangent
    sites: List[NormalSite] = []
    for fi, fam in enumerate(program.families):
        tidx = [host_tangent_idx(program, fam, j) for j in range(fam.num_args)]
        B = fam.batch
        for a in range(fam.num_args):
            for b in range(a, fam.num_args):
                t1, t2 = tidx[a], tidx[b]
                o1, o2 = t1[:, 0], t2[:, 0]
                valid = (o1 < nt) & (o2 < nt)  # constant blocks drop out
                for sel, kr, kc, rs, cs, diagonal, transpose in (
                    (valid & (o1 == o2), o1, o2, t1, t2, True, False),
                    (valid & (o1 < o2), o1, o2, t1, t2, False, False),
                    (valid & (o1 > o2), o2, o1, t2, t1, False, True),
                ):
                    idx = np.nonzero(sel)[0]
                    if idx.size == 0:
                        continue
                    ids, first = _first_seen_ids(kr[idx], kc[idx], nt)
                    C = first.shape[0]
                    seg = np.full(B, C, dtype=np.int64)
                    seg[idx] = ids
                    rep = idx[first]  # any instance of a cell has its two blocks
                    sites.append(NormalSite(
                        fi=fi, j1=a, j2=b, diagonal=diagonal, transpose=transpose,
                        plan=None if device is None else build_reduce_plan(seg, C, device),
                        rows=rs[rep].astype(np.int64), cols=cs[rep].astype(np.int64),
                    ))
    return sites


def _site_keys(sites, n: int) -> list:
    """(identity, cell keys, block shape) of each site (``cell_layout``)."""
    return [((s.fi, s.j1, s.j2, s.diagonal, s.transpose), s.rows[:, 0] * (n + 1) + s.cols[:, 0],
             (s.rows.shape[1], s.cols.shape[1])) for s in sites]


def build_normal_plan(program) -> NormalPlan:
    """Enumerate the unique block-pair cells of H per family arg pair and
    build their reduce plans on the program's device (the symbolic half of
    inner_product_computer.cc ComputeOffsetsAndCreateResultMatrix). On a
    sharded program the sites are this rank's rows', laid out in the whole
    program's cells (``Program.unsharded``: the same list on every rank)."""
    nt = program.num_tangent
    sites = tuple(_normal_sites(program, program.device))
    if program.comm is None:
        return NormalPlan(sites=sites, num_tangent=nt)
    whole = tuple(_normal_sites(program.unsharded(), None))
    layout = cell_layout(_site_keys(sites, nt), _site_keys(whole, nt), program.device)
    return NormalPlan(sites=sites, num_tangent=nt, whole=whole, layout=layout)


def normal_assembly(program):
    """(plan, CSC assembly) of the program's J'J, built once per program (a
    sharded program is kept per mesh) and kept in its
    ``solve_aux_cache``."""
    cached = program.solve_aux_cache.get("normal_assembly")
    if cached is None:
        plan = build_normal_plan(program)
        cached = program.solve_aux_cache["normal_assembly"] = (plan, build_normal_assembly(plan))
    return cached


def compute_normal_cells(ctx, plan: NormalPlan) -> Tuple[torch.Tensor, ...]:
    """The reduced H cell blocks on the card, one (C, Tr, Tc) tensor per
    site, in the assembly's site order. On a sharded program the whole
    program's cells: this rank's placed in its layout and all-reduced
    (:func:`summed_cells`)."""
    out = []
    for site in plan.sites:
        X = torch.einsum("bri,brj->bij", ctx.jacs[site.fi][site.j1], ctx.jacs[site.fi][site.j2])
        if site.transpose:
            X = X.transpose(1, 2)
        blocks = apply_reduce(site.plan, X)[: site.rows.shape[0]]
        if site.diagonal and site.j1 != site.j2:
            # (j1, j2) and (j2, j1) both land on this diagonal cell
            blocks = blocks + blocks.transpose(1, 2)
        out.append(blocks)
    if plan.layout is None:
        return tuple(out)
    return summed_cells(ctx, place_cells(plan.layout, out, ctx.residuals[0]))


@dataclasses.dataclass
class CscAssembly:
    """Upper-triangular CSC pattern of a symmetric block matrix and the map
    from every cell value (the sites' (C, T1, T2) blocks, flattened and
    concatenated) to its place in the CSC data; entries of no place go to
    the trash slot ``nnz``."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32 rows, ascending in each column
    pos: np.ndarray  # (values,) int64 into data, trash = nnz
    diag_pos: np.ndarray  # (n,) positions of the diagonal
    nnz: int
    cholesky: Optional[dict] = None  # SparseCholesky per ordering, made at first solve

    def scatter(self, cell_values) -> np.ndarray:
        """CSC data of the cells (f64), one ``np.bincount``."""
        vals = np.concatenate([np.asarray(b, dtype=np.float64).ravel() for b in cell_values])
        return np.bincount(self.pos, weights=vals, minlength=self.nnz + 1)[: self.nnz]


def csc_assembly(n: int, keys_parts, valid_parts) -> CscAssembly:
    """The assembly of cell values whose CSC keys (col * n + row) are
    ``keys_parts``, those outside ``valid_parts`` going to the trash; the
    diagonal is always present (the damping lands there)."""
    all_keys = np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.int64)
    all_valid = np.concatenate(valid_parts) if valid_parts else np.zeros(0, bool)
    diag_keys = np.arange(n, dtype=np.int64) * (n + 1)
    uniq, inverse = np.unique(np.concatenate([all_keys[all_valid], diag_keys]),
                              return_inverse=True)
    nnz = uniq.shape[0]
    pos = np.full(all_keys.shape[0], nnz, dtype=np.int64)
    n_valid = int(all_valid.sum())
    pos[all_valid] = inverse[:n_valid]
    return CscAssembly(
        n=n,
        indptr=np.searchsorted(uniq // n, np.arange(n + 1)).astype(np.int64),
        indices=(uniq % n).astype(np.int32),
        pos=pos,
        diag_pos=inverse[n_valid:],
        nnz=nnz,
    )


def build_normal_assembly(plan: NormalPlan) -> CscAssembly:
    """The CSC assembly of H = J'J from the plan's sites, the whole
    program's on a sharded program (host, once)."""
    n = plan.num_tangent
    keys_parts, valid_parts = [], []
    for site in plan.whole or plan.sites:
        C, T1 = site.rows.shape
        T2 = site.cols.shape[1]
        r = np.broadcast_to(site.rows[:, :, None], (C, T1, T2))
        c = np.broadcast_to(site.cols[:, None, :], (C, T1, T2))
        valid = (r < n) & (c < n)
        if site.diagonal:
            valid &= r <= c
        keys_parts.append((c * n + r).reshape(-1))
        valid_parts.append(valid.reshape(-1))
    return csc_assembly(n, keys_parts, valid_parts)


def _damped_data(assembly: CscAssembly, cell_values, D: np.ndarray,
                 mixed_precision: bool = False) -> np.ndarray:
    """The CSC data of the cells with D^2 added to the diagonal (f64)."""
    data = assembly.scatter(cell_values)
    D64 = np.asarray(D, dtype=np.float64)
    if mixed_precision:
        # The f32 factor's damping floor (the f32 branch of the LM damping at
        # the factor's precision): D^2 below eps_f32 * diag(H) adds nothing
        # once the values are f32.
        hdiag = np.maximum(data[assembly.diag_pos], 0.0)
        D64 = np.maximum(D64, np.sqrt(hdiag) * 3.5e-4)
    data[assembly.diag_pos] += D64 * D64
    if assembly.cholesky is None:
        assembly.cholesky = {}
    return data


def host_normal_factor_solve(assembly: CscAssembly, cell_values, D: np.ndarray, rhs: np.ndarray,
                        ordering: str = "AMD", use_postordering: bool = False,
                        mixed_precision: bool = False, num_refinement_iterations: int = 3):
    """Scatter the cell values into the CSC data, add D^2 to the diagonal,
    refactor on the cached symbolic analysis and solve (``mixed_precision``:
    f32 factor, f64 refinement). Returns (y f64, termination code)."""
    from ceres_tpu_torch.linear.sparse_cholesky import factor_solve_csc

    data = _damped_data(assembly, cell_values, D, mixed_precision)
    return factor_solve_csc(
        assembly.cholesky, assembly.n, assembly.indptr, assembly.indices, data, rhs,
        ordering=ordering, use_postordering=use_postordering, mixed_precision=mixed_precision,
        num_refinement_iterations=num_refinement_iterations,
    )


def host_normal_factor(assembly: CscAssembly, cell_values, D: np.ndarray, ordering: str = "AMD",
                       use_postordering: bool = False):
    """The cells' matrix with D^2 on its diagonal factored in f64 on the
    cached symbolic analysis (the one :func:`host_normal_factor_solve`
    keeps): the ``SparseCholesky``, ready to solve, or None where a pivot is
    not positive."""
    from ceres_tpu_torch.linear.sparse_cholesky import cached_factor

    data = _damped_data(assembly, cell_values, D)
    chol = cached_factor(assembly.cholesky, assembly.n, assembly.indptr, assembly.indices,
                         ordering, use_postordering)
    return chol if chol.factorize(data) == 0 else None
