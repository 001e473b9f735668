"""Inner iterations: coordinate descent over independent sets (port of
``ceres_tpu/inner_iterations.py``; analog of
``internal/ceres/coordinate_descent_minimizer.{h,cc}`` and the independent
sets of ``parameter_block_ordering.cc``).

The reference partitions the parameter blocks into independent sets (no two
blocks of a set share a residual) and runs a small trust-region solve for
every block of a set. Because the blocks of a set are independent, all of
them advance at once from one global evaluation: each residual sees at most
one block of the set. A batched per-block LM step is then one evaluation,
per-block gradients and J'J blocks through reduce plans, batched (T, T)
solves, per-block cost segments and a masked update.

Every per-block sum goes through a gather plan built once per (set, family,
arg) (``ops/reduce.build_gather_plan``), so it is summed in one fixed order
on every device: a point set takes the sorted segment-sum kernel (K1) over
its rows in block order, a camera set of a few hundred blocks the unsorted
one (K3), a few blocks a one-hot matmul, never ``index_add_``. As the JAX
package's ``.at[pos].add(..., mode="drop")``, a row whose block is not in
the set adds to no block. As in the JAX package, the step is built in f64
whatever the evaluation dtype: the per-observation products are formed in
the evaluation dtype and summed into f64 per-block gradients and J'J blocks,
the trust radii, the damped (T, T) solves and the delta are f64, and
``program.plus`` adds the delta to x in x's own dtype, so an f32 x stays
f32. The per-block costs the accept test compares are summed in f64 too.
The damped (T, T) blocks are solved by ``torch.linalg.solve_ex`` with
``check_errors=False``: the LU of ``torch.linalg.solve`` without its read of
the factorization's status, so a step never waits for the device (a CUDA
graph captures it, ``tools/capture_ops.py``). H + diag(clip(diag H) / r) is
symmetric positive definite wherever H is finite; a block that is not has a
non-finite step, whose cost test fails, and the block stays where it was.

The sets and plans (the coloring is most of the set-up) are made once per
program and ``inner_iteration_ordering`` and kept in
``Program.solve_aux_cache`` (:func:`inner_structure`). A pass runs on
``host_loop_graphs.InnerRegions``: each set step is a region over static
buffers (the point, the radii, the cost), a CUDA graph on the card where
the host loop's regions are captured, and the pass reads the host once, its
final cost.

On a sharded program (``parallel/sharding.py``) the sets come from the
whole program, the same on every rank, and the per-block gradients, J'J
blocks and costs, sums over rows, are all-reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.evaluator import _context_impl, _cost_impl, family_residuals
from ceres_tpu_torch.ops.reduce import apply_reduce, build_gather_plan, choose_gather_plan_kind
from ceres_tpu_torch.ordered_groups import normalize_ordering, validate_independent_set
from ceres_tpu_torch.problem import _ragged_ranges


def _block_graph(program):
    """The block-sharing graph of the active blocks as CSR (ptr, nbr): nbr
    of block p is nbr[ptr[p]:ptr[p + 1]], ascending and without repeats.
    Two blocks are neighbours when one residual row holds both."""
    n = program.num_pids
    active = program.active
    codes = []
    for fam in program.families:
        ids = np.asarray(fam.block_ids, dtype=np.int64)
        live = active[ids]
        for a in range(ids.shape[1]):
            for b in range(ids.shape[1]):
                if a != b:
                    m = live[:, a] & live[:, b]
                    codes.append(ids[m, a] * n + ids[m, b])
    codes = np.unique(np.concatenate(codes)) if codes else np.zeros(0, np.int64)
    src, nbr = codes // n, codes % n
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=ptr[1:])
    return ptr, nbr


def compute_independent_sets(program) -> List[List[int]]:
    """Greedy coloring of the block-sharing graph into independent sets,
    each set's ids ascending, the sets by size, largest first (stably).
    The rule of the JAX package's native core
    (``native/ceres_tpu_core.cpp``, ``independent_set_coloring``): blocks
    are visited by degree, larger first, ties by smaller id, and each takes
    the smallest color no neighbour visited before it has.

    The visits are batched without changing the result: a block is colored
    as soon as every neighbour that comes before it in the visiting order
    is, so each round colors a set of blocks that no edge joins, each from
    its earlier neighbours' colors alone, as the one-by-one visit would.
    """
    if not program.families:
        return []
    n = program.num_pids
    ptr, nbr = _block_graph(program)
    deg = np.diff(ptr)
    pids = np.nonzero(program.active)[0]
    order = pids[np.lexsort((pids, -deg[pids]))]
    rank = np.full(n, n, dtype=np.int64)
    rank[order] = np.arange(order.shape[0])
    src = np.repeat(np.arange(n), deg)
    earlier = rank[nbr] < rank[src]  # edge (v, u): u is visited before v
    waiting = np.bincount(src[earlier], minlength=n)
    color = np.full(n, -1, dtype=np.int64)
    ready = pids[waiting[pids] == 0]
    while ready.size:
        edges = _ragged_ranges(ptr[ready], deg[ready])
        v, u = src[edges], nbr[edges]
        before = earlier[edges]
        # smallest color not among the earlier neighbours' (their mex)
        # (no ufunc.at: it is slow in older numpy)
        pairs = np.unique(v[before] * (n + 1) + color[u[before]])
        pv, pc = pairs // (n + 1), pairs % (n + 1)
        pos = np.arange(pv.shape[0]) - np.searchsorted(pv, pv, side="left")
        mex = np.bincount(pv, minlength=n)  # no gap below the largest color
        gap = pc != pos  # ascending within each block: its first gap is the mex
        gv, gpos = pv[gap], pos[gap]
        first = np.flatnonzero(np.diff(gv, prepend=-1))
        mex[gv[first]] = gpos[first]
        color[ready] = mex[ready]
        # the later neighbours of this round wait for one block fewer each
        later = u[~before]
        waiting -= np.bincount(later, minlength=n)
        cand = np.unique(later)
        ready = cand[(waiting[cand] == 0) & (color[cand] < 0)]
    sets = [np.nonzero(color == c)[0].tolist() for c in range(int(color.max()) + 1)]
    sets.sort(key=len, reverse=True)
    return sets


@dataclasses.dataclass
class InnerStructure:
    """The independent sets of a program and, per set and tangent size T,
    the (G_T, T) tangent coordinates of its blocks and per family and arg of
    size T the gather plan summing the batch into the group's rows by the
    instance's block position in the group (G_T: not in the set, dropped);
    ``segment_ids`` (set, T, G_T, ids) per plan."""

    sets: List[List[int]]
    set_structs: list
    segment_ids: list


def _ordering_key(ordering) -> Optional[tuple]:
    groups = normalize_ordering(ordering)
    return None if groups is None else tuple(tuple(int(p) for p in g) for g in groups)


def inner_structure(program, ordering) -> InnerStructure:
    """The sets and plans of ``program`` for ``ordering`` (a user's
    ``inner_iteration_ordering``, or None for the coloring), made at the
    first call and kept in ``program.solve_aux_cache``."""
    key = ("inner_structure", _ordering_key(ordering))
    hit = program.solve_aux_cache.get(key)
    if hit is None:
        hit = program.solve_aux_cache[key] = _build_structure(program, ordering)
    return hit


def _build_structure(program, user) -> InnerStructure:
    whole = program.unsharded()
    if user is not None:
        # User groups (Solver::Options::inner_iteration_ordering):
        # validated as independent sets, visited in group order
        # (coordinate_descent_minimizer.cc IsOrderingValid).
        sets = []
        for g in normalize_ordering(user):
            g = [int(p) for p in g if program.active[int(p)]]
            if not g:
                continue
            validate_independent_set(whole, g)
            sets.append(g)
    else:
        sets = compute_independent_sets(whole)
    dev = program.device
    tsizes = program.tangent_sizes
    set_structs, segment_ids = [], []
    for si, s in enumerate(sets):
        s = np.asarray(s, dtype=np.int64)
        groups = {}
        for T in dict.fromkeys(tsizes[s].tolist()):
            members = s[tsizes[s] == T]
            G = members.shape[0]
            pos = np.full(program.num_pids, G, dtype=np.int64)
            pos[members] = np.arange(G)
            rows = program.tangent_offsets[members][:, None] + np.arange(T)
            plans = []
            for fam in program.families:
                fam_plans = []
                for j in range(fam.num_args):
                    plan = None
                    if fam.structure.tangent_sizes[j] == T:
                        seg = pos[fam.block_ids[:, j]]
                        plan = build_gather_plan(seg, G, dev)
                        segment_ids.append((si, T, G, seg))
                    fam_plans.append(plan)
                plans.append(tuple(fam_plans))
            groups[T] = (torch.from_numpy(rows).to(dev), tuple(plans))
        set_structs.append(groups)
    return InnerStructure(sets, set_structs, segment_ids)


class CoordinateDescentMinimizer:
    """Batched inner-iteration minimizer over one Program, its passes on
    ``regions`` (``host_loop_graphs.InnerRegions``: the host loop's, which
    it keeps between solves; eager regions of its own by default)."""

    def __init__(self, program, options, evaluator, regions=None):
        self.program = program
        self.options = options
        self.apply_loss = True if evaluator is None else evaluator.apply_loss
        structure = inner_structure(program, options.inner_iteration_ordering)
        self.sets = structure.sets
        self._set_structs = structure.set_structs
        self._segment_ids = structure.segment_ids
        self.num_steps = 3  # batched LM steps per set per pass
        if regions is None:
            from ceres_tpu_torch.host_loop_graphs import InnerRegions

            regions = InnerRegions(program.device, captured=False)
        self.regions = regions

    def plan_kinds(self, device_type=None) -> List[Tuple[int, int, int, str]]:
        """(set, T, G_T, kind) of every plan: the kinds built, or those a
        device of ``device_type`` ("cpu", "cuda") would get, which are the
        same (``ops/reduce.choose_gather_plan_kind``)."""
        if device_type is None:
            built = [p for groups in self._set_structs for _, plans in groups.values()
                     for fp in plans for p in fp if p is not None]
            return [(si, T, G, p.kind)
                    for (si, T, G, _), p in zip(self._segment_ids, built)]
        return [(si, T, G, choose_gather_plan_kind(seg, G))
                for si, T, G, seg in self._segment_ids]

    def _set_step(self, groups, x: torch.Tensor, radii: Dict[int, torch.Tensor]):
        """One batched LM step for every block of a set: (new x, new radii,
        cost at new x as an f64 device scalar)."""
        program, opts = self.program, self.options
        families = program.families
        apply_loss = self.apply_loss
        comm = program.comm
        _, ctx = _context_impl(x, families, program.num_tangent, program.groups, apply_loss, comm)
        f64 = torch.float64
        delta = torch.zeros((program.num_tangent,), dtype=f64, device=x.device)
        for T, (rows, plans) in groups.items():
            G = rows.shape[0]
            g = torch.zeros((G + 1, T), dtype=f64, device=x.device)
            H = torch.zeros((G + 1, T, T), dtype=f64, device=x.device)
            for fi in range(len(families)):
                for plan, J in zip(plans[fi], ctx.jacs[fi]):
                    if plan is None:
                        continue
                    gj = torch.einsum("brt,br->bt", J, ctx.residuals[fi])
                    g = g + apply_reduce(plan, gj.to(f64))
                    H = H + apply_reduce(plan, torch.einsum("bri,brj->bij", J, J).to(f64))
            if comm is not None:
                g, H = comm.sum_all([g, H])
            g, H = g[:G], H[:G]
            diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                               opts.min_lm_diagonal, opts.max_lm_diagonal)
            damped = H + torch.diag_embed(diag / radii[T][:, None])
            step = -torch.linalg.solve_ex(damped, g[..., None], check_errors=False)[0][..., 0]
            delta[rows.reshape(-1)] = step.reshape(-1)
        # Per-block accept: each block's cost segments at x and at the
        # candidate, summed in f64.
        candidate = program.plus(x, delta)
        sq = []
        for fi, fam in enumerate(families):
            r_new = family_residuals(fam, candidate)
            sq_new = torch.sum(r_new * r_new, dim=-1)
            if apply_loss and fam.loss is not None:
                # ctx.residuals are corrected; use raw residuals for both
                raw_old = family_residuals(fam, x)
                sq_old = fam.loss.evaluate(torch.sum(raw_old * raw_old, dim=-1))[0]
                sq_new = fam.loss.evaluate(sq_new)[0]
            else:
                sq_old = torch.sum(ctx.residuals[fi] * ctx.residuals[fi], dim=-1)
            sq.append(((0.5 * sq_old).to(torch.float64), (0.5 * sq_new).to(torch.float64)))
        new_radii = {}
        for T, (rows, plans) in groups.items():
            G = rows.shape[0]
            c_old = torch.zeros((G + 1,), dtype=torch.float64, device=x.device)
            c_new = torch.zeros((G + 1,), dtype=torch.float64, device=x.device)
            for fi in range(len(families)):
                for plan in plans[fi]:
                    if plan is not None:
                        c_old = c_old + apply_reduce(plan, sq[fi][0])
                        c_new = c_new + apply_reduce(plan, sq[fi][1])
            if comm is not None:
                c_old, c_new = comm.sum_all([c_old, c_new])
            accept = c_new[:G] < c_old[:G]
            new_radii[T] = torch.where(accept, radii[T] * 2.0, radii[T] * 0.25)
            idx = rows.reshape(-1)
            delta[idx] = torch.where(accept[:, None], delta[rows], 0.0).reshape(-1)
        new_x = program.plus(x, delta)
        return new_x, new_radii, _cost_impl(new_x, families, apply_loss, comm)

    def minimize(self, x: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """One inner-iteration pass from x: (a copy of the new point, its
        cost), one host read. Each set's radii start at the initial trust
        region radius (a device fill), then each of its steps is a run of
        its region."""
        regions = self.regions
        regions.start(x)
        r0 = self.options.initial_trust_region_radius
        for si, groups in enumerate(self._set_structs):
            regions.fill_radii(si, {T: rows.shape[0] for T, (rows, _) in groups.items()}, r0)
            for _ in range(self.num_steps):
                regions.set_step(si, lambda x_, radii, g=groups: self._set_step(g, x_, radii))
        cost = float(regions.cost.cpu())  # the pass's one read
        return regions.x.clone(), cost
