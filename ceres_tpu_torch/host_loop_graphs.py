"""The host loop's device work between its decisions, in static buffers and,
on the card, as CUDA graphs (the JAX package jits each of these pieces:
``trust_region._tr_iteration_impl``, ``_lm_step_impl``,
``_scale_columns_jit``, ``_candidate_impl``, ``_plus_jit``, the evaluator's
entry points, DOGLEG's ``precompute``, ``traditional``, ``subspace_model``
and ``model_cost_change``, and the inner iterations' ``set_step``).

``HostLoopGraphs`` holds, for one program and option set, a region per
piece: a function that reads static device buffers (the current point x,
its residuals, Jacobian blocks and gradient, the radius and DOGLEG's mu as
device scalars, the Jacobi scaling, a trial point) and copies its results
into static buffers of its own, so that every call is the same device
work on the same memory. The host writes an input (a fill, or a copy of
the point to evaluate) and runs the region; what it reads it reads from
the region's scalar vector, once, where the JAX package's ``device_get``
reads. With ``captured`` (the card, ``fused_lm.host_loop_capturable``)
each region is captured at its first call, after an eager warm-up that
allocates its buffers and whose launches count nowhere, as one CUDA graph,
its CG a WHILE node (``linear/cg.py``), and replayed after; every graph of
the object allocates from the first one's memory pools. Otherwise the
same functions run eagerly on the same buffers: the CPU, a gloo mesh
(an NCCL mesh's collectives are captured with the rest,
``parallel/sharding.py``), the C API's host callbacks, and the eager
baseline (``tools/profile_solve.eager_host_loop``).
Nothing falls back: a failed capture raises.

Regions:

- ``full`` (``Evaluator.cost_gradient_jacobian``): the cost, gradient and
  loss-corrected Jacobian blocks at ``x``, the current point.
- ``cost``, ``cost_and_gradient`` (``Evaluator.cost`` and
  ``Evaluator.cost_and_gradient``): at the trial point.
- ``scale``: the current Jacobian with its columns scaled (Jacobi scaling,
  fixed at iteration 0), once per evaluation.
- ``lm_step``: the LM step on the scaled Jacobian at the radius: the step,
  and (model cost change, linear iterations, termination).
- ``candidate``: x [+] scaling * step, its cost and the step and x norms.
- ``iteration``: the fused iteration (step, candidate and a speculative
  full evaluation at the candidate; eight scalars), into candidate buffers;
  ``accept`` copies the candidate into the current buffers.
- ``dogleg``: DOGLEG's Gauss-Newton solve with its Cauchy point at mu;
  ``dogleg_traditional``, ``dogleg_subspace_model`` and
  ``dogleg_subspace_step``: its step choice (``DoglegRegions``).
- ``jacobi_scaling``: the solve's Jacobi scaling from the current Jacobian
  at iteration 0.
- ``bounded_line`` and ``bounded_trial``: the bounds line search's
  direction scaling * step with phi'(0), and a trial clamp(x [+] a delta)
  with its cost and norms, the step a a device scalar.
- ``inner_set_{si}``: an inner-iteration step of independent set si
  (``InnerRegions``, one object per ``inner_iteration_ordering``, kept with
  the others and sharing their pools).

The sparse solvers' steps factor on the host between two regions of
``SparseRegions`` (the JAX package jits ``_sparse_prep_radius_free_impl``,
``_sparse_prep_impl``, ``_sparse_finish_impl``, ``_normal_cells_impl``,
``_sparse_schur_prep_impl`` and ``_sparse_schur_finish_impl``), which read
the step's context (the current or scaled buffers) and write one flat
buffer that the host reads once (``read_flat``: the parts joined in the
first one's dtype), or take the host's solution copied into a static
buffer before the replay. On a sharded program each prep holds the one
all-reduce of the rank's cells (the diagonal and right-hand side are sums
already) and each finish the broadcast of rank 0's solution:

- ``sparse_normal_prep``: SPARSE_NORMAL_CHOLESKY's radius-free half, the
  clipped LM diagonal, J'f and every J'J cell;
- ``sparse_normal_damped``: under ``dynamic_sparsity``, the damping at the
  radius (a device scalar), J'f and the Jacobian's blocks (on a sharded
  program its rows gathered);
- ``sparse_finish``: the step -y and its model cost change;
- ``dogleg_sparse_prep``: DOGLEG's Gauss-Newton solve under
  SPARSE_NORMAL_CHOLESKY (``dogleg.SparseGaussNewton``), its Cauchy terms
  kept, the diagonal, J'f and every J'J cell read (with
  ``use_mixed_precision_solves`` those of the f32 solve's system);
- ``dogleg_sparse_refine``: with ``use_mixed_precision_solves``, the f64
  refinement residual of the host's solution, read once a refinement step;
- ``dogleg_sparse_finish``: its Gauss-Newton step from the host's
  solution and the checks vector, into the ``dogleg`` region's buffers;
- ``sparse_schur_prep_{0,1}``: SPARSE_SCHUR's eliminator pass at the
  radius of its set: the damping, the point blocks' inverses (kept for the
  finish), every reduced cell, the reduced rhs and the cameras' damping.
  Two sets, each with its own radius scalar and buffers, because inside a
  reject streak the step enqueues the prep at the predicted radius into
  the other set while the host factors this one;
- ``sparse_schur_finish_{0,1}``: the points back-substituted with that
  set's blocks, the step and its model cost change.

The line-search minimizer's device work is ``LineSearchGraphs``' (the JAX
package jits the evaluator's ``_cost_grad_impl`` and GradientProblem's
``_cost_grad``): two regions over static buffers of their own, made the
same way:

- ``start`` (``cost_and_gradient``): the cost and tangent gradient at the
  search's point x itself (on a manifold x [+] 0 need not give x's bits).
- ``phi``: phi(a) = f(x [+] a d) for the point x, direction d (``line``)
  and step a, a device scalar filled before the replay: the point, its
  cost and gradient and d'g, the cost and d'g in one f64 vector for the
  host's one read. The point and gradient are handed out as copies, which
  no later call overwrites (a search keeps several points at once).

Their graphs hold no conditional node, so each replay credits its
launches on the host, with no read (``CapturedGraph.credit_replay``).
``ProgramLineSearchGraphs`` evaluates a Program (kept per dtype, device and
losses in ``Program.solve_aux_cache``, ``line_search_graphs``);
``gradient_problem`` has its own for a GradientProblem. Their eligibility
is ``fused_lm.regions_capturable``.

The current buffers change only through ``full`` and ``accept``: a
JacobianContext or gradient the host loop holds stays valid until its next
evaluation. ``cost`` and ``cost_and_gradient`` return copies, which no
later call overwrites. A program keeps one such object per option set,
dtype and device in ``Program.solve_aux_cache`` (``host_loop_graphs``), as
it keeps its fused loops.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ceres_tpu_torch import dogleg
from ceres_tpu_torch.evaluator import (
    JacobianContext,
    _cost_grad_impl,
    _cost_impl,
    _full_impl,
)
from ceres_tpu_torch.linear.inner_product import compute_normal_cells
from ceres_tpu_torch.linear.schur import SchurOperator
from ceres_tpu_torch.linear.sparse_schur import _sparse_schur_finish_impl, _sparse_schur_prep_impl
from ceres_tpu_torch.trust_region import (
    _F64,
    _SolveConfig,
    _candidate_impl,
    _linear_solve,
    _lm_step_impl,
    _model_cost_change,
    _sparse_finish_impl,
    _sparse_prep_impl,
    _sparse_prep_radius_free_impl,
    _tr_iteration_impl,
)
from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, pool_bytes, uncounted


@dataclasses.dataclass(frozen=True)
class HostLoopConfig:
    """What the regions' device work depends on besides the program (the
    host loop's evaluations always apply the losses)."""

    solve: _SolveConfig
    jacobi_scaling: bool


class _Regions:
    """Regions over static buffers on one device, captured at their first
    call where ``captured`` (the machinery of the module's docstring)."""

    def __init__(self, device: torch.device, captured: bool):
        self.device, self.captured = device, captured
        self._bufs: dict = {}  # region outputs by name, allocated at their first (eager) run
        self.graphs: dict = {}  # region name -> CapturedGraph
        self._pool_owner: Optional[CapturedGraph] = None
        self.capture_seconds = 0.0
        self._inputs: dict = {}  # host arrays by name, copied in before a region
        self._staged: dict = {}  # their pinned host copies and copy events, on the card

    def _keep(self, name: str, *tensors: torch.Tensor) -> list:
        """Copy ``tensors`` into the static buffers ``name``, made like them
        at the first call (always an eager run: a capture is preceded by
        one)."""
        bufs = self._bufs.get(name)
        if bufs is None:
            bufs = self._bufs[name] = [torch.empty_like(t) for t in tensors]
        for b, t in zip(bufs, tensors):
            b.copy_(t)
        return bufs

    def _run(self, name: str, fn) -> None:
        """Run region ``name``: replay its graph, or run ``fn`` eagerly, or
        (captured, first call) warm up, capture and replay."""
        graph = self.graphs.get(name)
        if graph is not None:
            graph.replay()
            return
        if not self.captured:
            fn()
            return
        t0 = time.perf_counter()
        self._warm_up(fn)
        graph = CapturedGraph(fn, self.device, share=self._pool_owner)
        self._pool_owner = self._pool_owner or graph
        self.graphs[name] = graph
        self.capture_seconds += time.perf_counter() - t0
        graph.replay()

    def _warm_up(self, fn) -> None:
        """The eager run before a capture, its launches counted nowhere."""
        with uncounted():
            fn()

    def _host_input(self, name: str, array: np.ndarray, dtype: torch.dtype) -> None:
        """Copy a host array into the static device buffer ``name`` (in
        ``dtype``), outside any region. On the card through a pinned
        staging buffer of its own, without waiting for the device (a copy
        from pageable memory waits for the stream, a read by another name);
        the staging buffer is written again only once its last copy is
        done (an event, normally long passed)."""
        host = torch.from_numpy(np.asarray(array))
        buf = self._inputs.get(name)
        if buf is None:
            buf = self._inputs[name] = torch.empty(host.shape, dtype=dtype, device=self.device)
        if self.device.type != "cuda":
            buf.copy_(host)
            return
        staged = self._staged.get(name)
        if staged is None:
            staged = self._staged[name] = (torch.empty(host.shape, dtype=dtype, pin_memory=True),
                                           torch.cuda.Event())
        pinned, done = staged
        done.synchronize()
        pinned.copy_(host)
        buf.copy_(pinned, non_blocking=True)
        done.record()

    def _graph_list(self) -> list:
        """Every graph these regions account for."""
        return list(self.graphs.values())

    def credit(self) -> None:
        """Credit the graphs' kernel launches since the last credit (one
        host read of their run counters)."""
        graphs = self._graph_list()
        if not graphs:
            return
        counts = torch.cat([g.launch_counts() for g in graphs]).cpu().tolist()
        k = 0
        for g in graphs:
            n = g.launch_counts().numel()
            g.credit(counts[k : k + n])
            k += n

    @property
    def graph_launches(self) -> int:
        """Kernel launches credited from the graphs' replays so far."""
        return sum(g.launches for g in self._graph_list())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pools hold."""
        graphs = self._graph_list()
        return pool_bytes(graphs) if graphs else 0


class InnerRegions(_Regions):
    """The inner iterations' device work (``inner_iterations.
    CoordinateDescentMinimizer``; the JAX package jits one ``set_step`` per
    independent set) over static buffers: the pass's point x, each set's
    per-block trust radii (one f64 vector per tangent size) and the cost.
    Region ``inner_set_{si}`` is one batched LM step of every block of set
    si from x, which it overwrites with the new point, as it overwrites the
    set's radii with the new radii and the cost with the new point's (each
    written after every read of it, in the graph's one stream). A pass
    copies its start into x, fills a set's radii before its first step,
    runs the set's region once per step and reads the cost once. Each
    replay credits its launches on the host, with no read (the graphs hold
    no conditional node). With ``share`` (the host loop's
    ``HostLoopGraphs``) the graphs allocate from its memory pools, and its
    ``credit``, ``graph_launches`` and ``pool_bytes`` cover them."""

    def __init__(self, device: torch.device, captured: bool, share: Optional[_Regions] = None):
        super().__init__(device, captured)
        self._share = share
        self.x: Optional[torch.Tensor] = None
        self.cost = torch.zeros((), dtype=_F64, device=device)
        self.radii: dict = {}  # (set, T) -> (G_T,) f64

    def _run(self, name: str, fn) -> None:
        share = self._share
        if share is not None and self._pool_owner is None:
            self._pool_owner = share._pool_owner
        super()._run(name, fn)
        if share is not None and share._pool_owner is None:
            share._pool_owner = self._pool_owner
        graph = self.graphs.get(name)
        if graph is not None:
            graph.credit_replay()

    def _warm_up(self, fn) -> None:
        """A set step overwrites its own inputs: the warm-up before a capture
        leaves the point, radii and cost as it found them, so that the
        replay after the capture is the pass's one step."""
        kept = [t.clone() for t in (self.x, self.cost, *self.radii.values())]
        super()._warm_up(fn)
        for t, k in zip((self.x, self.cost, *self.radii.values()), kept):
            t.copy_(k)

    def start(self, x: torch.Tensor) -> None:
        """A pass from x (copied into the static point)."""
        if self.x is None:
            self.x = torch.empty_like(x)
        self.x.copy_(x)

    def fill_radii(self, si: int, sizes: dict, radius: float) -> None:
        """Set si's radii ({T: G_T}) to ``radius``, a device fill."""
        for T, G in sizes.items():
            buf = self.radii.get((si, T))
            if buf is None:
                buf = self.radii[si, T] = torch.empty((G,), dtype=_F64, device=self.device)
            buf.fill_(radius)

    def set_step(self, si: int, step) -> None:
        """One step of set si: ``step(x, radii)`` -> (new x, new radii, cost)
        (``CoordinateDescentMinimizer._set_step`` on the set's plans)."""
        self._run(f"inner_set_{si}", lambda: self._set_step(si, step))

    def _set_step(self, si: int, step) -> None:
        radii = {T: r for (s, T), r in self.radii.items() if s == si}
        new_x, new_radii, cost = step(self.x, radii)
        self.x.copy_(new_x)
        for T, r in radii.items():
            r.copy_(new_radii[T])
        self.cost.copy_(cost)


class DoglegRegions(_Regions):
    """DOGLEG's step choice over ``precompute``'s outputs (the JAX package
    jits ``traditional``, ``subspace_model`` and ``model_cost_change``):

    - ``dogleg_traditional``: the traditional step at the radius (a device
      scalar) into "step", its scaled norm and model cost change (f64) in
      one vector;
    - ``dogleg_subspace_model``: the orthonormal basis Q of span(gradient,
      Gauss-Newton step) (kept for the step) and, in one f64 vector, the
      reduced model B and g, |diag R|, ||gradient|| and ||Gauss-Newton
      step||, which the host reads once for its quartic, rank test and
      optimality check;
    - ``dogleg_subspace_step``: the step from the host's coefficients
      (``dogleg.subspace_step``, copied in before the run) into "step" and
      its model cost change.

    Each reads the tuple (context, diagonal, gradient, alpha, gn_step) the
    strategy caches: where ``captured``, the host loop's ``dogleg`` buffers
    and scaled context (``HostLoopGraphs``); otherwise any, eagerly (a
    strategy made without the host loop's regions)."""

    def __init__(self, device: torch.device, captured: bool):
        super().__init__(device, captured)
        self.dogleg_radius = torch.zeros((), dtype=_F64, device=device)
        self._dl: Optional[tuple] = None

    def _use_dogleg(self, cache: tuple) -> None:
        self._dl = cache

    def dogleg_traditional(self, cache: tuple, radius: float):
        """(step, (scaled norm, model cost change) as one f64 device
        vector), static buffers valid until the next step."""
        self._use_dogleg(cache)
        self.dogleg_radius.fill_(radius)
        self._run("dogleg_traditional", self._dogleg_traditional)
        return self._bufs["step"][0], self._bufs["dogleg_scalars"][0]

    def _dogleg_traditional(self) -> None:
        ctx, diagonal, gradient, alpha, gn_step = self._dl
        step, norm = dogleg.traditional(diagonal, gradient, alpha, gn_step, self.dogleg_radius)
        self._keep("step", step)
        self._keep("dogleg_scalars", torch.stack([norm.to(_F64), _model_cost_change(ctx, step)]))

    def dogleg_subspace_model(self, cache: tuple) -> torch.Tensor:
        """The reduced model's f64 vector (B row-major, g, |diag R|,
        ||gradient||, ||gn_step||) for one read; Q stays on the device."""
        self._use_dogleg(cache)
        self._run("dogleg_subspace_model", self._dogleg_subspace_model)
        return self._bufs["dogleg_model"][1]

    def _dogleg_subspace_model(self) -> None:
        ctx, diagonal, gradient, _, gn_step = self._dl
        Q, B, g2, rdiag = dogleg.subspace_model(ctx, diagonal, gradient, gn_step)
        norms = torch.stack([torch.linalg.norm(gradient), torch.linalg.norm(gn_step)])
        self._keep("dogleg_model", Q, torch.cat(
            [B.reshape(-1).to(_F64), g2.to(_F64), rdiag.to(_F64), norms.to(_F64)]))

    def dogleg_subspace_step(self, cache: tuple, coef: np.ndarray):
        """(step, model cost change as a 1-vector f64) from the host's
        coefficients ``coef`` (``dogleg.subspace_step``) and the basis of
        the last :meth:`dogleg_subspace_model`."""
        self._use_dogleg(cache)
        self._host_input("dogleg_coef", coef, _F64)
        self._run("dogleg_subspace_step", self._dogleg_subspace_step)
        return self._bufs["step"][0], self._bufs["dogleg_mcc"][0]

    def _dogleg_subspace_step(self) -> None:
        ctx, diagonal, gradient, _, _ = self._dl
        step = dogleg.subspace_step(self._bufs["dogleg_model"][0], gradient, diagonal,
                                    self._inputs["dogleg_coef"])
        self._keep("step", step)
        self._keep("dogleg_mcc", _model_cost_change(ctx, step).reshape(1))


class SparseRegions(DoglegRegions):
    """The sparse steps' card halves (``sparse_*`` and ``dogleg_sparse_*``
    in the module's docstring), for ``trust_region._SparseNormalStep``,
    ``linear/sparse_schur.SparseSchurStep`` and
    ``dogleg.SparseGaussNewton``. Each region reads the context its step
    was given: where ``captured``, the host loop's current or scaled
    buffers (``HostLoopGraphs``); otherwise any context, eagerly (a step
    made without the host loop's regions). On a sharded program the
    collectives sit inside the regions: the preps' cells all-reduced (or,
    under ``dynamic_sparsity``, the rows gathered), the host's solution
    broadcast from rank 0 in the finishes."""

    def __init__(self, device: torch.device, captured: bool, solve_config: _SolveConfig):
        super().__init__(device, captured)
        self.solve_config = solve_config
        # SPARSE_SCHUR's radius of each prep set; set 0's also dynamic sparsity's
        self.sparse_radius = tuple(torch.zeros((), dtype=_F64, device=device) for _ in range(2))
        # the host solves' linear iterations and worst termination code, for
        # DOGLEG's checks vector, and its mu for the refinement's damping
        self.sparse_iters = torch.zeros((), dtype=_F64, device=device)
        self.sparse_term = torch.zeros((), dtype=_F64, device=device)
        self.sparse_mu = torch.zeros((), dtype=_F64, device=device)
        self._ctx: Optional[JacobianContext] = None  # the step's context
        self._flat_shapes: dict = {}  # a flat buffer's parts, by name

    def _use(self, ctx: JacobianContext) -> None:
        """The context the next region reads."""
        self._ctx = ctx

    def _keep_flat(self, name: str, *tensors: torch.Tensor) -> None:
        """``tensors`` flattened and joined in the first one's dtype into the
        static buffer ``name``, which :meth:`read_flat` reads once."""
        self._flat_shapes.setdefault(name, [tuple(t.shape) for t in tensors])
        dtype = tensors[0].dtype
        self._keep(name, torch.cat([t.reshape(-1).to(dtype) for t in tensors]))

    def read_flat(self, name: str) -> list:
        """The parts of the flat buffer ``name`` as host arrays, in ONE
        read."""
        host = self._bufs[name][0].cpu().numpy()
        out, k = [], 0
        for shape in self._flat_shapes[name]:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(host[k : k + n].reshape(shape))
            k += n
        return out

    # -- SPARSE_NORMAL_CHOLESKY --------------------------------------------------

    def sparse_normal_prep(self, ctx: JacobianContext, plan) -> None:
        """The radius-free half at ``ctx``: the clipped LM diagonal, J'f and
        every J'J cell of ``plan`` (``linear/inner_product.NormalPlan``; on
        a sharded program the whole program's, all-reduced) into the flat
        buffer "sparse_normal_prep". The cells' plans add in a fixed order
        (``ops/reduce.reduce_plan_kind``)."""
        self._use(ctx)
        self._run("sparse_normal_prep", lambda: self._sparse_normal_prep(plan))

    def _sparse_normal_prep(self, plan) -> None:
        diag, rhs = _sparse_prep_radius_free_impl(self._ctx, self.solve_config)
        self._keep_flat("sparse_normal_prep", diag, rhs, *compute_normal_cells(self._ctx, plan))

    def sparse_normal_damped(self, ctx: JacobianContext, radius: float) -> None:
        """``dynamic_sparsity``'s half at ``ctx`` and ``radius``: the LM
        damping, J'f and the Jacobian's blocks (the whole program's, its
        rows gathered, on a sharded program) into the flat buffer
        "sparse_normal_damped"."""
        self._use(ctx)
        self.sparse_radius[0].fill_(radius)
        self._run("sparse_normal_damped", self._sparse_normal_damped)

    def _sparse_normal_damped(self) -> None:
        ctx, comm = self._ctx, self._ctx.comm
        D, rhs = _sparse_prep_impl(ctx, self.sparse_radius[0], self.solve_config)
        jacs = ctx.jacs
        if comm is not None:
            _, jacs = comm.gather_rows(ctx.families, comm.full_families, ctx.residuals, jacs)
        self._keep_flat("sparse_normal_damped", D, rhs, *(J for js in jacs for J in js))

    def sparse_finish(self, ctx: JacobianContext, y: np.ndarray):
        """The step -y of the host's solution y and its model cost change
        (f64) at ``ctx``, static buffers valid until the next finish."""
        self._use(ctx)
        self._host_input("sparse_y", y, ctx.dtype)
        self._run("sparse_finish", self._sparse_finish)
        return self._bufs["step"][0], self._bufs["sparse_mcc"][0]

    def _sparse_finish(self) -> None:
        step, mcc = _sparse_finish_impl(self._ctx, self._inputs["sparse_y"])
        self._keep("step", step)
        self._keep("sparse_mcc", mcc)

    # -- DOGLEG's Gauss-Newton solve under SPARSE_NORMAL_CHOLESKY ----------------

    def dogleg_sparse_prep(self, ctx: JacobianContext, plan) -> None:
        """DOGLEG's Cauchy terms at ``ctx`` (``dogleg.cauchy``) into the
        buffers "dogleg_sparse", and the diagonal, J'f and every J'J cell of
        ``plan`` into the flat buffer "dogleg_sparse_prep". With
        ``use_mixed_precision_solves`` the f32 solve's system instead, as
        the JAX package's host callback builds it from the Jacobian cast to
        f32: the cells of that Jacobian summed in f64 and J'f in f64 (kept
        too, "dogleg_sparse_rhs", for the refinement), the flat buffer f64."""
        self._use(ctx)
        self._run("dogleg_sparse_prep", lambda: self._dogleg_sparse_prep(plan))

    def _dogleg_sparse_prep(self, plan) -> None:
        c, ctx = self.solve_config, self._ctx
        diagonal, jtf, gradient, alpha = dogleg.cauchy(ctx, c.min_lm_diagonal, c.max_lm_diagonal)
        self._keep("dogleg_sparse", diagonal, gradient, alpha)
        if not c.use_mixed_precision_solves:
            self._keep_flat("dogleg_sparse_prep", diagonal, jtf, *compute_normal_cells(ctx, plan))
            return
        rhs64 = ctx.to_dtype(_F64).gradient()
        self._keep("dogleg_sparse_rhs", rhs64)
        cells = compute_normal_cells(ctx.to_dtype(torch.float32).to_dtype(_F64), plan)
        self._keep_flat("dogleg_sparse_prep", diagonal.to(_F64), rhs64, *cells)

    def dogleg_sparse_refine(self, ctx: JacobianContext, y: np.ndarray, mu: float) -> np.ndarray:
        """The mixed-precision refinement's residual rhs - (J'J + D^2) y in
        f64 at ``ctx`` (``trust_region._linear_solve``), D = diagonal
        sqrt(mu), for the host's f64 solution y (rank 0's, broadcast, and
        the products all-reduced, on a sharded program): one read."""
        self._use(ctx)
        self._host_input("dogleg_y64", y, _F64)
        self.sparse_mu.fill_(mu)
        self._run("dogleg_sparse_refine", self._dogleg_sparse_refine)
        return self.read_flat("dogleg_sparse_refine")[0]

    def _dogleg_sparse_refine(self) -> None:
        ctx, y = self._ctx, self._inputs["dogleg_y64"]
        diagonal = self._bufs["dogleg_sparse"][0]
        if ctx.comm is not None:
            y = ctx.comm.broadcast(y)
        D64 = (diagonal * torch.sqrt(self.sparse_mu).to(diagonal.dtype)).to(_F64)
        r = self._bufs["dogleg_sparse_rhs"][0] - (ctx.to_dtype(_F64).normal_matvec(y)
                                                   + (D64 * D64) * y)
        self._keep_flat("dogleg_sparse_refine", r)

    def dogleg_sparse_finish(self, ctx: JacobianContext, y: np.ndarray, iters: int,
                             term: int) -> tuple:
        """The scaled Gauss-Newton step -diagonal * y of the host's solution
        y and the checks vector (gn_step finite, the host solves' ``iters``,
        their worst termination ``term``), with the prep's terms: the
        ``dogleg`` buffers (diagonal, gradient, alpha, gn_step, checks), as
        :meth:`HostLoopGraphs.dogleg_precompute` returns them."""
        self._use(ctx)
        self._host_input("dogleg_y", y, ctx.dtype)
        self.sparse_iters.fill_(iters)
        self.sparse_term.fill_(term)
        self._run("dogleg_sparse_finish", self._dogleg_sparse_finish)
        return tuple(self._bufs["dogleg"])

    def _dogleg_sparse_finish(self) -> None:
        diagonal, gradient, alpha = self._bufs["dogleg_sparse"]
        y = self._inputs["dogleg_y"]
        if self._ctx.comm is not None:
            y = self._ctx.comm.broadcast(y)
        gn_step = -diagonal * y
        checks = torch.stack([torch.all(torch.isfinite(gn_step)).to(_F64), self.sparse_iters,
                              self.sparse_term])
        self._keep("dogleg", diagonal, gradient, alpha, gn_step, checks)

    # -- SPARSE_SCHUR ------------------------------------------------------------

    def sparse_schur_prep(self, ctx: JacobianContext, radius: float, ss, k: int) -> None:
        """The eliminator pass at ``ctx`` and ``radius`` into set ``k``:
        the reduced rhs, the cameras' damping and every reduced cell in the
        flat buffer "sparse_schur_cells_{k}", the damping and the point
        blocks' inverses kept for :meth:`sparse_schur_finish`."""
        self._use(ctx)
        self.sparse_radius[k].fill_(radius)
        self._run(f"sparse_schur_prep_{k}", lambda: self._sparse_schur_prep(ss, k))

    def _sparse_schur_prep(self, ss, k: int) -> None:
        op, cells, rhs_red, df = _sparse_schur_prep_impl(
            self._ctx, self.sparse_radius[k], ss, self.solve_config)
        self._keep_flat(f"sparse_schur_cells_{k}", rhs_red, df, *cells)
        self._keep(f"sparse_schur_blocks_{k}", op.D, op._ete_inv)

    def sparse_schur_finish(self, ctx: JacobianContext, xf: np.ndarray, ss, k: int):
        """The host's reduced solution xf back-substituted with set ``k``'s
        point blocks: (step, model cost change), as :meth:`sparse_finish`."""
        self._use(ctx)
        self._host_input("sparse_xf", xf, ctx.dtype)
        self._run(f"sparse_schur_finish_{k}", lambda: self._sparse_schur_finish(ss, k))
        return self._bufs["step"][0], self._bufs["sparse_mcc"][0]

    def _sparse_schur_finish(self, ss, k: int) -> None:
        D, ete_inv = self._bufs[f"sparse_schur_blocks_{k}"]
        op = SchurOperator.from_inverse(self._ctx, D, ss, ete_inv)
        step, mcc = _sparse_schur_finish_impl(op, self._inputs["sparse_xf"])
        self._keep("step", step)
        self._keep("sparse_mcc", mcc)


class HostLoopGraphs(SparseRegions):
    """The host loop's regions over one program's static buffers (see the
    module's docstring)."""

    def __init__(self, program, solve_aux: dict, config: HostLoopConfig, captured: bool,
                 losses: tuple):
        super().__init__(program.device, captured, config.solve)
        # the program holds this object, not the other way round: a dropped
        # program frees the graphs' memory at once
        self._program = weakref.ref(program)
        self.solve_aux, self.config, self.losses = solve_aux, config, losses
        self.radius = torch.zeros((), dtype=_F64, device=self.device)
        self.mu = torch.zeros((), dtype=_F64, device=self.device)
        self.x: Optional[torch.Tensor] = None  # the current point
        self.trial_x: Optional[torch.Tensor] = None  # the point of cost / cost_and_gradient
        # the contexts handed out for the current point (name -> context),
        # made anew by every evaluation at x and every accepted candidate
        self._contexts: dict = {}
        self.bounded_a: Optional[torch.Tensor] = None  # the bounds line search's step
        self._inner: dict = {}  # inner_iteration_ordering's key -> InnerRegions

    def inner_regions(self, key) -> InnerRegions:
        """The inner iterations' regions for the ordering ``key``
        (``inner_iterations._ordering_key``), kept between solves."""
        regions = self._inner.get(key)
        if regions is None:
            regions = self._inner[key] = InnerRegions(self.device, self.captured, share=self)
        return regions

    def _graph_list(self) -> list:
        return super()._graph_list() + [g for r in self._inner.values() for g in r.graphs.values()]

    @property
    def program(self):
        return self._program()

    def _context(self, name: str) -> JacobianContext:
        """A JacobianContext over the residual and Jacobian buffers ``name``
        (residuals first, then each family's blocks in order)."""
        p = self.program
        bufs = self._bufs[name]
        nres = len(p.families)
        res, jacs, k = tuple(bufs[:nres]), [], nres
        for fam in p.families:
            jacs.append(tuple(bufs[k : k + fam.num_args]))
            k += fam.num_args
        return JacobianContext(list(p.families), tuple(jacs), res, p.num_tangent, p.groups,
                               p.comm)

    def _keep_context(self, name: str, ctx: JacobianContext, *extra: torch.Tensor) -> list:
        return self._keep(name, *ctx.residuals, *(J for js in ctx.jacs for J in js), *extra)

    def _handed_out(self, name: str) -> JacobianContext:
        """The context over buffers ``name`` for the current point: one
        object per point, so that callers that tell points apart by the
        context's identity (a rejected step keeps it) still can."""
        ctx = self._contexts.get(name)
        if ctx is None:
            ctx = self._contexts[name] = self._context(name)
        return ctx

    # -- the evaluator's entry points ------------------------------------------------

    def full(self, x: torch.Tensor):
        """(cost, gradient, context) at x, which becomes the current point
        (``self.x``); the gradient and context are the current buffers."""
        if self.x is None:
            self.x = torch.empty_like(x)
        if x is not self.x:
            self.x.copy_(x)
        self._run("full", self._full)
        self._contexts = {}
        cost, grad = self._bufs["current_cost_gradient"]
        return cost.clone(), grad, self._handed_out("current")

    def _full(self) -> None:
        p = self.program
        cost, grad, ctx = _full_impl(self.x, p.families, p.num_tangent, p.groups, True, p.comm)
        self._keep_context("current", ctx)
        self._keep("current_cost_gradient", cost, grad)

    def _set_trial(self, x: torch.Tensor) -> None:
        if self.trial_x is None:
            self.trial_x = torch.empty_like(x)
        if x is not self.trial_x:
            self.trial_x.copy_(x)

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        """The cost at x (f64), a copy."""
        self._set_trial(x)
        self._run("cost", self._cost)
        return self._bufs["trial_cost"][0].clone()

    def _cost(self) -> None:
        p = self.program
        self._keep("trial_cost", _cost_impl(self.trial_x, p.families, True, p.comm))

    def cost_and_gradient(self, x: torch.Tensor):
        """(cost, tangent gradient) at x by reverse mode, copies."""
        self._set_trial(x)
        self._run("cost_and_gradient", self._cost_and_gradient)
        cost, grad = self._bufs["trial_gradient"]
        return cost.clone(), grad.clone()

    def _cost_and_gradient(self) -> None:
        p = self.program
        self._keep("trial_gradient", *_cost_grad_impl(
            self.trial_x, p.families, p.plus_struct, True, p.num_tangent, p.comm))

    # -- the step-by-step branch --------------------------------------------------------

    def jacobi_scaling(self) -> torch.Tensor:
        """This solve's Jacobi scaling from the current Jacobian (at
        iteration 0), 1 / (1 + sqrt(diag(J'J))), kept (region
        ``jacobi_scaling``)."""
        self._run("jacobi_scaling", self._jacobi_scaling)
        return self._bufs["scaling"][0]

    def _jacobi_scaling(self) -> None:
        norms = self._context("current").squared_column_norms()
        self._keep("scaling", 1.0 / (1.0 + torch.sqrt(norms)))

    def _scaling(self) -> Optional[torch.Tensor]:
        return self._bufs["scaling"][0] if self.config.jacobi_scaling else None

    def scaled(self) -> JacobianContext:
        """The current Jacobian with its columns scaled by the solve's
        scaling (the current one without Jacobi scaling): scaled once per
        evaluation, the same object until the next."""
        if not self.config.jacobi_scaling:
            return self._handed_out("current")
        if "scaled" not in self._contexts:
            self._run("scale", self._scale)
        return self._handed_out("scaled")

    def _scale(self) -> None:
        self._keep_context("scaled", self._context("current").scale_columns(self._scaling()))

    def _step_source(self) -> str:
        return "scaled" if self.config.jacobi_scaling else "current"

    def _use(self, ctx: JacobianContext) -> None:
        """A captured region reads the buffers of :meth:`scaled`'s context,
        whatever object holds them; any other context raises."""
        static = self._bufs.get(self._step_source())
        if self.captured and (static is None or ctx.residuals[0] is not static[0]):
            raise ValueError("a captured sparse region takes the host loop's scaled context")
        self._ctx = ctx

    def lm_step(self, radius: float):
        """The LM step at ``radius`` on :meth:`scaled`'s context: (step,
        (mcc, linear iterations, termination) as one f64 device vector)."""
        self.scaled()
        self.radius.fill_(radius)
        self._run("lm_step", self._lm_step)
        step, scalars = self._bufs["step"][0], self._bufs["step_scalars"][0]
        return step, scalars

    def _lm_step(self) -> None:
        step, mcc, lin_iters, lin_term = _lm_step_impl(
            self._context(self._step_source()), self.radius, self.solve_aux, self.config.solve)
        self._keep("step", step)
        self._keep("step_scalars", torch.stack([mcc, lin_iters.to(_F64), lin_term.to(_F64)]))

    def candidate(self, step: torch.Tensor):
        """x [+] scaling * step from the current point: (candidate, (cost,
        step norm, x norm) as one f64 device vector)."""
        if step is not self._bufs.get("step", [None])[0]:
            self._keep("step", step)
        self._run("candidate", self._candidate)
        cand, scalars = self._bufs["candidate"]
        return cand, scalars

    def _candidate(self) -> None:
        p = self.program
        cand, cost, step_norm, x_norm = _candidate_impl(
            self.x, self._bufs["step"][0], self._scaling(), p.families, p.plus_struct, True,
            p.comm)
        self._keep("candidate", cand, torch.stack([cost, step_norm, x_norm]))

    # -- the bounds line search ----------------------------------------------------------

    def bounded_line(self, step: torch.Tensor) -> torch.Tensor:
        """The projected line search's direction from the current point,
        delta = scaling * step (the step itself without Jacobi scaling),
        into a static buffer (region ``bounded_line``); returns phi'(0) =
        g'delta as an f64 device scalar for the search's one read of it."""
        if step is not self._bufs.get("step", [None])[0]:
            self._keep("step", step)
        self._run("bounded_line", self._bounded_line)
        return self._bufs["bounded_line"][1]

    def _bounded_line(self) -> None:
        step, scaling = self._bufs["step"][0], self._scaling()
        delta = step if scaling is None else step * scaling
        grad = self._bufs["current_cost_gradient"][1]
        self._keep("bounded_line", delta, torch.dot(grad.to(_F64), delta.to(_F64)))

    def bounded_trial(self, a: float):
        """A trial of the search: clamp(x [+] a delta) from the current
        point (region ``bounded_trial``, a device scalar in delta's dtype):
        (the point, (its cost, step norm, x norm) as one f64 device
        vector), static buffers valid until the next trial."""
        if self.bounded_a is None:
            self.bounded_a = torch.zeros((), dtype=self._bufs["bounded_line"][0].dtype,
                                         device=self.device)
        self.bounded_a.fill_(a)
        self._run("bounded_trial", self._bounded_trial)
        cand, scalars = self._bufs["bounded_trial"]
        return cand, scalars

    def _bounded_trial(self) -> None:
        p = self.program
        cand = p.clamp(p.plus(self.x, self.bounded_a * self._bufs["bounded_line"][0]))
        cost = _cost_impl(cand, p.families, True, p.comm)
        self._keep("bounded_trial", cand, torch.stack([
            cost, torch.linalg.norm((self.x - cand).to(_F64)),
            torch.linalg.norm(self.x.to(_F64))]))

    # -- the fused iteration ----------------------------------------------------------

    def iteration(self, radius: float) -> torch.Tensor:
        """The fused iteration from the current point at ``radius``: the
        candidate into its buffers; returns the eight scalars (mcc,
        lin_iters, lin_term, cand_cost, step_norm, x_norm, cand_gmax,
        cand_gnorm) as one f64 device vector."""
        self.radius.fill_(radius)
        self._run("iteration", self._iteration)
        return self._bufs["iteration_scalars"][0]

    def _iteration(self) -> None:
        p, c = self.program, self.config
        cand, cand_ctx, cand_grad, scalars = _tr_iteration_impl(
            self.x, self._context("current"), self.radius, self._scaling(), p, self.solve_aux,
            c.solve, True)
        self._keep_context("fused_candidate", cand_ctx, cand, cand_grad)
        self._keep("iteration_scalars", scalars)

    def accept(self) -> None:
        """The fused iteration's candidate becomes the current point (a copy
        of x, its residuals, Jacobian blocks and gradient)."""
        self._run("accept", self._accept)
        self._contexts = {}

    def _accept(self) -> None:
        # "fused_candidate" holds the context's buffers, then x, then the gradient
        src, dst = self._bufs["fused_candidate"], self._bufs["current"]
        for d, s in zip(dst, src):
            d.copy_(s)
        self.x.copy_(src[len(dst)])
        self._bufs["current_cost_gradient"][1].copy_(src[len(dst) + 1])

    # -- DOGLEG --------------------------------------------------------------------

    def _use_dogleg(self, cache: tuple) -> None:
        """A captured step choice reads the ``dogleg`` region's buffers and
        :meth:`scaled`'s context; any others raise."""
        static, ctx_bufs = self._bufs.get("dogleg"), self._bufs.get(self._step_source())
        if self.captured and (static is None or cache[1] is not static[0]
                              or ctx_bufs is None or cache[0].residuals[0] is not ctx_bufs[0]):
            raise ValueError("a captured DOGLEG step takes the host loop's dogleg buffers")
        self._dl = cache

    def dogleg_precompute(self, mu: float):
        """DOGLEG's ``precompute`` on :meth:`scaled`'s context at mu:
        (diagonal, gradient, alpha, gn_step, (gn_step finite, linear
        iterations, termination) as one f64 device vector)."""
        self.scaled()
        self.mu.fill_(mu)
        self._run("dogleg", self._dogleg)
        return tuple(self._bufs["dogleg"])

    def _dogleg(self) -> None:
        c = self.config.solve

        def linear_solve(ctx, D, solve_aux):
            return _linear_solve(ctx, D, solve_aux, c)

        diagonal, gradient, alpha, gn_step, lin_iters, lin_term = dogleg.precompute(
            self._context(self._step_source()), self.mu, linear_solve, self.solve_aux,
            c.min_lm_diagonal, c.max_lm_diagonal)
        checks = torch.stack([torch.all(torch.isfinite(gn_step)).to(_F64), lin_iters.to(_F64),
                              lin_term.to(_F64)])
        self._keep("dogleg", diagonal, gradient, alpha, gn_step, checks)


def host_loop_graphs(program, options, solve_aux: dict, captured: bool, x_dtype):
    """The program's regions for these options (made, or kept from an
    earlier solve), kept in ``program.solve_aux_cache`` beside its fused
    loops: one object per option set, dtype and device, replaced when the
    families' losses changed (``fused_lm._loss_key``)."""
    from ceres_tpu_torch.fused_lm import _loss_key
    from ceres_tpu_torch.trust_region import _config_from_options

    config = HostLoopConfig(solve=_config_from_options(options),
                            jacobi_scaling=bool(options.jacobi_scaling))
    key = ("host_loop", id(solve_aux), config, captured, x_dtype, program.device)
    losses = _loss_key(program)
    graphs = program.solve_aux_cache.get(key)
    if graphs is None or graphs.solve_aux is not solve_aux or graphs.losses != losses:
        program.solve_aux_cache.pop(key, None)
        graphs = program.solve_aux_cache[key] = HostLoopGraphs(
            program, solve_aux, config, captured, losses)
    return graphs


def host_loop_graph_sets(program) -> list:
    """The ``HostLoopGraphs`` kept on ``program``."""
    return [v for k, v in program.solve_aux_cache.items()
            if isinstance(k, tuple) and k and k[0] == "host_loop"]


class LineSearchGraphs(_Regions):
    """The line search's regions, ``start`` and ``phi`` (see the module's
    docstring), over the device work of a subclass's ``evaluate`` (x ->
    (cost as an f64 scalar, tangent gradient)) and ``plus``."""

    def __init__(self, device: torch.device, captured: bool):
        super().__init__(device, captured)
        self.x: Optional[torch.Tensor] = None  # the search's point
        self.d: Optional[torch.Tensor] = None  # its direction
        self.a: Optional[torch.Tensor] = None  # the step, in the direction's dtype

    def evaluate(self, x: torch.Tensor):
        raise NotImplementedError

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _run(self, name: str, fn) -> None:
        super()._run(name, fn)
        graph = self.graphs.get(name)
        if graph is not None:
            graph.credit_replay()

    def _set_point(self, x: torch.Tensor) -> None:
        if self.x is None:
            self.x = torch.empty_like(x)
        if x is not self.x:
            self.x.copy_(x)

    def cost_and_gradient(self, x: torch.Tensor):
        """(cost, tangent gradient) at x, copies; x becomes the search's
        point."""
        self._set_point(x)
        self._run("start", self._start)
        cost, grad = self._bufs["start"]
        return cost.clone(), grad.clone()

    def _start(self) -> None:
        self._keep("start", *self.evaluate(self.x))

    def line(self, x: torch.Tensor, d: torch.Tensor) -> None:
        """Search from x along d (copied into the static buffers)."""
        self._set_point(x)
        if self.d is None:
            self.d = torch.empty_like(d)
            self.a = torch.zeros((), dtype=d.dtype, device=d.device)
        self.d.copy_(d)

    def phi(self, a: float):
        """phi at step ``a`` along :meth:`line`'s: ((phi(a), phi'(a)) as an
        f64 device vector, valid until the next call; x [+] a d; its
        gradient), the last two copies."""
        self.a.fill_(a)
        self._run("phi", self._phi)
        scalars, xa, g = self._bufs["phi"]
        return scalars, xa.clone(), g.clone()

    def _phi(self) -> None:
        xa = self.plus(self.x, self.a * self.d)
        cost, g = self.evaluate(xa)
        self._keep("phi", torch.stack([cost.to(_F64), torch.dot(g, self.d).to(_F64)]), xa, g)


class ProgramLineSearchGraphs(LineSearchGraphs):
    """A Program's line-search regions: the reverse-mode cost and gradient
    of ``evaluator._cost_grad_impl``, the losses applied."""

    def __init__(self, program, captured: bool, losses: tuple):
        super().__init__(program.device, captured)
        self._program = weakref.ref(program)  # as HostLoopGraphs
        self.losses = losses

    def evaluate(self, x: torch.Tensor):
        p = self._program()
        return _cost_grad_impl(x, p.families, p.plus_struct, True, p.num_tangent, p.comm)

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        return self._program().plus(x, delta)


def line_search_graphs(program, captured: bool) -> ProgramLineSearchGraphs:
    """The program's line-search regions (made, or kept from an earlier
    solve) in ``program.solve_aux_cache``: keyed on what their device work
    depends on (the evaluation dtype, the losses applied, the device) and
    on ``captured``, replaced when the families' losses changed."""
    from ceres_tpu_torch.fused_lm import _loss_key

    key = ("line_search", program.eval_dtype, True, captured, program.device)
    losses = _loss_key(program)
    graphs = program.solve_aux_cache.get(key)
    if graphs is None or graphs.losses != losses:
        graphs = program.solve_aux_cache[key] = ProgramLineSearchGraphs(
            program, captured, losses)
    return graphs


def line_search_graph_sets(program) -> list:
    """The ``LineSearchGraphs`` kept on ``program``."""
    return [v for k, v in program.solve_aux_cache.items()
            if isinstance(k, tuple) and k and k[0] == "line_search"]
