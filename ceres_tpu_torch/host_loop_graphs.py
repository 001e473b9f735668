"""The host loop's device work between its decisions, in static buffers and,
on the card, as CUDA graphs (the JAX package jits each of these pieces:
``trust_region._tr_iteration_impl``, ``_lm_step_impl``,
``_scale_columns_jit``, ``_candidate_impl``, the evaluator's entry points
and DOGLEG's ``precompute``).

``HostLoopGraphs`` holds, for one program and option set, a region per
piece: a function that reads static device buffers (the current point x,
its residuals, Jacobian blocks and gradient, the radius and DOGLEG's mu as
device scalars, the Jacobi scaling, a trial point) and copies its results
into static buffers of its own, so that every call is the same device
work on the same memory. The host writes an input (a fill, or a copy of
the point to evaluate) and runs the region; what it reads it reads from
the region's scalar vector, once, where the JAX package's ``device_get``
reads. With ``captured`` (the card, ``fused_lm.captured_loop_eligible``)
each region is captured at its first call, after an eager warm-up that
allocates its buffers and whose launches count nowhere, as one CUDA graph,
its CG a WHILE node (``linear/cg.py``), and replayed after; every graph of
the object allocates from the first one's memory pools. Otherwise the
same functions run eagerly on the same buffers: the CPU, a mesh, the sparse
solvers (whose step is factored on the host), and the eager baseline
(``tools/profile_solve.eager_host_loop``). Nothing falls back: a failed
capture raises.

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
- ``dogleg``: DOGLEG's Gauss-Newton solve with its Cauchy point at mu.

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

import torch

from ceres_tpu_torch import dogleg
from ceres_tpu_torch.evaluator import (
    JacobianContext,
    _cost_grad_impl,
    _cost_impl,
    _full_impl,
)
from ceres_tpu_torch.trust_region import (
    _F64,
    _SolveConfig,
    _candidate_impl,
    _linear_solve,
    _lm_step_impl,
    _tr_iteration_impl,
)
from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, pool_bytes, uncounted


@dataclasses.dataclass(frozen=True)
class HostLoopConfig:
    """What the regions' device work depends on besides the program (the
    host loop's evaluations always apply the losses)."""

    solve: _SolveConfig
    jacobi_scaling: bool


class HostLoopGraphs:
    """The host loop's regions over one program's static buffers (see the
    module's docstring)."""

    def __init__(self, program, solve_aux: dict, config: HostLoopConfig, captured: bool,
                 losses: tuple):
        # the program holds this object, not the other way round: a dropped
        # program frees the graphs' memory at once
        self._program = weakref.ref(program)
        self.solve_aux, self.config, self.captured, self.losses = (
            solve_aux, config, captured, losses)
        self.device = program.device
        self.radius = torch.zeros((), dtype=_F64, device=self.device)
        self.mu = torch.zeros((), dtype=_F64, device=self.device)
        self.x: Optional[torch.Tensor] = None  # the current point
        self.trial_x: Optional[torch.Tensor] = None  # the point of cost / cost_and_gradient
        self._bufs: dict = {}  # region outputs by name, allocated at their first (eager) run
        self.graphs: dict = {}  # region name -> CapturedGraph
        self._pool_owner: Optional[CapturedGraph] = None
        self.capture_seconds = 0.0
        # the contexts handed out for the current point (name -> context),
        # made anew by every evaluation at x and every accepted candidate
        self._contexts: dict = {}

    @property
    def program(self):
        return self._program()

    # -- machinery --------------------------------------------------------------

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
        with uncounted():
            fn()
        graph = CapturedGraph(fn, self.device, share=self._pool_owner)
        self._pool_owner = self._pool_owner or graph
        self.graphs[name] = graph
        self.capture_seconds += time.perf_counter() - t0
        graph.replay()

    def credit(self) -> None:
        """Credit the graphs' kernel launches since the last credit (one
        host read of their run counters)."""
        graphs = list(self.graphs.values())
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
        return sum(g.launches for g in self.graphs.values())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pools hold."""
        return pool_bytes(self.graphs.values()) if self.graphs else 0

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

    def set_scaling(self, scaling: torch.Tensor) -> torch.Tensor:
        """Keep this solve's Jacobi scaling (computed at iteration 0)."""
        return self._keep("scaling", scaling)[0]

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
