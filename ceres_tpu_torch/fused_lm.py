"""The Levenberg-Marquardt loop with every tensor on the device (port of
``ceres_tpu/fused_lm.py``).

Each iteration evaluates residuals and Jacobian blocks (loss-corrected,
in the tangent space of the blocks' manifolds), applies Jacobi column
scaling and LM damping, solves for the step (``trust_region._linear_solve``),
takes the model cost change in f64, evaluates the candidate cost, and updates the
radius and the invalid-step ladder with the four convergence tests of
trust_region_minimizer.cc:640-764 — the semantics of the JAX package's
``lax.while_loop`` body.

Where the loop runs (``_DeviceLoop``): its state lives in static device
buffers and one LM iteration is ``run_if(running)`` around that body
(``utils/cuda_graph.py``), ``running`` meaning termination == running and
iteration < budget, the budget a device scalar as in the JAX package. On
the card, for the options ``captured_loop_eligible`` accepts, the start (the
evaluation at x0) and the iteration are each captured once per program and
configuration as a CUDA graph, with the CG's stop inside it a device value
too (``linear/cg.py``); the host then replays the iteration
``max_num_iterations`` times without reading (a replay after the stop is a
skipped node) and reads the trace and the final scalars once, as the JAX
package reads its loop's result once. The capture, with the eager warm-up
iteration it needs, is set-up. On an NCCL mesh the graphs hold the
collectives too (``parallel/sharding.py``). Elsewhere (the CPU, a gloo
mesh, the options the capture does not take) the same iteration runs
eagerly and each ``run_if`` reads its predicate: one read per LM
iteration and one per CG iteration.

With the tracer on (``utils/observability.py``) a loop is made with a
device log: the start and each iteration stamp their phases into it, the
iteration's ``replay`` and ``end`` outside its IF node, and ``read``
reads the log with the results.

Scalars kept in f64 whatever the evaluation dtype, as the JAX package does
under its global x64 switch: the costs, the model cost change, rho, the
radius and decrease factor, and the x/step/gradient norms.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch

from ceres_tpu_torch.evaluator import _cost_impl, _full_impl
from ceres_tpu_torch.linear.cg import CG_FAILURE
from ceres_tpu_torch.loss import loss_leaves, loss_structure
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.trust_region import (
    _SPARSE_TYPES,
    IterationSummary,
    _SolveConfig,
    _build_solve_aux,
    _config_from_options,
    candidate_point,
    lm_step,
)
from ceres_tpu_torch.types import (
    LinearSolverType,
    MinimizerType,
    TerminationType,
    TrustRegionStrategyType,
)
from ceres_tpu_torch.utils import observability
from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, DeviceLog, run_if, uncounted

# Termination codes of the loop (the JAX package's values).
_RUNNING = 0
_CONVERGENCE = 1
_FAILURE = 3

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    solve: _SolveConfig
    function_tolerance: float
    gradient_tolerance: float
    parameter_tolerance: float
    min_relative_decrease: float
    initial_trust_region_radius: float
    max_trust_region_radius: float
    min_trust_region_radius: float
    max_invalid_steps: int
    jacobi_scaling: bool
    # Host-loop parity (the JAX package's traced mode, which ct.solve
    # runs): a step meeting the parameter/function tolerance is not
    # applied and the pre-step iterate is returned.
    revert_on_tolerance: bool


@dataclasses.dataclass
class _FusedState:
    x: torch.Tensor
    cost: torch.Tensor  # f64 scalar
    radius: torch.Tensor  # f64
    decrease_factor: torch.Tensor  # f64
    iteration: torch.Tensor  # int32 scalars from here on
    successful_steps: torch.Tensor
    unsuccessful_steps: torch.Tensor
    invalid_in_a_row: torch.Tensor
    termination: torch.Tensor
    linear_iterations: torch.Tensor
    gmax: torch.Tensor  # f64 gradient norms of the current iterate
    gnorm: torch.Tensor
    # whether the previous iteration accepted its step: the gradient test
    # only fires on an iterate an accepted step produced
    # (trust_region_minimizer.cc:826-837)
    last_accept: torch.Tensor


# Columns of one iteration's trace row (all f64): the iterate entering the
# iteration (cost, gradient norms, radius, ||x||) and the step taken in it.
_TRACE_FIELDS = (
    "state_cost", "state_gmax", "state_gnorm", "state_radius", "step_norm",
    "step_rho", "step_cost_change", "step_lin_iters", "step_valid",
    "step_accept", "step_xnorm",
)


def _body(s: _FusedState, program, solve_aux, config: _FusedConfig, trace: bool):
    """One LM iteration: (next state, trace row or None)."""
    sc = config.solve
    families = program.families
    cost, grad, ctx = _full_impl(s.x, families, program.num_tangent, program.groups,
                                 comm=program.comm)

    scaling = norms0 = None
    observability.phase("assemble")
    if config.jacobi_scaling:
        # The scaling of this iterate's Jacobian (the host loop fixes it at
        # iteration 0; the step does not depend on it but for rounding and
        # the clipped LM diagonal).
        norms0 = ctx.squared_column_norms()
        scaling = 1.0 / (1.0 + torch.sqrt(norms0))
    _, step_scaled, mcc, lin_iters, lin_term = lm_step(ctx, s.radius, solve_aux, sc, scaling, norms0)
    # A linear-solver FAILURE invalidates the step (linear_solver.h:57).
    step_is_valid = torch.isfinite(mcc) & (mcc > 0.0) & (lin_term < CG_FAILURE)

    candidate = candidate_point(program.plus_struct, s.x, step_scaled, scaling)
    cand_cost = _cost_impl(candidate, families, comm=program.comm)
    cand_cost = torch.where(torch.isfinite(cand_cost), cand_cost, torch.inf)
    observability.phase("update")
    rho = (cost - cand_cost) / mcc
    accept = step_is_valid & (rho > config.min_relative_decrease)

    # LM radius update (levenberg_marquardt_strategy.cc:158-171).
    r_acc = s.radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    r_acc = torch.clamp(r_acc, max=config.max_trust_region_radius)
    r_rej = s.radius / s.decrease_factor
    radius = torch.where(accept, r_acc, r_rej)
    decrease_factor = torch.where(accept, 2.0, s.decrease_factor * 2.0)
    invalid_in_a_row = torch.where(step_is_valid, 0, s.invalid_in_a_row + 1)

    # Convergence tests (trust_region_minimizer.cc:640-764).
    x_norm = torch.linalg.norm(s.x.to(_F64))
    step_norm = torch.linalg.norm((candidate - s.x).to(_F64))
    cost_change = torch.abs(cost - cand_cost)
    g64 = grad.to(_F64)
    gmax = torch.max(torch.abs(g64))
    gnorm = torch.linalg.norm(g64)
    ptol = config.parameter_tolerance
    param_tol = (
        step_is_valid
        & (step_norm <= ptol * (x_norm + ptol))
        & (s.successful_steps > 0)
    )
    func_tol = step_is_valid & (cost_change <= config.function_tolerance * cost)
    keep = accept
    if config.revert_on_tolerance:
        keep = accept & ~(param_tol | func_tol)
    grad_tol = s.last_accept & (gmax <= config.gradient_tolerance)
    radius_tol = radius <= config.min_trust_region_radius
    too_invalid = invalid_in_a_row >= config.max_invalid_steps
    termination = torch.where(
        param_tol | func_tol | grad_tol | radius_tol,
        _CONVERGENCE,
        torch.where(too_invalid, _FAILURE, _RUNNING),
    ).to(torch.int32)
    acc = accept.to(torch.int32)
    row = None
    if trace:
        row = torch.stack(
            [cost, gmax, gnorm, s.radius, step_norm, rho, cost - cand_cost,
             lin_iters.to(_F64), step_is_valid.to(_F64), accept.to(_F64), x_norm]
        )
    return _FusedState(
        x=torch.where(keep, candidate, s.x),
        cost=torch.where(keep, cand_cost, cost),
        radius=radius,
        decrease_factor=decrease_factor,
        iteration=s.iteration + 1,
        successful_steps=s.successful_steps + acc,
        unsuccessful_steps=s.unsuccessful_steps + (1 - acc),
        invalid_in_a_row=invalid_in_a_row.to(torch.int32),
        termination=termination,
        linear_iterations=s.linear_iterations + lin_iters.to(torch.int32),
        gmax=gmax,
        gnorm=gnorm,
        last_accept=accept,
    ), row


class _DeviceLoop:
    """The fused loop of one program and configuration: the state in static
    device buffers, the start (the evaluation at x0) and one LM iteration
    under ``run_if(running)``; with ``captured``, both captured once as
    CUDA graphs, the second reusing the first's memory, and replayed
    (``prepare``, then ``run``). With ``traced``, a device log of the
    phases (``observability.phase``), reset by ``run`` and read by
    ``read``."""

    def __init__(self, program, solve_aux, config: _FusedConfig, trace: bool,
                 captured: bool, x_like: torch.Tensor, losses: tuple, traced: bool):
        dev = x_like.device
        # the program holds the loop (in its solve_aux_cache), not the other
        # way round: a dropped program frees its graphs' memory at once
        self._program = weakref.ref(program)
        self.solve_aux, self.config, self.captured = solve_aux, config, captured
        self.losses = losses  # _loss_key of the program when the loop was made

        def f64():
            return torch.zeros((), dtype=_F64, device=dev)

        def i32():
            return torch.zeros((), dtype=torch.int32, device=dev)

        self.x0 = torch.empty_like(x_like)
        self.cost0 = f64()
        self.budget = i32()
        self.state = _FusedState(
            x=torch.empty_like(x_like), cost=f64(), radius=f64(), decrease_factor=f64(),
            iteration=i32(), successful_steps=i32(), unsuccessful_steps=i32(),
            invalid_in_a_row=i32(), termination=i32(), linear_iterations=i32(),
            gmax=f64(), gnorm=f64(), last_accept=torch.zeros((), dtype=torch.bool, device=dev),
        )
        # row k: the iteration that started at iteration k
        self.trace = (torch.zeros((_MAX_TRACED_ITERATIONS, len(_TRACE_FIELDS)), dtype=_F64,
                                  device=dev) if trace else None)
        self._always = torch.ones((), dtype=torch.bool, device=dev)
        self.graphs = None  # (start, iteration) CapturedGraphs
        self.log = None
        if traced:
            observability.ensure_calibrated(dev)
            self.log = DeviceLog(dev, _LOG_ROWS)

    @property
    def program(self):
        return self._program()

    def _start(self) -> None:
        program, config, s = self.program, self.config, self.state
        observability.phase("replay")
        cost0, grad0, _ = _full_impl(self.x0, program.families, program.num_tangent,
                                     program.groups, comm=program.comm)
        observability.phase("update")
        g0 = grad0.to(_F64)
        gmax = torch.max(torch.abs(g0))
        self.cost0.copy_(cost0)
        s.x.copy_(self.x0)
        s.cost.copy_(cost0)
        s.radius.fill_(config.initial_trust_region_radius)
        s.decrease_factor.fill_(2.0)
        for count in (s.iteration, s.successful_steps, s.unsuccessful_steps,
                      s.invalid_in_a_row, s.linear_iterations):
            count.zero_()
        s.termination.copy_(torch.where(gmax <= config.gradient_tolerance, _CONVERGENCE, _RUNNING))
        s.gmax.copy_(gmax)
        s.gnorm.copy_(torch.linalg.norm(g0))
        s.last_accept.fill_(True)
        observability.phase("end")

    def _iteration(self) -> None:
        s = self.state
        new, row = _body(s, self.program, self.solve_aux, self.config, self.trace is not None)
        if row is not None:
            self.trace.index_copy_(0, s.iteration.reshape(1).to(torch.int64), row[None])
        for f in dataclasses.fields(_FusedState):
            getattr(s, f.name).copy_(getattr(new, f.name))

    def _start_in_body(self) -> None:
        """The start as a conditional body that always runs: captured on the
        stream the iteration's body is captured on, so that the iteration
        graph reuses the start's temporaries (``CapturedGraph``'s
        ``share``)."""
        with run_if(self._always) as taken:
            if taken:
                self._start()

    def _step(self) -> bool:
        s = self.state
        observability.phase("replay")
        with run_if((s.termination == _RUNNING) & (s.iteration < self.budget)) as running:
            if running:
                self._iteration()
        observability.phase("end")
        return running

    def prepare(self, x0: torch.Tensor) -> float:
        """Capture the start and the iteration, once: after a warm-up that
        runs both eagerly from x0 (kernel builds, library handles, lazy
        caches; its launches are counted nowhere). Returns the seconds it
        took (0 when there was nothing to do). A failed capture raises."""
        if not self.captured or self.graphs is not None:
            return 0.0
        t0 = time.perf_counter()
        self.x0.copy_(x0)
        dev = x0.device
        with observability.device_log(self.log):
            with uncounted():
                self._start()
                self._iteration()
            start = CapturedGraph(self._start_in_body, dev)
            self.graphs = (start, CapturedGraph(self._step, dev, share=start))
        return time.perf_counter() - t0

    def run(self, x0: torch.Tensor, max_num_iterations: int) -> None:
        """The loop from x0 for at most ``max_num_iterations`` iterations;
        the results are in ``state``, ``cost0`` and ``trace``."""
        self.x0.copy_(x0)
        self.budget.fill_(max_num_iterations)
        if self.captured:
            self.prepare(x0)
        if self.log is not None:
            self.log.reset()
        with observability.span("fused.enqueue"), observability.device_log(self.log):
            if self.captured:
                start, iteration = self.graphs
                start.replay()
                for _ in range(max_num_iterations):
                    iteration.replay()
                return
            self._start()
            for _ in range(max_num_iterations):
                if not self._step():
                    break

    def launch_counts(self) -> torch.Tensor:
        """The graphs' region counters (f64, empty when not captured), read
        with the results and handed back to :meth:`credit`."""
        if self.graphs is None:
            return self.cost0.new_zeros((0,))
        return torch.cat([g.launch_counts() for g in self.graphs]).to(_F64)

    @property
    def graph_launches(self) -> int:
        """Kernel launches credited from the graphs' replays so far."""
        return 0 if self.graphs is None else sum(g.launches for g in self.graphs)

    def credit(self, counts) -> None:
        if self.graphs is None:
            return
        n0 = self.graphs[0].launch_counts().numel()
        self.graphs[0].credit(counts[:n0])
        self.graphs[1].credit(counts[n0:])

    def read(self, max_num_iterations: int):
        """One host read of the final scalars and the trace's first
        ``max_num_iterations`` rows (crediting the graphs' launches, and
        handing the tracer the device log's stamps, read bit for bit as
        f64): ({name: float}, {field: (T,) numpy})."""
        s = self.state
        scalars = (self.cost0, s.termination, s.successful_steps, s.unsuccessful_steps,
                   s.cost, s.gmax, s.gnorm, s.radius, s.iteration, s.linear_iterations)
        names = ("cost0", "termination", "successful_steps", "unsuccessful_steps", "cost",
                 "gmax", "gnorm", "radius", "iteration", "linear_iterations")
        parts = [torch.stack([v.to(_F64) for v in scalars])]
        rows = 0 if self.trace is None else min(max_num_iterations, _MAX_TRACED_ITERATIONS)
        if rows:
            parts.append(self.trace[:rows].reshape(-1))
        counts = self.launch_counts()
        parts.append(counts)
        if self.log is not None:
            parts += [p.view(_F64) for p in self.log.read_parts()]
        with observability.span("fused.read"):
            host = torch.cat(parts).cpu().numpy()
        k = len(scalars)
        final = dict(zip(names, host[:k].tolist()))
        for name in ("termination", "successful_steps", "unsuccessful_steps", "iteration",
                     "linear_iterations"):
            final[name] = int(final[name])
        T = final["iteration"]
        tr_host = host[k : k + rows * len(_TRACE_FIELDS)].reshape(rows, len(_TRACE_FIELDS))[:T]
        k += rows * len(_TRACE_FIELDS)
        self.credit(host[k : k + counts.numel()])
        if self.log is not None:
            self.log.deliver(host[k + counts.numel():].view("int64"))
        return final, {f: tr_host[:, i] for i, f in enumerate(_TRACE_FIELDS)}


# The linear solvers whose steps the capture takes, under every
# preconditioner: every operation device work of fixed shape, no host read.
_CAPTURED_SOLVERS = (LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY,
                     LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR,
                     LinearSolverType.CGNR)


def regions_capturable(device, comm, functions) -> bool:
    """Whether device work that calls ``functions`` (residual functions,
    losses, a GradientProblem's ``fn`` and ``gradient_fn``; None skipped)
    runs as CUDA graphs: on the card, without a mesh or on a mesh whose
    collectives run on the device (``MeshComm.on_device``: NCCL; a gloo
    mesh's go through the host), and with no function that calls back into
    the host (``runs_on_host``: the C API's). The line search and
    GradientProblem take this alone; the host loop adds its linear solvers
    (``captured_loop_eligible``). Decided from the device, the comm's
    backend and the functions, never by trying: the rest runs the same
    regions eagerly."""
    return (torch.device(device).type == "cuda"
            and (comm is None or getattr(comm, "on_device", False))
            and not any(getattr(f, "runs_on_host", False) for f in functions))


def program_functions(program) -> list:
    """The residual functions and losses of ``program``'s families."""
    return [g for f in program.families for g in (f.structure.fn, f.loss)]


def captured_loop_eligible(options, program) -> bool:
    """Whether the fused loop, and the host loop's device work
    (``host_loop_graphs``), run as CUDA graphs: where
    ``regions_capturable`` says so, with DENSE_QR,
    DENSE_NORMAL_CHOLESKY, DENSE_SCHUR, or ITERATIVE_SCHUR or CGNR under
    any preconditioner (IDENTITY, JACOBI, SCHUR_JACOBI,
    SCHUR_POWER_SERIES_EXPANSION, CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL on
    S assembled or on the implicit S's probes, SUBSET), mixed precision and
    the power-series initialization included. Not the sparse solvers, whose
    factorization runs on the host."""
    return (regions_capturable(program.device, program.comm, program_functions(program))
            and options.linear_solver_type in _CAPTURED_SOLVERS)


def host_loop_capturable(options, program) -> bool:
    """Whether the host loop's regions (``host_loop_graphs``, driven by
    ``trust_region.TrustRegionMinimizer``) run as CUDA graphs: where
    ``captured_loop_eligible`` admits the fused loop, and also under
    SPARSE_NORMAL_CHOLESKY (static or dynamic sparsity, mixed precision)
    and SPARSE_SCHUR, whose host factor sits between two regions, on one
    process or on a comm whose collectives run on the device (the cells'
    all-reduce inside the prep, rank 0's solution broadcast inside the
    finish), and DOGLEG under SPARSE_NORMAL_CHOLESKY, whose Gauss-Newton
    solve is regions around the host factor (``dogleg.SparseGaussNewton``;
    with ``use_mixed_precision_solves`` a refinement region between the
    host's solves). Decided from the options, never by trying."""
    return (regions_capturable(program.device, program.comm, program_functions(program))
            and options.linear_solver_type in _CAPTURED_SOLVERS + _SPARSE_TYPES)


def _loss_key(program) -> tuple:
    """What a loop captures of the families' losses: each loss's structure
    and parameter values (a tensor parameter by the memory the graph
    reads). ``LossFunctionWrapper.reset`` changes it without a new program,
    as the JAX package's fused loop takes the losses as arguments."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", v.data_ptr(), v.dtype, tuple(v.shape))
        return v if isinstance(v, (bool, int, float, str)) else ("object", id(v))

    return tuple((loss_structure(f.loss), tuple(leaf(v) for v in loss_leaves(f.loss)))
                 for f in program.families)


def _device_loop(program, solve_aux, config: _FusedConfig, trace: bool, captured: bool,
                 x0: torch.Tensor) -> _DeviceLoop:
    """The program's loop for this configuration, kept beside its solve
    structures in ``program.solve_aux_cache`` (which a cast of the program
    to another dtype empties, graphs and all), as the JAX package keeps its
    jit caches keyed on structure. One loop per configuration and tracer
    state (a loop made with the tracer on has a device log and stamps in
    its graphs): a loop made for other losses (``_loss_key``) is replaced,
    its graphs freed."""
    traced = observability.tracing_enabled()
    key = ("device_loop", id(solve_aux), config, trace, captured, x0.dtype, x0.device, traced)
    losses = _loss_key(program)
    loop = program.solve_aux_cache.get(key)
    if loop is None or loop.solve_aux is not solve_aux or loop.losses != losses:
        program.solve_aux_cache.pop(key, None)
        loop = program.solve_aux_cache[key] = _DeviceLoop(
            program, solve_aux, config, trace, captured, x0, losses, traced)
    return loop


def device_loops(program) -> list:
    """The fused loops kept on ``program`` (``_device_loop``)."""
    return [v for k, v in program.solve_aux_cache.items()
            if isinstance(k, tuple) and k and k[0] == "device_loop"]


def _fill_records(summary, opts, final, cost0: float, tr):
    """Fill ``summary`` with the IterationSummary records, termination type
    and message the JAX package's solve reports (its host loop's
    bookkeeping, rebuilt from the trace as ``minimize_fused_traced`` does).
    ``final``: host scalars of the final state; ``tr``: {field: (T,) numpy}."""
    T = final["iteration"]
    fixed = summary.fixed_cost
    last = max(T - 1, 0)
    term_code = final["termination"]
    if T == 0:
        reason = "grad" if term_code == _CONVERGENCE else "max_iters"
    elif term_code == _CONVERGENCE:
        snorm = float(tr["step_norm"][last])
        xnorm = float(tr["step_xnorm"][last])
        cchange = abs(float(tr["step_cost_change"][last]))
        prev_cost = float(tr["state_cost"][last])
        valid = bool(tr["step_valid"][last])
        had_success = final["successful_steps"] - int(bool(tr["step_accept"][last])) > 0
        if (
            valid
            and had_success
            and snorm <= opts.parameter_tolerance * (xnorm + opts.parameter_tolerance)
        ):
            reason = "param"
        elif valid and cchange <= opts.function_tolerance * prev_cost:
            reason = "func"
        elif final["gmax"] <= opts.gradient_tolerance:
            reason = "grad"
        else:
            reason = "radius"
    elif term_code == _FAILURE:
        reason = "invalid"
    else:
        reason = "max_iters"

    # The host loop appends it_0 .. it_T, except the last trip's record
    # when it returned before appending (param/func/invalid).
    records = [
        IterationSummary(
            iteration=0,
            cost=(float(tr["state_cost"][0]) if T > 0 else cost0) + fixed,
            gradient_max_norm=float(tr["state_gmax"][0]) if T > 0 else final["gmax"],
            gradient_norm=float(tr["state_gnorm"][0]) if T > 0 else final["gnorm"],
            trust_region_radius=float(tr["state_radius"][0])
            if T > 0
            else opts.initial_trust_region_radius,
            eta=opts.eta,
            step_is_valid=True,
            step_is_successful=True,
        )
    ]
    n_emit = T if reason in ("grad", "radius", "max_iters") else max(T - 1, 0)
    for k in range(1, n_emit + 1):
        if k < T:
            state = tuple(
                float(tr[f][k])
                for f in ("state_cost", "state_gmax", "state_gnorm", "state_radius")
            )
        else:
            state = (final["cost"], final["gmax"], final["gnorm"], final["radius"])
        records.append(
            IterationSummary(
                iteration=k,
                cost=state[0] + fixed,
                cost_change=float(tr["step_cost_change"][k - 1]),
                gradient_max_norm=state[1],
                gradient_norm=state[2],
                step_norm=float(tr["step_norm"][k - 1]),
                relative_decrease=float(tr["step_rho"][k - 1]),
                trust_region_radius=state[3],
                eta=opts.eta,
                linear_solver_iterations=int(tr["step_lin_iters"][k - 1]),
                step_is_valid=bool(tr["step_valid"][k - 1]),
                step_is_successful=bool(tr["step_accept"][k - 1]),
            )
        )
    summary.iterations = records

    summary.termination_type = TerminationType.CONVERGENCE
    if reason == "param":
        snorm = float(tr["step_norm"][last])
        xnorm = float(tr["step_xnorm"][last])
        summary.message = (
            f"Parameter tolerance reached. Relative step_norm: "
            f"{snorm / (xnorm + opts.parameter_tolerance):e} <= "
            f"{opts.parameter_tolerance:e}."
        )
    elif reason == "func":
        cchange = abs(float(tr["step_cost_change"][last]))
        prev_cost = float(tr["state_cost"][last])
        summary.message = (
            f"Function tolerance reached. |cost_change|/cost: "
            f"{cchange / prev_cost if prev_cost else 0.0:e} <= "
            f"{opts.function_tolerance:e}"
        )
    elif reason == "grad":
        summary.message = (
            f"Gradient tolerance reached. Gradient max norm: "
            f"{final['gmax']:e} <= {opts.gradient_tolerance:e}"
        )
    elif reason == "radius":
        summary.message = (
            "Minimum trust region radius reached. Trust region radius: "
            f"{final['radius']:e} <= {opts.min_trust_region_radius:e}"
        )
    elif reason == "invalid":
        summary.termination_type = TerminationType.FAILURE
        summary.message = (
            "Number of consecutive invalid steps more than "
            "Solver::Options::max_num_consecutive_invalid_steps: "
            f"{opts.max_num_consecutive_invalid_steps}"
        )
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = (
            f"Maximum number of iterations reached. Number of iterations: {T}."
        )


def _fused_config(resolved, revert_on_tolerance: bool) -> _FusedConfig:
    return _FusedConfig(
        solve=_config_from_options(resolved),
        function_tolerance=resolved.function_tolerance,
        gradient_tolerance=resolved.gradient_tolerance,
        parameter_tolerance=resolved.parameter_tolerance,
        min_relative_decrease=resolved.min_relative_decrease,
        initial_trust_region_radius=resolved.initial_trust_region_radius,
        max_trust_region_radius=resolved.max_trust_region_radius,
        min_trust_region_radius=resolved.min_trust_region_radius,
        max_invalid_steps=resolved.max_num_consecutive_invalid_steps,
        jacobi_scaling=resolved.jacobi_scaling,
        revert_on_tolerance=revert_on_tolerance,
    )


# The JAX package's trace lengths: the traced loop runs at most 2048
# iterations, and ``solve`` gives a longer budget to the host loop.
_MAX_TRACED_ITERATIONS = 2048
# Rows of a loop's device log: room for the start and 2048 iterations of 8
# stamps (7, and one more a mixed-precision refinement); a solve that
# stamps more has the rest counted as dropped.
_LOG_ROWS = 8 * (_MAX_TRACED_ITERATIONS + 1)


def fused_traced_eligible(options, program) -> bool:
    """Whether ``solve`` can run the fused loop and still give the complete
    Summary/IterationSummary records (the JAX package's condition). Any
    feature that needs host work between the step and the candidate
    (bounds, inner iterations, callbacks, gradient checks, dumps, live
    progress printing, non-monotonic step bookkeeping, a wall-clock budget)
    goes to the host loop, ``trust_region.TrustRegionMinimizer``."""
    return (
        options.minimizer_type == MinimizerType.TRUST_REGION
        and options.trust_region_strategy_type == TrustRegionStrategyType.LEVENBERG_MARQUARDT
        and not program.has_bounds
        and not options.use_inner_iterations
        and not options.callbacks
        and options.evaluation_callback is None
        and not options.check_gradients
        and not options.update_state_every_iteration
        and not options.use_nonmonotonic_steps
        and not options.minimizer_progress_to_stdout
        and not (
            options.trust_region_problem_dump_directory
            and options.trust_region_minimizer_iterations_to_dump
        )
        and options.max_solver_time_in_seconds >= 1e6
        and options.linear_solver_type is not None
        and options.linear_solver_type.name not in ("SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR")
        and 0 < options.max_num_iterations <= _MAX_TRACED_ITERATIONS
    )


def prepare_fused_loop(resolved, program, x0, summary, revert_on_tolerance: bool,
                       trace: bool) -> _DeviceLoop:
    """Set-up of a fused solve: the program's loop for these options, and
    on the card, where ``captured_loop_eligible`` says so, its capture (a
    program's first solve with these options only). The capture's seconds
    go to ``summary.graph_capture_time_in_seconds``, inside the
    preprocessor's."""
    captured = captured_loop_eligible(resolved, program)
    loop = _device_loop(program, _build_solve_aux(resolved, program),
                        _fused_config(resolved, revert_on_tolerance), trace, captured, x0)
    summary.captured_loop = captured
    summary.graph_capture_time_in_seconds = loop.prepare(x0)
    return loop


def minimize_fused_traced(resolved, loop: _DeviceLoop, x0, summary) -> torch.Tensor:
    """Run the fused loop (``prepare_fused_loop``'s, with its trace) and
    fill ``summary`` with the records, termination and counters the host
    loop would give (a step meeting the parameter or function tolerance is
    not applied, as the host loop returns before it). Returns the final x
    (device)."""
    t0 = time.perf_counter()
    loop.run(x0, resolved.max_num_iterations)
    # One read: the final scalars and the per-iteration trace.
    final, tr = loop.read(resolved.max_num_iterations)
    T = final["iteration"]
    summary.num_iterations = T
    with observability.span("records"):
        _fill_records(summary, resolved, final, final["cost0"], tr)
    # The whole solve is one device computation.
    summary.linear_solver_time_in_seconds += time.perf_counter() - t0
    summary.num_linear_solves += T
    summary.num_residual_evaluations += T + 1
    summary.num_jacobian_evaluations += T + 1
    return loop.state.x


def summarize_final_state(summary, final, fixed_cost: float) -> None:
    """``fused_solve``'s summary from the loop's final state (``read``'s
    ``final``): the iteration, step and CG counts, the costs and the
    termination."""
    term = final["termination"]
    summary.num_iterations = final["iteration"]
    summary.initial_cost = final["cost0"] + fixed_cost
    summary.final_cost = final["cost"] + fixed_cost
    summary.num_successful_steps = final["successful_steps"]
    summary.num_unsuccessful_steps = final["unsuccessful_steps"]
    summary.num_linear_solver_iterations = final["linear_iterations"]
    if term == _CONVERGENCE:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Fused minimizer converged."
    elif term == _FAILURE:
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Too many consecutive invalid steps."
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = f"Maximum iterations reached ({final['iteration']})."


# What the fused loop cannot honour and fused_solve refuses rather than drop.
_HOST_LOOP_OPTIONS = (
    "callbacks", "evaluation_callback", "minimizer_progress_to_stdout",
    "update_state_every_iteration", "use_nonmonotonic_steps", "use_inner_iterations",
    "check_gradients",
)


def fused_solve(options, problem, device="cuda") -> SolverSummary:
    """Solve on ``device`` (the card by default; without one that raises, it
    does not move to the CPU) with the fused LM loop; returns a SolverSummary
    and writes the solution back (the entry point bench.py drives in the
    JAX package). A step that meets the function/parameter tolerance is
    kept, as in the JAX package's fused_solve. Options only the host loop
    or the line search honours (DOGLEG, LINE_SEARCH, inner iterations,
    gradient checks, bounds, callbacks, progress output, non-monotonic
    steps, a time budget, dumps) raise ``ValueError``: ``solve`` runs
    them. With ``mesh`` the solve is sharded as ``solve``'s is (the JAX
    package's fused_lm.py:364-396). With the tracer on, one root span
    ``fused_solve``, its records in ``summary.spans``."""
    with observability.solve_scope("fused_solve") as scope:
        summary = _fused_solve(options, problem, device)
    if scope is not None:
        summary.spans = scope.trace
    return summary


def _fused_solve(options, problem, device) -> SolverSummary:
    t0 = time.perf_counter()
    summary = SolverSummary()
    with observability.span("preprocess"):
        prep = preprocess(options, problem, device, summary)
    if prep is None:
        summary.total_time_in_seconds = time.perf_counter() - t0
        return summary
    program, resolved = prep
    refused = [f for f in _HOST_LOOP_OPTIONS if getattr(resolved, f)]
    if resolved.minimizer_type != MinimizerType.TRUST_REGION:
        refused.append(f"minimizer_type={resolved.minimizer_type}")
    if resolved.trust_region_strategy_type != TrustRegionStrategyType.LEVENBERG_MARQUARDT:
        refused.append(f"trust_region_strategy_type={resolved.trust_region_strategy_type}")
    if program.has_bounds:
        refused.append("parameter bounds")
    if resolved.max_solver_time_in_seconds < 1e6:
        refused.append("max_solver_time_in_seconds")
    if resolved.trust_region_problem_dump_directory and resolved.trust_region_minimizer_iterations_to_dump:
        refused.append("trust-region problem dumps")
    if refused:
        raise ValueError(
            f"fused_solve runs the fused loop, which cannot honour {', '.join(refused)}; "
            "ctt.solve runs them on the host-loop or line-search minimizer"
        )
    with observability.span("initial_state"):
        x0 = initial_state(program, options.mesh)
    with observability.span("prepare_loop"):
        loop = prepare_fused_loop(resolved, program, x0, summary, revert_on_tolerance=False,
                                  trace=False)
    t1 = time.perf_counter()
    loop.run(x0, resolved.max_num_iterations)
    final, _ = loop.read(resolved.max_num_iterations)  # waits for the device
    with observability.span("x_to_host"):
        x = loop.state.x.to(_F64).cpu().numpy()
    t2 = time.perf_counter()
    summarize_final_state(summary, final, program.fixed_cost)
    if summary.is_solution_usable():
        with observability.span("write_back"):
            problem.write_back(x)
    summary.preprocessor_time_in_seconds = t1 - t0
    summary.minimizer_time_in_seconds = t2 - t1
    summary.total_time_in_seconds = time.perf_counter() - t0
    return summary
