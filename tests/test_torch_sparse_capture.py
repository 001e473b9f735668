"""The sparse solvers' card halves in static buffers
(``host_loop_graphs.SparseRegions``, on the host loop's ``HostLoopGraphs``),
on the CPU, where their regions run eagerly as they run captured on the
card.

(a) Each region reads nothing from the device and copies nothing from the
host (the read guards of ``test_torch_device_loop.py``): SPARSE_NORMAL_CHOLESKY's
radius-free prep (diagonal, J'f and J'J cells), dynamic sparsity's damped
prep, the finish, DOGLEG's mixed-precision refinement; SPARSE_SCHUR's prep
into either buffer set and the finish with either set's point blocks, on
the 6 / 120 / 480 BAL of
``test_torch_sparse_cholesky.py``. Each gives the bits of the functions it
wraps, and a captured region refuses a context that is not over the host
loop's buffers. Which option sets ``fused_lm.host_loop_capturable`` lets
the card capture. (b) SPARSE_NORMAL_CHOLESKY (static and dynamic) and
SPARSE_SCHUR with a forced reject streak (the speculative prep into the
other set, then the finish with it), each solved twice on one program, its
regions and buffers kept between the solves as the card keeps its graphs:
the JAX package's records (``_records_match``: f64 costs rtol 1e-10, counts
and flags exactly; f32 the final cost within 1e-4 of JAX f64), the second
solve equal to the first to the bit. (c) ``profile_solve.eager_host_loop``
(the card's eager baseline) equals ``ctt.solve`` under both sparse solvers.
The captured regions themselves need the card (``test_torch_cuda.py``,
``chip_smoke.py``'s ``pose_graph_sparse_cholesky`` and
``sequential_ba_sparse_schur``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu_torch import fused_lm, host_loop_graphs
from ceres_tpu_torch.host_loop_graphs import SparseRegions
from ceres_tpu_torch.linear.inner_product import compute_normal_cells
from ceres_tpu_torch.linear.sparse_schur import _sparse_schur_finish_impl, _sparse_schur_prep_impl
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.tools.profile_solve import eager_host_loop
from ceres_tpu_torch.trust_region import (
    TrustRegionMinimizer,
    _sparse_finish_impl,
    _sparse_prep_impl,
    _sparse_prep_radius_free_impl,
)
from test_torch_device_loop import _program, _reading_only_predicates
from test_torch_sparse_cholesky import _bal, _records_match

SNC, SS = "SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR"


def _options(mod, solver: str, **changes):
    opts = mod.SolverOptions(linear_solver_type=mod.LinearSolverType[solver])
    for k, v in changes.items():
        setattr(opts, k, mod.TrustRegionStrategyType[v] if k == "trust_region_strategy_type"
                else v)
    return opts


def _minimizer(solver: str, **changes):
    """A host loop on the CPU at the BAL's start, its current point
    evaluated and its step's context scaled: (minimizer, context)."""
    problem = _bal(ctt)
    program, resolved = preprocess(_options(ctt, solver, **changes), problem, "cpu",
                                   SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    graphs = minimizer.graphs
    assert not graphs.captured and minimizer.step_fn.regions is graphs
    graphs.full(program.clamp(initial_state(program)))
    graphs.jacobi_scaling()
    return minimizer, graphs.scaled()


def _bits_equal(host_arrays, tensors) -> bool:
    return all(np.array_equal(h, t.to(tensors[0].dtype).numpy())
               for h, t in zip(host_arrays, tensors))


def _guarded(monkeypatch, run):
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        run()


def test_sparse_normal_prep_reads_nothing(monkeypatch):
    minimizer, ctx = _minimizer(SNC)
    graphs, plan = minimizer.graphs, minimizer.step_fn.plan
    for _ in range(2):  # the second run on the buffers the first made
        _guarded(monkeypatch, lambda: graphs.sparse_normal_prep(ctx, plan))
    diag, rhs = _sparse_prep_radius_free_impl(ctx, graphs.solve_config)
    assert _bits_equal(graphs.read_flat("sparse_normal_prep"),
                       [diag, rhs, *compute_normal_cells(ctx, plan)])


def test_sparse_normal_damped_prep_reads_nothing(monkeypatch):
    minimizer, ctx = _minimizer(SNC, dynamic_sparsity=True)
    graphs = minimizer.graphs
    for radius in (1e3, 250.0):
        _guarded(monkeypatch, lambda: graphs.sparse_normal_damped(ctx, radius))
        D, rhs = _sparse_prep_impl(ctx, torch.tensor(radius, dtype=torch.float64),
                                   graphs.solve_config)
        assert _bits_equal(graphs.read_flat("sparse_normal_damped"), [D, rhs])


def test_sparse_finish_reads_nothing(monkeypatch):
    minimizer, ctx = _minimizer(SNC)
    graphs = minimizer.graphs
    y = np.linspace(-1e-3, 1e-3, ctx.num_tangent)
    graphs._use(ctx)
    graphs._host_input("sparse_y", y, ctx.dtype)  # the host's copy, outside the region
    _guarded(monkeypatch, graphs._sparse_finish)
    step, mcc = _sparse_finish_impl(ctx, torch.from_numpy(y))
    assert torch.equal(graphs._bufs["step"][0], step)
    assert torch.equal(graphs._bufs["sparse_mcc"][0], mcc)


@pytest.mark.parametrize("k", [0, 1])
def test_sparse_schur_prep_and_finish_read_nothing(k, monkeypatch):
    minimizer, ctx = _minimizer(SS)
    graphs, ss = minimizer.graphs, minimizer.step_fn.ss
    radius = (1e3, 250.0)[k]
    _guarded(monkeypatch, lambda: graphs.sparse_schur_prep(ctx, radius, ss, k))
    op, cells, rhs_red, df = _sparse_schur_prep_impl(
        ctx, torch.tensor(radius, dtype=torch.float64), ss, graphs.solve_config)
    assert _bits_equal(graphs.read_flat(f"sparse_schur_cells_{k}"), [rhs_red, df, *cells])
    # the other set, at another radius, leaves this one's blocks alone
    graphs.sparse_schur_prep(ctx, 4.0 * radius, ss, 1 - k)
    D, ete_inv = graphs._bufs[f"sparse_schur_blocks_{k}"]
    assert torch.equal(D, op.D) and torch.equal(ete_inv, op._ete_inv)
    xf = np.linspace(-1e-3, 1e-3, ss.f_idx.shape[0])
    graphs._use(ctx)
    graphs._host_input("sparse_xf", xf, ctx.dtype)
    _guarded(monkeypatch, lambda: graphs._sparse_schur_finish(ss, k))
    step, mcc = _sparse_schur_finish_impl(op, torch.from_numpy(xf))
    assert torch.equal(graphs._bufs["step"][0], step)
    assert torch.equal(graphs._bufs["sparse_mcc"][0], mcc)


def test_dogleg_sparse_refinement_reads_nothing(monkeypatch):
    """DOGLEG under SPARSE_NORMAL_CHOLESKY with mixed precision: the prep
    reads the f32 solve's system (the cells of the Jacobian cast to f32,
    summed in f64, and J'f in f64), and the ``dogleg_sparse_refine`` region
    gives rhs - (J'J + D^2) y in f64 for the host's y, D = diagonal
    sqrt(mu), reading nothing and copying nothing in."""
    problem = _bal(ctt)
    opts = _options(ctt, SNC, trust_region_strategy_type="DOGLEG",
                    use_mixed_precision_solves=True)
    program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    graphs, sparse = minimizer.graphs, minimizer.dogleg._sparse
    graphs.full(program.clamp(initial_state(program)))
    graphs.jacobi_scaling()
    ctx, mu = graphs.scaled(), 1e-4
    sparse(ctx, mu)  # the prep, one refinement and the finish make the buffers
    f64 = torch.float64
    assert _bits_equal(graphs.read_flat("dogleg_sparse_prep"), [
        graphs._bufs["dogleg_sparse"][0], ctx.gradient(),
        *compute_normal_cells(ctx.to_dtype(torch.float32).to_dtype(f64), sparse.plan)])
    y = np.linspace(-1e-3, 1e-3, ctx.num_tangent)
    graphs._use(ctx)
    graphs._host_input("dogleg_y64", y, f64)  # the host's copy, outside the region
    graphs.sparse_mu.fill_(mu)
    _guarded(monkeypatch, graphs._dogleg_sparse_refine)
    D = graphs._bufs["dogleg_sparse"][0] * torch.sqrt(graphs.sparse_mu)
    yt = torch.from_numpy(y)
    want = ctx.gradient() - (ctx.normal_matvec(yt) + (D * D) * yt)
    assert torch.equal(graphs._bufs["dogleg_sparse_refine"][0], want)


def test_a_captured_sparse_region_takes_only_the_host_loops_context():
    minimizer, ctx = _minimizer(SNC)
    graphs = minimizer.graphs
    unscaled = graphs._context("current")
    graphs.captured = True  # a region is refused before anything is captured
    with pytest.raises(ValueError, match="scaled context"):
        graphs.sparse_normal_prep(unscaled, minimizer.step_fn.plan)
    graphs._use(ctx)
    assert graphs._ctx is ctx


# (solver, changes) -> whether the host loop's regions are captured on the card
CAPTURABLE = [
    (SNC, {}, True),
    (SNC, dict(dynamic_sparsity=True), True),
    (SNC, dict(use_mixed_precision_solves=True), True),
    (SNC, dict(trust_region_strategy_type="DOGLEG"), True),
    (SNC, dict(trust_region_strategy_type="DOGLEG", use_mixed_precision_solves=True), True),
    (SS, {}, True),
    (SS, dict(use_mixed_precision_solves=True), True),
    (SS, dict(trust_region_strategy_type="DOGLEG"), True),
    ("DENSE_SCHUR", {}, True),
    ("ITERATIVE_SCHUR", {}, True),
]


@pytest.mark.parametrize("solver,changes,captured", CAPTURABLE,
                         ids=[f"{s}-{'-'.join(c) or 'lm'}" for s, c, _ in CAPTURABLE])
def test_host_loop_capturable(solver, changes, captured):
    opts = _options(ctt, solver, **changes)
    assert fused_lm.host_loop_capturable(opts, _program()) is captured
    # the fused loop still takes no sparse solver: a host factor cannot sit inside it
    assert fused_lm.captured_loop_eligible(opts, _program()) is (
        captured and solver not in (SNC, SS))
    assert not fused_lm.host_loop_capturable(opts, _program("cpu"))
    assert not fused_lm.host_loop_capturable(opts, _program(comm=object()))


# (b): name -> (solver, option changes, the BAL's arguments, evaluation dtype)
STREAK = dict(seed=3, cams=5, pts=80, obs=320, noise=6.0, perturb=2.5)
SOLVES = {
    "normal_static": (SNC, dict(max_num_iterations=12), {}),
    "normal_dynamic": (SNC, dict(max_num_iterations=12, dynamic_sparsity=True), {}),
    "schur_reject_streak": (SS, dict(max_num_iterations=20, initial_trust_region_radius=1e6,
                                     min_relative_decrease=0.9), STREAK),
}


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    solver, changes, sizes = SOLVES[name]
    return ct.solve(_options(ct, solver, **changes), _bal(ct, **sizes))


def _bits(summary) -> list:
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]  # less the times


@pytest.mark.parametrize("name,dtype", [(n, "float64") for n in sorted(SOLVES)]
                         + [("schur_reject_streak", "float32")])
def test_two_solves_on_one_program_give_jax_records(name, dtype, monkeypatch):
    solver, changes, sizes = SOLVES[name]
    finishes = []
    real = SparseRegions.sparse_schur_finish

    def finish(self, ctx, xf, ss, k):
        finishes.append(k)
        return real(self, ctx, xf, ss, k)

    monkeypatch.setattr(SparseRegions, "sparse_schur_finish", finish)
    problem = _bal(ctt, **sizes)
    opts = _options(ctt, solver, evaluation_dtype=dtype, **changes)
    start = problem.state().copy()
    runs, xs = [], []
    for _ in range(2):
        problem.write_back(start)
        runs.append(ctt.solve(opts, problem, device="cpu"))
        xs.append(problem.state().copy())
    first, second = runs
    assert not first.captured_loop and first.graph_capture_time_in_seconds == 0.0
    assert _bits(second) == _bits(first) and second.final_cost == first.final_cost
    assert np.array_equal(xs[0], xs[1])
    (graphs,) = host_loop_graphs.host_loop_graph_sets(problem.program("cpu"))
    flat = {SNC: "sparse_normal_damped" if changes.get("dynamic_sparsity")
            else "sparse_normal_prep", SS: "sparse_schur_cells_0"}[solver]
    assert flat in graphs._bufs and "sparse_mcc" in graphs._bufs
    sj = _jax(name)
    if dtype == "float64":
        _records_match(first, sj)
    else:
        assert first.is_solution_usable()
        np.testing.assert_allclose(first.final_cost, sj.final_cost, rtol=1e-4)
    if solver == SS:
        # the streak's speculative preps went to set 1 and were finished from it
        assert sum(not r.step_is_successful for r in first.iterations) >= 2
        assert 1 in finishes and "sparse_schur_cells_1" in graphs._bufs
    assert first.num_successful_steps > 2


@pytest.mark.parametrize("name", ["normal_static", "schur_reject_streak"])
def test_eager_host_loop_gives_the_solves_summary(name):
    """``profile_solve.eager_host_loop``, the captured host loop's baseline
    on the card, keeps ``solve``'s records and counts and writes back its
    solution under both sparse solvers."""
    solver, changes, sizes = SOLVES[name]
    problem = _bal(ctt, **sizes)
    opts = _options(ctt, solver, **changes)
    start = problem.state().copy()
    eager, seconds = eager_host_loop(problem, opts, "cpu")
    eager_x = problem.state().copy()
    problem.write_back(start)
    solved = ctt.solve(opts, problem, device="cpu")
    assert seconds > 0.0 and _bits(eager) == _bits(solved)
    assert np.array_equal(eager_x, problem.state())
    for field in ("initial_cost", "final_cost", "num_successful_steps",
                  "num_unsuccessful_steps", "num_linear_solver_iterations"):
        assert getattr(eager, field) == getattr(solved, field), field
    assert solved.termination_type != ctt.TerminationType.FAILURE
