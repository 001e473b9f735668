"""The inner iterations' set steps, DOGLEG's step choice and the bounds line
search's trials in static buffers (``host_loop_graphs.InnerRegions``,
``DoglegRegions`` and ``HostLoopGraphs``' ``bounded_line`` /
``bounded_trial`` / ``jacobi_scaling``), on the CPU, where their regions
run eagerly as they run captured on the card.

(a) Each region reads nothing from the device and copies nothing from the
host (the read guards of ``test_torch_device_loop.py``) and gives the bits
of the functions it wraps: an inner set step of each set, the traditional
step, the subspace model and the subspace step (its coefficients copied in
before the region), the bounds line search's direction with phi'(0) and a
trial, and the Jacobi scaling at iteration 0. (b) Solves run twice on one
program, the regions and buffers kept between the solves as the card keeps
its graphs: LM under DENSE_SCHUR with inner iterations on the automatic
sets (f64 and f32) and on a user ordering whose point set leaves half the
points out (the gather plans drop their rows), DOGLEG traditional and
subspace, and a bounded BAL whose bounds are active. Each gives the JAX
package's records (``test_torch_host_loop._same_records``: f64 costs rtol
1e-10, counts and flags exactly; f32 the final cost within 1e-4 of JAX
f64); the second solve equals the first to the bit, runs on the same
regions and colours nothing again. (c) ``profile_solve.eager_host_loop``
(the card's eager baseline) equals ``ctt.solve`` for these options. The
captured regions themselves need the card (``test_torch_cuda.py``,
``chip_smoke.py``'s ``inner_iterations_*``, ``dogleg_large_*`` and
``flagship_host_loop`` phases).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch import dogleg, host_loop_graphs
from ceres_tpu_torch import inner_iterations as tii
from ceres_tpu_torch.evaluator import _cost_impl
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.tools.profile_solve import eager_host_loop
from ceres_tpu_torch.trust_region import TrustRegionMinimizer, _model_cost_change
from test_torch_device_loop import _reading_only_predicates
from test_torch_host_loop import _same_records

F64 = torch.float64
TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
# 290 of its points in the user ordering's point set: the K3 kind, the others' rows dropped
HALF = dict(num_cameras=4, num_points=580, num_observations=1740, noise=2.0, perturb=0.5, seed=9)


def _guarded(monkeypatch, run):
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        return run()


def _bal(mod, sizes=TINY, bounded=False):
    bm = jbal if mod is ct else tbal
    inst = bm.synthesize_bal(**sizes)
    if bounded:
        inst.points[:, 2] = np.clip(inst.points[:, 2], -0.2, 0.2)
    p, cams, pts = bm.build_problem(inst, loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    if bounded:
        for pid in pts:
            p.set_parameter_lower_bound(int(pid), 2, -0.2)
            p.set_parameter_upper_bound(int(pid), 2, 0.2)
    return p, cams, pts


def _minimizer(problem, opts):
    """A host loop on the CPU at the problem's start, its current point
    evaluated and its Jacobi scaling kept: (minimizer, start)."""
    program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    graphs = minimizer.graphs
    assert not graphs.captured
    x0 = program.clamp(initial_state(program))
    graphs.full(x0)
    graphs.jacobi_scaling()
    return minimizer, x0


# -- (a) each region ------------------------------------------------------------


def test_jacobi_scaling_reads_nothing(monkeypatch):
    problem = _bal(ctt)[0]
    minimizer, x0 = _minimizer(problem, tbal.default_options(iterative=False))
    graphs = minimizer.graphs
    ctx = graphs._context("current")
    scaling = _guarded(monkeypatch, graphs.jacobi_scaling)
    assert scaling is graphs._bufs["scaling"][0]
    assert torch.equal(scaling, 1.0 / (1.0 + torch.sqrt(ctx.squared_column_norms())))


@pytest.mark.parametrize("sizes", ["TINY", "HALF"])
def test_each_inner_set_step_reads_nothing(sizes, monkeypatch):
    problem, cams, pts = _bal(ctt, dict(TINY=TINY, HALF=HALF)[sizes])
    opts = tbal.default_options(iterative=False)
    opts.use_inner_iterations = True
    if sizes == "HALF":
        opts.inner_iteration_ordering = [[int(p) for p in pts[::2]], [int(c) for c in cams[2:]]]
    minimizer, x0 = _minimizer(problem, opts)
    cd = minimizer.inner_minimizer
    regions = cd.regions
    assert regions is minimizer.graphs.inner_regions(tii._ordering_key(
        opts.inner_iteration_ordering))
    assert len(cd.sets) == 2 and all(k != "scatter" for *_, k in cd.plan_kinds())
    regions.start(x0)
    for si, groups in enumerate(cd._set_structs):
        sizes_T = {T: rows.shape[0] for T, (rows, _) in groups.items()}
        regions.fill_radii(si, sizes_T, 1e3)
        for step in range(2):
            x = regions.x.clone()
            radii = {T: regions.radii[si, T].clone() for T in sizes_T}
            _guarded(monkeypatch, lambda: regions.set_step(
                si, lambda x_, r_, g=groups: cd._set_step(g, x_, r_)))
            new_x, new_radii, cost = cd._set_step(groups, x, radii)
            assert torch.equal(regions.x, new_x) and torch.equal(regions.cost, cost)
            assert all(torch.equal(regions.radii[si, T], new_radii[T]) for T in sizes_T)
            assert not torch.equal(new_x, x)  # the step moved some block
    # a pass: its one read, and the point it returns is a copy
    x1, cost1 = cd.minimize(x0)
    assert x1 is not regions.x and torch.equal(x1, regions.x)
    assert cost1 == float(_cost_impl(x1, problem.program("cpu").families, True))
    assert cost1 < float(_cost_impl(x0, problem.program("cpu").families, True))


class _CalledAgain:
    """Stands in for ``CapturedGraph`` on the CPU: a replay calls the
    captured function again, as a replay runs its work again."""

    def __init__(self, fn, device, share=None):
        self.fn = fn

    def replay(self):
        self.fn()

    def credit_replay(self):
        pass


def test_a_captured_pass_takes_each_step_once(monkeypatch):
    """A region's first captured call runs it eagerly (the warm-up),
    captures it and replays it; a set step overwrites its own inputs, so
    its warm-up must leave the point, radii and cost as it found them. With
    the capture stood in by a function called again at each replay, a
    captured pass gives the eager pass's bits, pass after pass."""
    monkeypatch.setattr(host_loop_graphs, "CapturedGraph", _CalledAgain)
    problem = _bal(ctt)[0]
    program = problem.program("cpu")
    opts = ctt.SolverOptions()
    eager = tii.CoordinateDescentMinimizer(program, opts, None)
    captured = tii.CoordinateDescentMinimizer(
        program, opts, None, regions=host_loop_graphs.InnerRegions(program.device, True))
    x = x_c = torch.from_numpy(program.initial_ambient())
    for _ in range(2):
        x, cost = eager.minimize(x)
        x_c, cost_c = captured.minimize(x_c)
        assert torch.equal(x_c, x) and cost_c == cost
    assert sorted(captured.regions.graphs) == ["inner_set_0", "inner_set_1"]
    assert not eager.regions.graphs


def _dogleg_cache(kind):
    problem = _bal(ctt)[0]
    opts = tbal.default_options(iterative=False)
    opts.trust_region_strategy_type = ctt.TrustRegionStrategyType.DOGLEG
    opts.dogleg_type = ctt.DoglegType[kind]
    minimizer, _ = _minimizer(problem, opts)
    graphs = minimizer.graphs
    ctx = graphs.scaled()
    cache = (ctx, *graphs.dogleg_precompute(1e-8)[:4])
    return graphs, cache


@pytest.mark.parametrize("radius", [1e-3, 1.0, 1e6])
def test_dogleg_traditional_reads_nothing(radius, monkeypatch):
    graphs, cache = _dogleg_cache("TRADITIONAL_DOGLEG")
    step, scalars = _guarded(monkeypatch, lambda: graphs.dogleg_traditional(cache, radius))
    ref, norm = dogleg.traditional(*cache[1:], torch.tensor(radius, dtype=F64))
    assert torch.equal(step, ref)
    assert torch.equal(scalars, torch.stack([norm.to(F64), _model_cost_change(cache[0], ref)]))


def test_dogleg_subspace_regions_read_nothing(monkeypatch):
    graphs, cache = _dogleg_cache("SUBSPACE_DOGLEG")
    ctx, diagonal, gradient, alpha, gn_step = cache
    flat = _guarded(monkeypatch, lambda: graphs.dogleg_subspace_model(cache))
    Q, B, g2, rdiag = dogleg.subspace_model(ctx, diagonal, gradient, gn_step)
    assert torch.equal(graphs._bufs["dogleg_model"][0], Q)
    assert torch.equal(flat, torch.cat([B.reshape(-1), g2, rdiag, torch.linalg.norm(gradient)[None],
                                        torch.linalg.norm(gn_step)[None]]))
    for coef in ([0.3, -0.2, 0.0, 0.0], [0.0, 0.0, -0.7, 1.0]):
        graphs._host_input("dogleg_coef", np.array(coef), F64)  # the host's copy, outside
        _guarded(monkeypatch, graphs._dogleg_subspace_step)
        step = graphs._bufs["step"][0]
        if coef[3]:
            ref = -0.7 * gradient / diagonal
        else:
            ref = (Q[:, 0] * 0.3 + Q[:, 1] * -0.2) / diagonal
        assert torch.equal(step, ref)
        assert torch.equal(graphs._bufs["dogleg_mcc"][0], _model_cost_change(ctx, ref)[None])


def test_a_captured_dogleg_step_takes_only_the_host_loops_buffers():
    graphs, cache = _dogleg_cache("TRADITIONAL_DOGLEG")
    graphs.captured = True  # refused before anything is captured
    with pytest.raises(ValueError, match="dogleg buffers"):
        graphs.dogleg_traditional((cache[0], *(t.clone() for t in cache[1:])), 1.0)
    graphs._use_dogleg(cache)
    assert graphs._dl is cache


def test_bounded_line_and_trial_read_nothing(monkeypatch):
    problem = _bal(ctt, bounded=True)[0]
    minimizer, _ = _minimizer(problem, tbal.default_options(iterative=False))
    graphs, program = minimizer.graphs, minimizer.program
    step, _ = graphs.lm_step(1e4)
    dphi0 = _guarded(monkeypatch, lambda: graphs.bounded_line(step))
    delta = step * graphs._bufs["scaling"][0]
    assert torch.equal(graphs._bufs["bounded_line"][0], delta)
    assert torch.equal(dphi0, torch.dot(graphs._bufs["current_cost_gradient"][1], delta))
    x = graphs.x
    for a in (1.0, 0.3):
        cand, scalars = _guarded(monkeypatch, lambda: graphs.bounded_trial(a))
        ref = program.clamp(program.plus(x, a * delta))
        assert torch.equal(cand, ref)
        assert torch.equal(scalars, torch.stack([
            _cost_impl(ref, program.families, True), torch.linalg.norm(x - ref),
            torch.linalg.norm(x)]))
        if a == 1.0:
            assert torch.any(cand != program.plus(x, delta))  # the clamp is active


# -- (b) two solves on one program ------------------------------------------------


def _inner(mod, sizes=TINY, user=False):
    bm = jbal if mod is ct else tbal
    p, cams, pts = _bal(mod, sizes)
    opts = bm.default_options(iterative=False)  # DENSE_SCHUR
    opts.use_inner_iterations = True
    if user:
        opts.inner_iteration_ordering = [[int(q) for q in pts[::2]], [int(c) for c in cams[2:]]]
    return p, opts


def _dogleg(kind):
    def make(mod):
        bm = jbal if mod is ct else tbal
        p = _bal(mod)[0]
        opts = bm.default_options(iterative=False)
        opts.max_num_iterations = 10
        opts.trust_region_strategy_type = mod.TrustRegionStrategyType.DOGLEG
        opts.dogleg_type = mod.DoglegType[kind]
        opts.initial_trust_region_radius = 10.0  # steps on the region's boundary
        return p, opts

    return make


def _bounded(mod):
    bm = jbal if mod is ct else tbal
    opts = bm.default_options(iterative=False)
    opts.max_num_iterations = 10
    return _bal(mod, bounded=True)[0], opts


CASES = {
    "inner_automatic": _inner,
    "inner_user_half": functools.partial(_inner, sizes=HALF, user=True),
    "dogleg_traditional": _dogleg("TRADITIONAL_DOGLEG"),
    "dogleg_subspace": _dogleg("SUBSPACE_DOGLEG"),
    "bounded": _bounded,
}
# the static buffers each case's own regions leave on its HostLoopGraphs
BUFFERS = {
    "inner_automatic": (),
    "inner_user_half": (),
    "dogleg_traditional": ("dogleg_scalars",),
    "dogleg_subspace": ("dogleg_model", "dogleg_mcc"),
    "bounded": ("bounded_line", "bounded_trial"),
}


@functools.lru_cache(maxsize=None)
def _jax(case: str):
    problem, opts = CASES[case](ct)
    return ct.solve(opts, problem)


def _bits(summary) -> list:
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]  # less the times


@pytest.mark.parametrize("case,dtype", [(c, "float64") for c in sorted(CASES)]
                         + [("inner_automatic", "float32")])
def test_two_solves_on_one_program_give_jax_records(case, dtype, monkeypatch):
    colorings = []
    real = tii.compute_independent_sets
    monkeypatch.setattr(tii, "compute_independent_sets",
                        lambda program: colorings.append(1) or real(program))
    problem, opts = CASES[case](ctt)
    opts.evaluation_dtype = dtype
    start = problem.state().copy()
    runs, xs, colored = [], [], []
    for _ in range(2):
        problem.write_back(start)
        runs.append(ctt.solve(opts, problem, device="cpu"))
        xs.append(problem.state().copy())
        colored.append(len(colorings))
    first, second = runs
    assert not first.captured_loop and first.graph_capture_time_in_seconds == 0.0
    assert _bits(second) == _bits(first) and second.final_cost == first.final_cost
    assert np.array_equal(xs[0], xs[1])
    (graphs,) = host_loop_graphs.host_loop_graph_sets(problem.program("cpu"))
    assert all(name in graphs._bufs for name in BUFFERS[case])
    sj = _jax(case)
    if dtype == "float64":
        _same_records(first, sj)
    else:
        np.testing.assert_allclose(first.final_cost, sj.final_cost, rtol=1e-4)
    if case.startswith("inner"):
        assert first.num_inner_iteration_steps == sj.num_inner_iteration_steps > 0
        assert second.num_inner_iteration_steps == first.num_inner_iteration_steps
        # the sets and plans are the program's, the regions the host loop's
        assert colored == ([1, 1] if case == "inner_automatic" else [0, 0])
        assert list(graphs._inner) == [tii._ordering_key(opts.inner_iteration_ordering)]
    if case == "bounded":
        z = problem.state()[-3 * 60 + 2::3]
        assert np.all(np.abs(z) <= 0.2) and np.any(np.abs(z) == 0.2)
    assert first.num_successful_steps > 2


@pytest.mark.parametrize("case", ["inner_automatic", "dogleg_subspace", "bounded"])
def test_eager_host_loop_gives_the_solves_summary(case):
    """``profile_solve.eager_host_loop``, the captured host loop's baseline
    on the card, keeps ``solve``'s records and counts and writes back its
    solution."""
    problem, opts = CASES[case](ctt)
    start = problem.state().copy()
    eager, seconds = eager_host_loop(problem, opts, "cpu")
    eager_x = problem.state().copy()
    problem.write_back(start)
    solved = ctt.solve(opts, problem, device="cpu")
    assert seconds > 0.0 and _bits(eager) == _bits(solved)
    assert np.array_equal(eager_x, problem.state())
    for field in ("initial_cost", "final_cost", "num_successful_steps",
                  "num_unsuccessful_steps", "num_linear_solver_iterations",
                  "num_inner_iteration_steps"):
        assert getattr(eager, field) == getattr(solved, field), field
