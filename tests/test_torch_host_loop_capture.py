"""The host loop's device work in static buffers (``host_loop_graphs.py``),
on the CPU, where its regions run eagerly as they run captured on the card.

(a) Each region reads nothing from the device but the predicates of its
``run_if``s and copies nothing from the host (the read guards of
``test_torch_device_loop.py``): the evaluator's three entry points, the
Jacobi scaling of the Jacobian, the LM step (ITERATIVE_SCHUR: its CG), the
candidate, the fused iteration and the copy of its candidate into the
current buffers, and DOGLEG's Gauss-Newton solve, on the 8 / 500 / 2000
robust BAL. (b) The restructured host loop (every evaluation into the
program's current buffers, the accepted fused candidate copied into them)
solves one problem twice on one program, its regions and buffers kept
between the solves as the card keeps its graphs: both solves equal the
JAX package's records (the tolerances of ``test_torch_host_loop.py``: f64
costs rtol 1e-10, radius and gradient norms 1e-6, step norms 1e-4, counts
and flags exactly; f32 the final cost within 1e-4 of JAX f64) for progress
output (ITERATIVE_SCHUR, the fused iteration, f64 and f32), bounds
(the projected line search), non-monotonic steps with an evaluation
callback (the callback's calls too) and DOGLEG (traditional and subspace);
the second solve equals the first to the bit and runs on the same
regions, and ``profile_solve.eager_host_loop`` (the card's eager baseline)
equals ``ctt.solve``. The captured regions themselves need the card
(``test_torch_cuda.py``, ``chip_smoke.py``'s host-loop phases).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch import host_loop_graphs
from ceres_tpu_torch.linear.cg import CG_SUCCESS
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.trust_region import TrustRegionMinimizer
from test_torch_device_loop import SMALL, _reading_only_predicates
from test_torch_host_loop import _Recorder, _same_records

TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
ITERATIONS = 10  # each solve's first records: the file stays short

# region -> (solver, DOGLEG?, the regions run before it)
REGIONS = {
    "full": ("ITERATIVE_SCHUR", False, ()),
    "cost": ("ITERATIVE_SCHUR", False, ("full",)),
    "cost_and_gradient": ("ITERATIVE_SCHUR", False, ("full",)),
    "scale": ("ITERATIVE_SCHUR", False, ("full",)),
    "lm_step": ("ITERATIVE_SCHUR", False, ("full",)),
    "candidate": ("ITERATIVE_SCHUR", False, ("full", "lm_step")),
    "iteration": ("ITERATIVE_SCHUR", False, ("full",)),
    "accept": ("ITERATIVE_SCHUR", False, ("full", "iteration")),
    "dogleg": ("DENSE_SCHUR", True, ("full",)),
}


def _small_graphs(solver: str, dogleg: bool):
    problem = tbal.build_problem(tbal.synthesize_bal(**SMALL), loss=ctt.HuberLoss(1.0))[0]
    opts = tbal.default_options(iterative=solver == "ITERATIVE_SCHUR")
    if dogleg:
        opts.trust_region_strategy_type = ctt.TrustRegionStrategyType.DOGLEG
    program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    assert not minimizer.graphs.captured
    return minimizer.graphs, program.clamp(initial_state(program))


def _call(graphs, name: str, x0):
    if name == "full":
        cost = graphs.full(x0)[0]
        graphs.jacobi_scaling()
        return cost
    if name in ("cost", "cost_and_gradient"):
        return getattr(graphs, name)(x0 * 1.001)
    if name == "scale":
        return graphs.scaled()
    if name == "lm_step":
        return graphs.lm_step(1e4)
    if name == "candidate":
        return graphs.candidate(graphs.lm_step(1e4)[0])
    if name == "iteration":
        return graphs.iteration(1e4)
    if name == "accept":
        return graphs.accept()
    return graphs.dogleg_precompute(1e-8)


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_each_region_reads_only_its_predicates(name, monkeypatch):
    solver, dogleg, before = REGIONS[name]
    graphs, x0 = _small_graphs(solver, dogleg)
    for prior in before:
        _call(graphs, prior, x0)
    cost0 = float(graphs.full(x0)[0]) if name == "accept" else None
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        _call(graphs, name, x0)
    bufs = graphs._bufs
    if name == "lm_step":
        mcc, iters, term = bufs["step_scalars"][0].tolist()
        assert mcc > 0 and iters >= 1 and term == CG_SUCCESS
    if name == "candidate":
        assert float(bufs["candidate"][1][0]) < float(bufs["current_cost_gradient"][0])
    if name == "iteration":
        assert float(bufs["iteration_scalars"][0][3]) < float(bufs["current_cost_gradient"][0])
    if name == "accept":
        # the current buffers hold the candidate's evaluation: a new one at
        # the candidate gives the same residuals, Jacobian and gradient
        assert torch.equal(graphs.x, bufs["fused_candidate"][-2])
        kept = [t.clone() for t in bufs["current"] + bufs["current_cost_gradient"][1:]]
        assert float(graphs.full(graphs.x)[0]) < cost0
        assert all(torch.equal(a, b) for a, b in
                   zip(kept, bufs["current"] + bufs["current_cost_gradient"][1:]))
    if name == "dogleg":
        assert bufs["dogleg"][-1].tolist()[0] == 1.0  # the Gauss-Newton step is finite


def _bounded(mod):
    bm = jbal if mod is ct else tbal
    inst = bm.synthesize_bal(**TINY)
    inst.points[:, 2] = np.clip(inst.points[:, 2], -0.2, 0.2)
    p, cams, pts = bm.build_problem(inst, loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    for pid in pts:
        p.set_parameter_lower_bound(int(pid), 2, -0.2)
        p.set_parameter_upper_bound(int(pid), 2, 0.2)
    opts = bm.default_options(iterative=False)
    opts.max_num_iterations = ITERATIONS
    return p, opts


def _plain(mod, iterative: bool):
    bm = jbal if mod is ct else tbal
    p, cams, _ = bm.build_problem(bm.synthesize_bal(**TINY), loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    opts = bm.default_options(iterative=iterative)
    opts.max_num_iterations = ITERATIONS
    return p, opts


def _progress(mod):
    p, opts = _plain(mod, True)
    opts.minimizer_progress_to_stdout = True
    return p, opts


def _nonmonotonic(mod):
    p, opts = _plain(mod, False)
    opts.use_nonmonotonic_steps = True
    opts.evaluation_callback = _Recorder()
    return p, opts


def _dogleg(kind):
    def make(mod):
        p, opts = _plain(mod, False)
        opts.trust_region_strategy_type = mod.TrustRegionStrategyType.DOGLEG
        opts.dogleg_type = mod.DoglegType[kind]
        return p, opts

    return make


CASES = {
    "progress": _progress,
    "bounded": _bounded,
    "nonmonotonic_evaluation_callback": _nonmonotonic,
    "dogleg_traditional": _dogleg("TRADITIONAL_DOGLEG"),
    "dogleg_subspace": _dogleg("SUBSPACE_DOGLEG"),
}


@functools.lru_cache(maxsize=None)
def _jax(case: str):
    """(the JAX package's summary, its evaluation callback's calls or None)."""
    problem, opts = CASES[case](ct)
    summary = ct.solve(opts, problem)
    return summary, getattr(opts.evaluation_callback, "calls", None)


def _bits(summary) -> list:
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]  # less the times


@pytest.mark.parametrize("case,dtype", [(c, "float64") for c in sorted(CASES)]
                         + [("progress", "float32")])
def test_two_solves_on_one_program_give_jax_records(case, dtype, capsys):
    sj, jax_calls = _jax(case)
    problem, opts = CASES[case](ctt)
    opts.evaluation_dtype = dtype
    start = problem.state().copy()
    runs, calls = [], []
    for _ in range(2):
        problem.write_back(start)
        if opts.evaluation_callback is not None:
            opts.evaluation_callback.calls = []
        runs.append(ctt.solve(opts, problem, device="cpu"))
        calls.append(getattr(opts.evaluation_callback, "calls", None))
    capsys.readouterr()
    first, second = runs
    assert not first.captured_loop and first.graph_capture_time_in_seconds == 0.0
    assert _bits(second) == _bits(first) and second.final_cost == first.final_cost
    assert calls[1] == calls[0]
    program = problem.program("cpu")
    assert len(host_loop_graphs.host_loop_graph_sets(program)) == 1
    if dtype == "float64":
        _same_records(first, sj)
        assert calls[0] == jax_calls
    else:
        np.testing.assert_allclose(first.final_cost, sj.final_cost, rtol=1e-4)
    assert first.num_iterations == ITERATIONS and first.num_successful_steps > 2


def test_eager_host_loop_gives_the_solves_summary(capsys):
    """``profile_solve.eager_host_loop``, the captured host loop's baseline
    on the card, keeps ``solve``'s records and counts and writes back its
    solution."""
    from ceres_tpu_torch.tools.profile_solve import eager_host_loop

    problem, opts = _progress(ctt)
    start = problem.state().copy()
    eager, seconds = eager_host_loop(problem, opts, "cpu")
    eager_x = problem.state().copy()
    problem.write_back(start)
    solved = ctt.solve(opts, problem, device="cpu")
    capsys.readouterr()
    assert seconds > 0.0 and _bits(eager) == _bits(solved)
    assert np.array_equal(eager_x, problem.state())
    for field in ("initial_cost", "final_cost", "num_successful_steps",
                  "num_unsuccessful_steps", "num_linear_solver_iterations"):
        assert getattr(eager, field) == getattr(solved, field), field
