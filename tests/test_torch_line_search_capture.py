"""The line search's device work in static buffers (``host_loop_graphs``'s
``LineSearchGraphs``), on the CPU, where its regions run eagerly as they
run captured on the card.

(c) Each region (``start``: the cost and gradient at the search's point;
``phi``: x [+] a d, its cost, gradient and d'g) reads nothing from the
device and copies nothing from the host (the read guards of
``test_torch_device_loop.py``), for a Program (the 4 / 60 / 240 robust BAL)
and for a GradientProblem (Rosenbrock by reverse mode; a user gradient on
the sphere manifold). Which functions ``fused_lm.regions_capturable`` lets
the card capture. (d) L-BFGS, BFGS, nonlinear CG and steepest descent
under Armijo and Wolfe (quasi-Newton needs Wolfe) through the regions on
the 4 / 60 / 240 BAL and, under L-BFGS, on a 40-pose graph (quaternion
blocks): the JAX package's records at ``test_torch_line_search.py``'s
tolerances (10 iterations), a second solve on the same program equal to the
first to the bit on the same regions, and ``profile_solve.eager_host_loop``
(the card's eager baseline) equal to ``ctt.solve``. (e) GradientProblem
with and without a manifold and a user gradient: the JAX package's records
(``test_torch_gradient_problem._same``), a second solve of the same problem
on its kept regions equal to the first to the bit, and
``profile_solve.eager_gradient_problem`` equal to them. The captured
regions themselves need the card (``test_torch_cuda.py``,
``chip_smoke.py``'s ``flagship_line_search`` and ``gradient_problem``).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch import fused_lm, host_loop_graphs
from ceres_tpu_torch.gradient_problem import _GradientProblemOracle
from ceres_tpu_torch.line_search import ProgramOracle
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.tools.profile_solve import eager_gradient_problem, eager_host_loop
from test_torch_device_loop import _reading_only_predicates
from test_torch_gradient_problem import _same, rosenbrock
from test_torch_line_search import CASES, _options, _same_records

TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
ITERATIONS = 10  # records held to JAX: a line search amplifies last-bit differences


def _tiny_bal(mod):
    bm = jbal if mod is ct else tbal
    p, cams, _ = bm.build_problem(bm.synthesize_bal(**TINY), loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    return p


def _pose_graph(mod):
    graph = tpg.synthesize_sphere(40, seed=1)[:3]  # one loop closure: cost > 0
    return (jpg if mod is ct else tpg).build_problem_3d(*graph)[0]


def _sphere_gradient(x):
    return torch.stack([x[0] * 0 + 1.0, x[0] * 0 + 2.0, x[0] * 0 + 3.0])


def _sphere(x):
    return x[0] + 2.0 * x[1] + 3.0 * x[2]


# -- (c) the regions read nothing ----------------------------------------------


def _program_graphs():
    opts = _options(ctt, "LBFGS", "WOLFE")
    program, _ = preprocess(opts, _tiny_bal(ctt), "cpu", SolverSummary())
    oracle = ProgramOracle(program)
    assert not oracle.graphs.captured
    return oracle.graphs, initial_state(program)


def _gradient_problem_graphs(kind: str):
    if kind == "rosenbrock":
        gp, x0 = ctt.GradientProblem(rosenbrock, 2), [-1.2, 1.0]
    else:
        gp = ctt.GradientProblem(_sphere, 3, manifold=ctt.SphereManifold(3),
                                 gradient_fn=_sphere_gradient)
        x0 = [1.0, 0.0, 0.0]
    oracle = _GradientProblemOracle(gp, "cpu")
    assert not oracle.graphs.captured
    return oracle.graphs, torch.tensor(x0, dtype=torch.float64)


@pytest.mark.parametrize("owner", ["program", "rosenbrock", "sphere_user_gradient"])
def test_each_region_reads_nothing(owner, monkeypatch):
    graphs, x0 = _program_graphs() if owner == "program" else _gradient_problem_graphs(owner)
    cost0, g0 = graphs.cost_and_gradient(x0)
    d = -g0
    graphs.line(x0, d)
    graphs.phi(1e-8)  # the buffers are made at a region's first run
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        cost, g = graphs.cost_and_gradient(x0)
        graphs.line(x0, d)
        scalars, xa, ga = graphs.phi(1e-8)
    assert torch.equal(cost, cost0) and torch.equal(g, g0)
    value, dg = scalars.tolist()
    assert value < float(cost0) and dg < 0.0
    assert not torch.equal(xa, x0) and xa.shape == x0.shape and ga.shape == g0.shape
    kept = xa.clone()
    graphs.phi(2e-8)
    assert torch.equal(xa, kept)  # a point handed out is a copy


def test_regions_capturable():
    """The card, no mesh and no function that calls back into the host."""
    def host(x):
        return x

    host.runs_on_host = True
    assert fused_lm.regions_capturable("cuda", None, (rosenbrock, None))
    assert not fused_lm.regions_capturable("cpu", None, (rosenbrock, None))
    assert not fused_lm.regions_capturable("cuda", object(), (rosenbrock,))
    assert not fused_lm.regions_capturable("cuda", None, (rosenbrock, host))


# -- (d) the line-search minimizer on the regions --------------------------------


def _bits(summary) -> list:
    return [repr(dataclasses.astuple(r)[:-3]) for r in summary.iterations]  # less the times


LINE_CASES = [("bal",) + c for c in CASES] + [("pose_graph", "LBFGS", "WOLFE", None)]


@functools.lru_cache(maxsize=None)
def _jax(problem: str, case: tuple):
    build = _tiny_bal if problem == "bal" else _pose_graph
    return ct.solve(_options(ct, *case, max_num_iterations=ITERATIONS), build(ct))


@pytest.mark.parametrize("problem,direction,search,ncg", LINE_CASES,
                         ids=lambda v: v if isinstance(v, str) else "")
def test_two_solves_on_one_program_give_jax_records(problem, direction, search, ncg):
    case = (direction, search, ncg)
    problem_t = (_tiny_bal if problem == "bal" else _pose_graph)(ctt)
    opts = _options(ctt, *case, max_num_iterations=ITERATIONS)
    start = problem_t.state().copy()
    runs, xs = [], []
    for kind in ("solve", "solve", "eager"):
        problem_t.write_back(start)
        if kind == "eager":
            runs.append(eager_host_loop(problem_t, opts, "cpu")[0])
        else:
            runs.append(ctt.solve(opts, problem_t, device="cpu"))
        xs.append(problem_t.state().copy())
    first = runs[0]
    assert not first.captured_loop and first.graph_capture_time_in_seconds == 0.0
    for run, x in zip(runs[1:], xs[1:]):
        assert _bits(run) == _bits(first) and run.final_cost == first.final_cost
        assert np.array_equal(x, xs[0])
    program = problem_t.program("cpu")
    # on the CPU the solves and the eager baseline share one uncaptured set
    assert len(host_loop_graphs.line_search_graph_sets(program)) == 1
    _same_records(first, _jax(problem, case))
    assert first.num_iterations == len(first.iterations) - 1 > 3


# -- (e) GradientProblem on the regions --------------------------------------------


def _quaternion_target(mod):
    target = np.array([0.5, 0.5, 0.5, 0.5])
    if mod is ct:
        return lambda q: jnp.sum((q - jnp.asarray(target)) ** 2)
    return lambda q: torch.sum((q - torch.from_numpy(target).to(q.dtype)) ** 2)


def _rosenbrock_gradient(mod):
    stack = jnp.stack if mod is ct else torch.stack

    def grad(x):
        g0 = -2.0 * (1.0 - x[0]) - 400.0 * x[0] * (x[1] - x[0] ** 2)
        return stack([g0, 200.0 * (x[1] - x[0] ** 2)])

    return grad


def _gp(mod, name):
    """(GradientProblem, x0, options) of one case in one package."""
    if name == "rosenbrock":
        return mod.GradientProblem(rosenbrock, 2), [-1.2, 1.0], {}
    if name == "rosenbrock_user_gradient":
        gp = mod.GradientProblem(rosenbrock, 2, gradient_fn=_rosenbrock_gradient(mod))
        return gp, [-1.2, 1.0], {}
    if name == "quaternion":
        return (mod.GradientProblem(_quaternion_target(mod), 4, manifold=mod.QuaternionManifold()),
                [1.0, 0.0, 0.0, 0.0], {})
    m = jnp if mod is ct else torch
    gp = mod.GradientProblem(_sphere, 3, manifold=mod.SphereManifold(3),
                             gradient_fn=lambda x: m.stack([x[0] * 0 + 1.0, x[0] * 0 + 2.0,
                                                            x[0] * 0 + 3.0]))
    return gp, [1.0, 0.0, 0.0], dict(max_num_iterations=100)


GP_CASES = ["rosenbrock", "rosenbrock_user_gradient", "quaternion", "sphere_user_gradient"]


@pytest.mark.parametrize("name", GP_CASES)
def test_gradient_problem_on_its_regions(name):
    gp_j, x0, kw = _gp(ct, name)
    kw = dict(dict(max_num_iterations=200), **kw)
    xj = np.array(x0, dtype=np.float64)
    sj = ct.solve_gradient_problem(ct.GradientProblemOptions(**kw), gp_j, xj)
    gp, _, _ = _gp(ctt, name)
    runs = []
    for kind in ("solve", "solve", "eager"):
        x = np.array(x0, dtype=np.float64)
        opts = ctt.GradientProblemOptions(**kw)
        s = (eager_gradient_problem(opts, gp, x, "cpu") if kind == "eager"
             else ctt.solve_gradient_problem(opts, gp, x, device="cpu"))
        runs.append((s, x))
    (first, x_first), rest = runs[0], runs[1:]
    assert not first.captured_loop
    for s, x in rest:
        assert _bits(s) == _bits(first) and np.array_equal(x, x_first)
    assert len(gp._graphs) == 1  # kept on the problem; on the CPU the eager run's too
    _same([(sj, xj), (first, x_first)])
