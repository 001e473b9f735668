"""The JAX package's results that ``chip_smoke.py`` holds the port to, and
the parity test of the solves that make them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_references.py [WHAT ...]

prints one JSON line per reference, computed by ``ceres_tpu`` in float64 on
the CPU, WHAT one of:

- ``large``: ``ceres_tpu.fused_solve`` of the large instance (464 / 200 000
  / 1 200 000, seed 7, the large phase's options) with and without
  ``HuberLoss(1.0)`` (ROBUST_LARGE_REFERENCE_FINAL_COST; about six minutes);
- ``flagship_host_loop``: ``ceres_tpu.solve`` of the flagship instance
  bounded and non-monotonic (FLAGSHIP_BOUNDED_REFERENCE,
  FLAGSHIP_NONMONOTONIC_REFERENCE; about half a minute);
- ``large_dogleg`` and ``large_inner``: ``ceres_tpu.solve`` of the large
  instance at the large phase's options under DOGLEG (traditional and
  subspace) and with inner iterations, the latter in float32 too
  (LARGE_DOGLEG_REFERENCE, LARGE_INNER_REFERENCE);
- ``flagship_line_search``: ``ceres_tpu.solve`` of the flagship instance
  with the LINE_SEARCH minimizer (L-BFGS, Wolfe, 100 iterations), and the
  same from a start one ulp away in one coordinate, either way: how far the
  reference's own trajectory moves (FLAGSHIP_LINE_SEARCH_REFERENCE);
- ``rosenbrock``: ``examples/rosenbrock.py``'s problem through
  ``ceres_tpu.solve_gradient_problem`` once per direction type, and again
  from starts one ulp away (ROSENBROCK_REFERENCE);
- ``check_gradients``: the message of a solve with ``check_gradients`` of a
  residual whose hand-written Jacobian is wrong (WRONG_JACOBIAN_MESSAGE);
- ``sparse`` (or one of its parts): ``ceres_tpu.solve`` of the 2500-pose
  graph with SPARSE_NORMAL_CHOLESKY (``sparse_pose_graph``,
  POSE_GRAPH_SPARSE_REFERENCE, 5 s), of chip_smoke.sequential_instance with
  SPARSE_SCHUR (``sparse_sequential``, SEQUENTIAL_SPARSE_SCHUR_REFERENCE,
  about 35 s and 3 GB) and of the flagship with each cluster preconditioner
  (``sparse_flagship_clusters``, FLAGSHIP_CLUSTER_REFERENCE, 20 s).

The tests run each function through both packages at a small size: the
same records and costs (rtol 1e-10; the line search's 1e-9), active bounds
and evaluation-callback calls (the large one is ``fused_solve``, held to the
JAX package by test_torch_solve.py).
"""

import dataclasses
import json
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg

LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7)
FLAGSHIP = dict(num_cameras=16, num_points=22106, num_observations=83718, seed=16)
SMALL = dict(num_cameras=4, num_points=200, num_observations=800, seed=3)
LARGE_MINIMIZERS = {
    "dogleg_traditional": dict(trust_region_strategy_type="DOGLEG",
                               dogleg_type="TRADITIONAL_DOGLEG"),
    "dogleg_subspace": dict(trust_region_strategy_type="DOGLEG", dogleg_type="SUBSPACE_DOGLEG"),
    "inner_iterations": dict(use_inner_iterations=True),
}
DIRECTIONS = ("LBFGS", "BFGS", "NONLINEAR_CONJUGATE_GRADIENT", "STEEPEST_DESCENT")
RECORDS_CHECKED = (25, 50, 75, 100)  # flagship line search records kept


def _package(mod):
    return (jbal, {}) if mod is ct else (tbal, dict(device="cpu"))


def large_references(mod, sizes=LARGE):
    """fused_solve of the instance at the large phase's options, f64, plain
    and with HuberLoss(1.0): [(loss, LM iterations, final cost, seconds)]."""
    bm, kw = _package(mod)
    fused = jax_fused_solve if mod is ct else ctt.fused_solve
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    out = []
    for loss in (None, mod.loss.HuberLoss(1.0)):
        t0 = time.time()
        opts = bm.default_options(iterative=False)
        opts.max_num_iterations = 50
        opts.evaluation_dtype = "float64"
        s = fused(opts, bm.build_problem(inst, loss=loss)[0], **kw)
        count = len(s.iterations) if mod is ct else s.num_iterations
        out.append((None if loss is None else "HuberLoss(1.0)", count, s.final_cost,
                    time.time() - t0))
    return out


class _Counter:
    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        self.calls += 1


def flagship_host_loop_references(mod, sizes=FLAGSHIP):
    """The flagship host-loop phase's two solves at
    bal.default_options(iterative=True), f64: bounded (every point's z in
    [-1, 1], the start clipped into the box) -> (records, final cost, active
    bounds); non-monotonic with an evaluation callback and a time budget of
    1e5 s -> (records, final cost, evaluation-callback calls)."""
    bm, kw = _package(mod)
    boxed = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    boxed.points[:, 2] = np.clip(boxed.points[:, 2], -1.0, 1.0)
    p, _, pts = bm.build_problem(boxed)
    for pid in pts:
        p.set_parameter_lower_bound(int(pid), 2, -1.0)
        p.set_parameter_upper_bound(int(pid), 2, 1.0)
    s = mod.solve(bm.default_options(iterative=True), p, **kw)
    z = np.array([p.parameter_block_value(int(pid))[2] for pid in pts])
    assert np.all(np.abs(z) <= 1.0)
    bounded = (len(s.iterations), s.final_cost, int(np.sum(np.abs(z) == 1.0)))

    counter = type("Counter", (_Counter, mod.EvaluationCallback), {})()
    opts = bm.default_options(iterative=True)
    opts.use_nonmonotonic_steps = True
    opts.evaluation_callback = counter
    opts.max_solver_time_in_seconds = 1e5
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    s = mod.solve(opts, bm.build_problem(inst)[0], **kw)
    return bounded, (len(s.iterations), s.final_cost, counter.calls)


def _set_options(mod, opts, changes):
    enums = {"trust_region_strategy_type": mod.TrustRegionStrategyType,
             "dogleg_type": mod.DoglegType, "minimizer_type": mod.MinimizerType,
             "line_search_direction_type": mod.LineSearchDirectionType,
             "line_search_type": mod.LineSearchType}
    for k, v in changes.items():
        setattr(opts, k, enums[k][v] if k in enums else v)
    return opts


def large_minimizer_references(mod, names, sizes=LARGE, dtype="float64"):
    """``solve`` of the instance at the large phase's options (DENSE_SCHUR,
    50 iterations, ``dtype``) with each named change of LARGE_MINIMIZERS:
    {name: (records, final cost, termination, inner-iteration steps,
    seconds)}."""
    bm, kw = _package(mod)
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    out = {}
    for name in names:
        t0 = time.time()
        opts = bm.default_options(iterative=False)
        opts.max_num_iterations = 50
        opts.evaluation_dtype = dtype
        _set_options(mod, opts, LARGE_MINIMIZERS[name])
        s = mod.solve(opts, bm.build_problem(inst)[0], **kw)
        out[name] = (len(s.iterations), s.final_cost, s.termination_type.name,
                     s.num_inner_iteration_steps, time.time() - t0)
    return out


def _cg_records(s):
    return [r.linear_solver_iterations for r in s.iterations]


def pose_graph_sparse_references(mod, poses=2500, seed=0):
    """``solve`` of ``pose_graph.synthesize_sphere(poses, seed)`` at
    ``pose_graph.default_options()`` with SPARSE_NORMAL_CHOLESKY (AMD), f64:
    (records, final cost, termination, seconds)."""
    pg = jpg if mod is ct else tpg
    kw = {} if mod is ct else dict(device="cpu")
    t0 = time.time()
    problem = pg.build_problem_3d(*pg.synthesize_sphere(poses, seed=seed)[:3])[0]
    opts = pg.default_options()
    opts.linear_solver_type = mod.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    s = mod.solve(opts, problem, **kw)
    return len(s.iterations), s.final_cost, s.termination_type.name, time.time() - t0


def sequential_sparse_schur_references(mod, sizes=None, dtype="float64"):
    """``solve`` of chip_smoke.sequential_instance (``sizes`` its
    arguments) at bal.default_options(iterative=False) with SPARSE_SCHUR
    (AMD): (records, final cost, termination, seconds)."""
    import chip_smoke

    bm, kw = _package(mod)
    t0 = time.time()
    inst = chip_smoke.sequential_instance(**(sizes or {}))
    opts = bm.default_options(iterative=False)
    opts.linear_solver_type = mod.LinearSolverType.SPARSE_SCHUR
    opts.evaluation_dtype = dtype
    s = mod.solve(opts, bm.build_problem(bm.BALProblem(*dataclasses.astuple(inst)))[0], **kw)
    return len(s.iterations), s.final_cost, s.termination_type.name, time.time() - t0


def flagship_cluster_references(mod, sizes=FLAGSHIP):
    """``solve`` of the flagship instance at bal.default_options(
    iterative=True) with CLUSTER_JACOBI and with CLUSTER_TRIDIAGONAL, f64:
    {preconditioner: (records, CG iterations per record, final cost,
    seconds)}."""
    bm, kw = _package(mod)
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    out = {}
    for pt in ("CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"):
        t0 = time.time()
        opts = bm.default_options(iterative=True)
        opts.preconditioner_type = mod.PreconditionerType[pt]
        s = mod.solve(opts, bm.build_problem(inst)[0], **kw)
        out[pt] = (len(s.iterations), _cg_records(s), s.final_cost, time.time() - t0)
    return out


def _nudged(problem, pid, direction):
    """The block's first value moved one ulp toward +inf or -inf."""
    v = np.array(problem.parameter_block_value(pid), dtype=np.float64)
    v[0] = np.nextafter(v[0], direction * np.inf)
    problem.set_parameter_block_value(pid, v)


def flagship_line_search_references(mod, sizes=FLAGSHIP, max_iters=100, nudge=0):
    """``solve`` of the instance with the LINE_SEARCH minimizer (L-BFGS,
    Wolfe, ``max_iters`` iterations) at bal.default_options(iterative=True),
    f64, the first point's first coordinate moved ``nudge`` ulps: (records,
    final cost, termination, line-search evaluations, costs of the records
    RECORDS_CHECKED that exist)."""
    bm, kw = _package(mod)
    p, _, pts = bm.build_problem(bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes))
    if nudge:
        _nudged(p, int(pts[0]), nudge)
    opts = _set_options(mod, bm.default_options(iterative=True), dict(
        minimizer_type="LINE_SEARCH", line_search_direction_type="LBFGS",
        line_search_type="WOLFE", max_num_iterations=max_iters))
    s = mod.solve(opts, p, **kw)
    costs = [s.iterations[i].cost for i in RECORDS_CHECKED if i < len(s.iterations)]
    evals = sum(r.line_search_function_evaluations for r in s.iterations)
    return len(s.iterations), s.final_cost, s.termination_type.name, evals, costs


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def rosenbrock_references(mod, nudge=0):
    """examples/rosenbrock.py's problem (max_num_iterations=200) once per
    direction type from (-1.2, 1) with its first coordinate moved ``nudge``
    ulps: {direction: (records, termination, final x)}."""
    out = {}
    for d in DIRECTIONS:
        x = np.array([-1.2, 1.0])
        x[0] = np.nextafter(x[0], nudge * np.inf) if nudge else x[0]
        opts = mod.GradientProblemOptions(
            max_num_iterations=200, line_search_direction_type=mod.LineSearchDirectionType[d])
        gp = mod.GradientProblem(rosenbrock, num_parameters=2)
        kw = {} if mod is ct else dict(device="cpu")
        s = mod.solve_gradient_problem(opts, gp, x, **kw)
        out[d] = (len(s.iterations), s.termination_type.name, x.tolist())
    return out


def wrong_jacobian_message(mod):
    """The message of a solve with check_gradients of r = x^2 - 2 at 1.5
    whose analytic Jacobian is 3x."""
    stack = jnp.stack if mod is ct else torch.stack
    fn = mod.cost_functions.analytic_cost(
        lambda x: x * x - 2.0, lambda x: (stack([3.0 * x[0]]).reshape(1, 1),))
    p = mod.Problem()
    p.add_residual_block(fn, None, [p.add_parameter_block(np.array([1.5]))])
    opts = mod.SolverOptions(linear_solver_type=mod.LinearSolverType.DENSE_QR,
                             check_gradients=True)
    return (mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)).message


def test_wrong_jacobian_message_matches_jax():
    assert wrong_jacobian_message(ctt) == wrong_jacobian_message(ct)


def test_large_minimizer_solves_match_jax():
    js = large_minimizer_references(ct, list(LARGE_MINIMIZERS), SMALL)
    ts = large_minimizer_references(ctt, list(LARGE_MINIMIZERS), SMALL)
    for name in LARGE_MINIMIZERS:
        assert ts[name][0] == js[name][0] > 3 and ts[name][2:4] == js[name][2:4], name
        np.testing.assert_allclose(ts[name][1], js[name][1], rtol=1e-10)
    assert ts["inner_iterations"][3] > 0


def test_flagship_line_search_matches_jax():
    j = flagship_line_search_references(ct, SMALL, max_iters=30)
    t = flagship_line_search_references(ctt, SMALL, max_iters=30)
    assert t[0] == j[0] == 31 and t[2:4] == j[2:4]
    np.testing.assert_allclose([t[1], *t[4]], [j[1], *j[4]], rtol=1e-9)


def test_rosenbrock_matches_jax():
    """The directions whose reference trajectory does not move under a
    one-ulp change of the start take the same records and x."""
    j, t = rosenbrock_references(ct), rosenbrock_references(ctt)
    for d in ("LBFGS", "BFGS"):
        assert t[d][:2] == j[d][:2] == (t[d][0], "CONVERGENCE"), d
        np.testing.assert_allclose(t[d][2], j[d][2], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("what", ["pose_graph", "sequential", "flagship_clusters"])
def test_sparse_references_match_jax(what):
    """The sparse phases' solves at a small size: the same records,
    termination and costs (rtol 1e-10) and, for the clusters, CG
    iterations."""
    if what == "pose_graph":
        j, t = (pose_graph_sparse_references(m, poses=60, seed=1) for m in (ct, ctt))
    elif what == "sequential":
        tiny = dict(num_cameras=20, num_points=150, fifth=50)
        j, t = (sequential_sparse_schur_references(m, tiny) for m in (ct, ctt))
    else:
        cj, ctr = (flagship_cluster_references(m, SMALL) for m in (ct, ctt))
        for name in cj:
            assert ctr[name][:2] == cj[name][:2]
            np.testing.assert_allclose(ctr[name][2], cj[name][2], rtol=1e-10)
        return
    assert t[0] == j[0] > 2 and t[2] == j[2]
    np.testing.assert_allclose(t[1], j[1], rtol=1e-10)


def test_flagship_host_loop_solves_match_jax():
    (bj, nj), (bt, nt) = (flagship_host_loop_references(m, SMALL) for m in (ct, ctt))
    assert bt[0] == bj[0] and bt[2] == bj[2] > 0
    assert nt[0] == nj[0] and nt[2] == nj[2] > 0
    np.testing.assert_allclose([bt[1], nt[1]], [bj[1], nj[1]], rtol=1e-10)


def _spread(runs):
    """Largest relative difference of each number of the nudged runs from
    the first run's."""
    base = np.asarray(runs[0], dtype=np.float64)
    return np.max([np.abs(np.asarray(r, dtype=np.float64) - base) / np.maximum(np.abs(base), 1e-300)
                   for r in runs[1:]], axis=0).tolist()


if __name__ == "__main__":
    sparse = ["sparse_pose_graph", "sparse_sequential", "sparse_flagship_clusters"]
    for what in [w for a in sys.argv[1:] or ["large", "flagship_host_loop"]
                 for w in (sparse if a == "sparse" else [a])]:
        t0 = time.time()
        if what == "large":
            for loss, count, cost, seconds in large_references(ct):
                print(json.dumps(dict(reference="large", loss=loss, lm_iterations=count,
                                      final_cost=cost, seconds=seconds)), flush=True)
        elif what == "flagship_host_loop":
            bounded, nonmono = flagship_host_loop_references(ct)
            print(json.dumps(dict(reference="flagship_host_loop", bounded=bounded,
                                  nonmonotonic=nonmono)), flush=True)
        elif what in ("large_dogleg", "large_inner"):
            names = [n for n in LARGE_MINIMIZERS if n.startswith(what[6:])]
            for dtype in ("float64", "float32") if what == "large_inner" else ("float64",):
                for name, result in large_minimizer_references(ct, names, dtype=dtype).items():
                    print(json.dumps(dict(reference=name, dtype=dtype, result=result)), flush=True)
        elif what == "flagship_line_search":
            runs = [flagship_line_search_references(ct, nudge=n) for n in (0, 1, -1)]
            print(json.dumps(dict(
                reference=what, result=runs[0], nudged=runs[1:],
                spread_of_final_and_checked_costs=_spread([[r[1], *r[4]] for r in runs]),
                seconds=time.time() - t0)), flush=True)
        elif what == "sparse_pose_graph":
            print(json.dumps(dict(reference=what, result=pose_graph_sparse_references(ct))),
                  flush=True)
        elif what == "sparse_sequential":
            print(json.dumps(dict(reference=what, result=sequential_sparse_schur_references(ct))),
                  flush=True)
        elif what == "sparse_flagship_clusters":
            print(json.dumps(dict(reference=what, result=flagship_cluster_references(ct))),
                  flush=True)
        elif what == "check_gradients":
            print(json.dumps(dict(reference=what, message=wrong_jacobian_message(ct))), flush=True)
        elif what == "rosenbrock":
            runs = [rosenbrock_references(ct, nudge=n) for n in (0, 1, -1)]
            print(json.dumps(dict(
                reference=what, result=runs[0], nudged=runs[1:],
                x_spread={d: float(np.max(np.abs(np.subtract(
                    [r[d][2] for r in runs[1:]], runs[0][d][2])))) for d in DIRECTIONS},
                seconds=time.time() - t0)), flush=True)
