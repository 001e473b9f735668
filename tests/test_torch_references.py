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
- ``flagship_inner``: ``ceres_tpu.solve`` of the flagship instance at
  bal.default_options(iterative=True) with inner iterations
  (FLAGSHIP_INNER_REFERENCE);
- ``flagship_line_search``: ``ceres_tpu.solve`` of the flagship instance
  with the LINE_SEARCH minimizer (L-BFGS, Wolfe, 100 iterations), and the
  same from a start one ulp away in one coordinate, either way: how far the
  reference's own trajectory moves (FLAGSHIP_LINE_SEARCH_REFERENCE);
- ``rosenbrock``: ``examples/rosenbrock.py``'s problem through
  ``ceres_tpu.solve_gradient_problem`` once per direction type, and again
  from starts one ulp away (ROSENBROCK_REFERENCE);
- ``check_gradients``: the message of a solve with ``check_gradients`` of a
  residual whose hand-written Jacobian is wrong (WRONG_JACOBIAN_MESSAGE);
- ``libmv_gauge_fixed``: the libmv phase's refined, gauge-fixed solve and
  its spread under one-ulp changes of the start (LIBMV_GAUGE_FIXED_*), and
  at the libmv tests' size the port's distance from JAX beside that spread,
  refined and gauge-fixed (about three minutes);
- ``cg_column`` and ``inner_f32``: ROADMAP Queue 3's checks of items 13
  (the covariance CG's counts and stopping test in both packages, about
  20 minutes) and 10 (the f32 large solve with inner iterations from nudged
  starts and restarted from one point, both packages, about 25 minutes);
- ``inner_pass``: item 10's block-by-block check, one inner-iteration pass
  of both packages from the same f32 point (``inner_pass``'s docstring);
- ``examples``: every program of chip_smoke.EXAMPLES at the examples
  phase's argv (EXAMPLES_REFERENCE; about six minutes, five of them the
  denoising program's two iterations on the 481 x 321 image);
- ``sparse`` (or one of its parts): ``ceres_tpu.solve`` of the 2500-pose
  graph with SPARSE_NORMAL_CHOLESKY (``sparse_pose_graph``,
  POSE_GRAPH_SPARSE_REFERENCE, 5 s; under DOGLEG ``sparse_pose_graph_dogleg``,
  POSE_GRAPH_SPARSE_DOGLEG_REFERENCE, and with mixed precision too
  ``sparse_pose_graph_dogleg_mixed``,
  POSE_GRAPH_SPARSE_DOGLEG_MIXED_REFERENCE), of chip_smoke.sequential_instance with
  SPARSE_SCHUR (``sparse_sequential``, SEQUENTIAL_SPARSE_SCHUR_REFERENCE,
  about 35 s and 3 GB) and of the flagship with each cluster preconditioner
  (``sparse_flagship_clusters``, FLAGSHIP_CLUSTER_REFERENCE, 20 s).

The tests run each function through both packages at a small size: the
same records and costs (rtol 1e-10; the line search's 1e-9), active bounds
and evaluation-callback calls (the large one is ``fused_solve``, held to the
JAX package by test_torch_solve.py).
"""

import contextlib
import dataclasses
import importlib
import io
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
import chip_smoke
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


def flagship_inner_references(mod, sizes=FLAGSHIP, dtype="float64"):
    """``solve`` of the flagship instance at bal.default_options(
    iterative=True) (ITERATIVE_SCHUR + SCHUR_JACOBI, 50 iterations) with
    ``use_inner_iterations``, ``dtype``: (records, final cost, termination,
    inner-iteration steps, CG iterations, seconds)."""
    bm, kw = _package(mod)
    t0 = time.time()
    opts = bm.default_options(iterative=True)
    opts.max_num_iterations = 50
    opts.evaluation_dtype = dtype
    opts.use_inner_iterations = True
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    s = mod.solve(opts, bm.build_problem(inst)[0], **kw)
    return (len(s.iterations), s.final_cost, s.termination_type.name,
            s.num_inner_iteration_steps, s.num_linear_solver_iterations, time.time() - t0)


def _cg_records(s):
    return [r.linear_solver_iterations for r in s.iterations]


def pose_graph_sparse_references(mod, poses=2500, seed=0, dogleg=False, mixed=False):
    """``solve`` of ``pose_graph.synthesize_sphere(poses, seed)`` at
    ``pose_graph.default_options()`` with SPARSE_NORMAL_CHOLESKY (AMD), f64,
    under DOGLEG (traditional) with ``dogleg``, with
    ``use_mixed_precision_solves`` with ``mixed``: (records, final cost,
    termination, seconds)."""
    pg = jpg if mod is ct else tpg
    kw = {} if mod is ct else dict(device="cpu")
    t0 = time.time()
    problem = pg.build_problem_3d(*pg.synthesize_sphere(poses, seed=seed)[:3])[0]
    opts = pg.default_options()
    opts.linear_solver_type = mod.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    if dogleg:
        opts.trust_region_strategy_type = mod.TrustRegionStrategyType.DOGLEG
    opts.use_mixed_precision_solves = mixed
    s = mod.solve(opts, problem, **kw)
    return len(s.iterations), s.final_cost, s.termination_type.name, time.time() - t0


def pose_graph_subset_references(mod, poses=500, seed=0):
    """``solve`` of ``pose_graph.synthesize_sphere(poses, seed)`` at
    ``pose_graph.default_options()`` with CGNR + SUBSET, its odometry edges
    (the first poses - 1 residual blocks) as the subset, f64: (records, CG
    iterations, final cost, termination, seconds)."""
    pg = jpg if mod is ct else tpg
    kw = {} if mod is ct else dict(device="cpu")
    t0 = time.time()
    problem = pg.build_problem_3d(*pg.synthesize_sphere(poses, seed=seed)[:3])[0]
    opts = pg.default_options()
    opts.preconditioner_type = mod.PreconditionerType.SUBSET
    opts.residual_blocks_for_subset_preconditioner = list(range(poses - 1))
    s = mod.solve(opts, problem, **kw)
    return (len(s.iterations), s.num_linear_solver_iterations, s.final_cost,
            s.termination_type.name, time.time() - t0)


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


# ---- slice 10 (item 17 and item 18's models) --------------------------------


def _kw(mod, **extra):
    return {} if mod is ct else dict(device="cpu", **extra)


def _module(mod, name):
    return importlib.import_module(f"{mod.__name__}.{name}")


def covariance_references(mod, sizes=LARGE, dtype="float64"):
    """``Covariance().compute`` of the BAL instance at its own values (no
    solve), camera 0 and the last point constant (the gauge), every
    camera's diagonal block and 4 cross pairs: (the 4 named tangent blocks,
    trace(S^-1) over the cameras, the path, seconds)."""
    bm, _ = _package(mod)
    t0 = time.time()
    p, cams, pts = bm.build_problem(bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes))
    p.set_parameter_block_constant(int(cams[0]))
    p.set_parameter_block_constant(int(pts[-1]))
    pairs, named = chip_smoke.covariance_pairs(cams)
    cov = mod.Covariance()
    assert cov.compute(pairs, p, **_kw(mod, evaluation_dtype=dtype))
    blocks = {k: cov.get_covariance_block_in_tangent_space(*v).tolist() for k, v in named.items()}
    trace = float(sum(np.trace(cov.get_covariance_block_in_tangent_space(int(c), int(c)))
                      for c in cams[1:]))
    path = "schur" if cov._schur_cov is not None else "other"
    return blocks, trace, path, time.time() - t0


def covariance_matrix_free_references(mod, poses=2500, seed=0):
    """``Covariance().compute`` of ``pose_graph.synthesize_sphere(poses,
    seed)`` at its own values: the quaternion blocks of poses 1, poses/2 and
    poses-1, their diagonal blocks and (1, last), in ambient space: (the 4
    blocks, the path, CG iterations per column, seconds). JAX's batched CG
    does not return its counts; they are taken as those of its unbatched
    solves of the same columns (jax_unbatched_cg_iterations; at 2500 poses
    the batched loop's counts, read out with jax.debug.callback, are the
    same numbers in another order)."""
    pg = jpg if mod is ct else tpg
    t0 = time.time()
    problem, _, quat_id = pg.build_problem_3d(*pg.synthesize_sphere(poses, seed=seed)[:3])
    q = [quat_id[v] for v in (1, poses // 2, poses - 1)]
    pairs = [(q[0], q[0]), (q[1], q[1]), (q[2], q[2]), (q[0], q[2])]
    cov = mod.Covariance()
    assert cov.compute(pairs, problem, **_kw(mod))
    if mod is ct:
        iterations = jax_unbatched_cg_iterations(poses, seed)
    else:
        iterations = cov.statistics["cg_iterations"]
    blocks = [cov.get_covariance_block(*pair).tolist() for pair in pairs]
    path = "matrix_free" if cov._mf_Z is not None else "other"
    return blocks, path, iterations, time.time() - t0


def _numeric_bal(mod, inst, method, options=None):
    """The BAL problem with the Snavely residual wrapped in numeric_diff."""
    bm, _ = _package(mod)
    p = mod.Problem()
    cams = p.add_parameter_blocks(inst.cameras)
    pts = p.add_parameter_blocks(inst.points)
    order = np.argsort(inst.point_index, kind="stable")
    p.add_residual_blocks(
        mod.numeric_diff(bm.snavely_reprojection_residual, method, options), None,
        [cams[inst.camera_index[order]], pts[inst.point_index[order]]],
        data=inst.observations[order])
    return p


def _records(s):
    return [(r.cost, r.linear_solver_iterations) for r in s.iterations]


def numeric_diff_references(mod, sizes=FLAGSHIP, ridders_extrapolations=10):
    """``solve`` of the BAL instance at bal.default_options(iterative=True)
    with the residual under numeric_diff: CENTRAL to the end and RIDDERS
    (``ridders_extrapolations``) for 3 iterations, f64: {method: (records
    (cost, CG iterations), final cost, termination, seconds)}."""
    bm, kw = _package(mod)
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    options = mod.NumericDiffOptions(max_num_ridders_extrapolations=ridders_extrapolations)
    out = {}
    for method, iters in (("CENTRAL", 50), ("RIDDERS", 3)):
        t0 = time.time()
        opts = bm.default_options(iterative=True)
        opts.max_num_iterations = iters
        s = mod.solve(opts, _numeric_bal(mod, inst, method, options), **kw)
        out[method] = (_records(s), s.final_cost, s.termination_type.name, time.time() - t0)
    return out


def denoising_references(mod, directory, dtype="float64", max_iters=10, **sizes):
    """The denoising model on chip_smoke.write_denoising_inputs(directory,
    **sizes) at default_options() with ``max_iters`` iterations: (records,
    final cost, termination, seconds)."""
    dn = _module(mod, "models.denoising")
    paths = chip_smoke.write_denoising_inputs(directory, **sizes)
    t0 = time.time()
    p, _ = dn.build_problem(dn.read_pgm(paths[0]), dn.load_foe_file(paths[1]),
                            sigma=chip_smoke.DENOISING["sigma"])
    opts = dn.default_options()
    opts.max_num_iterations = max_iters
    opts.evaluation_dtype = dtype
    s = mod.solve(opts, p, **_kw(mod))
    return _records(s), s.final_cost, s.termination_type.name, time.time() - t0


def libmv_references(mod, directory, variants=(False, True), nudge=0, **sizes):
    """The libmv model on chip_smoke.write_libmv_shot(**sizes) at
    default_options(), f64, intrinsics fixed (False), refined (True) and
    refined with the gauge fixed ("gauge_fixed": camera 0 and the last
    point constant, chip_smoke.libmv_problem), the first point's first
    coordinate moved ``nudge`` ulps: {variant: (records, final cost,
    termination, seconds)}."""
    lm = _module(mod, "models.libmv")
    path = f"{directory}/shot.bin"
    chip_smoke.write_libmv_shot(path, **sizes)
    out = {}
    for variant in variants:
        t0 = time.time()
        shot = lm.load_libmv_file(path)
        p = chip_smoke.libmv_problem(lm, shot, variant)
        if nudge:
            _nudged(p, 1 + shot.cameras_Rt.shape[0], nudge)  # ids: intrinsics, cameras, points
        s = mod.solve(lm.default_options(), p, **_kw(mod))
        out[variant] = (_records(s), s.final_cost, s.termination_type.name, time.time() - t0)
    return out


def nist_references(mod, directory):
    """run_suite over chip_smoke.write_nist_files(directory): [(name,
    start, LRE, final cost, records, termination)]."""
    nm = _module(mod, "models.nist")
    chip_smoke.write_nist_files(directory)
    return [(r["name"], r["start"], r["lre"], r["final_cost"], r["iterations"], r["termination"])
            for r in nm.run_suite(directory, **_kw(mod))]


def _jax_tiny_residual(y):
    t, yy = jnp.asarray(chip_smoke.TINY_SAMPLES), jnp.asarray(y)

    def fn(x):
        rosen = jnp.concatenate([jnp.stack([10.0 * (x[1] - x[0] * x[0]), 1.0 - x[0]]),
                                 jnp.zeros(yy.shape[0] - 2)])
        fit = x[0] * jnp.exp(x[1] * t) + x[2] - yy
        return jnp.where(x[3] > 0, rosen, fit)

    return fn


def tiny_references(mod, problems=None):
    """One batched tiny_solve of chip_smoke.tiny_batch(problems): (x,
    iterations, status, final costs) as numpy, and the checksums the phase
    compares (chip_smoke.tiny_checksums)."""
    cs = chip_smoke
    x0, y = cs.tiny_batch(**({} if problems is None else dict(problems=problems)))
    t0 = time.time()
    if mod is ct:
        solve_one = importlib.import_module("ceres_tpu.tiny_solver").tiny_solve
        fn = _jax_tiny_residual(y)
        r = jax.vmap(lambda z: solve_one(fn, z))(jnp.asarray(x0))
        out = [np.asarray(a) for a in (r.x, r.iterations, r.converged, r.cost)]
    else:
        r = mod.tiny_solve(cs.tiny_residual(y), x0, device="cpu")
        out = [a.cpu().numpy() for a in (r.x, r.iterations, r.converged, r.cost)]
    return out, chip_smoke.tiny_checksums(*out[:3]), time.time() - t0


def block_fingerprint(block):
    """What the phases hold a covariance block to: its diagonal, largest
    |entry|, Frobenius norm and sum of entries."""
    b = np.asarray(block, dtype=np.float64)
    return dict(diag=np.diag(b).tolist(), max_abs=float(np.max(np.abs(b))),
                norm=float(np.linalg.norm(b)), sum=float(np.sum(b)))


def jax_unbatched_cg_iterations(poses=2500, seed=0):
    """The CG iterations of each column of covariance_matrix_free_references
    solved one at a time by the JAX package's CG, with the settings of its
    matrix-free covariance (ceres_tpu/covariance.py:283-296): how far the
    counts of a column move between a batched and an unbatched solve."""
    from ceres_tpu.evaluator import Evaluator

    jcg = importlib.import_module("ceres_tpu.linear.cg")
    problem, _, quat_id = jpg.build_problem_3d(*jpg.synthesize_sphere(poses, seed=seed)[:3])
    program = problem.program()
    ctx = Evaluator(program).cost_gradient_jacobian(program.initial_ambient()).jacobian_context
    n = program.num_tangent
    inv_d = jnp.asarray(1.0 / np.asarray(ctx.squared_column_norms()))
    solve = jax.jit(lambda e: jcg.conjugate_gradients(
        ctx.normal_matvec, e, preconditioner=lambda v: v * inv_d,
        max_num_iterations=int(min(10 * n, 20_000)), min_num_iterations=1,
        r_tolerance=1e-10, residual_reset_period=100).num_iterations)
    out = []
    for v in (1, poses // 2, poses - 1):
        off = program.tangent_offset[quat_id[v]]
        for c in range(off, off + 3):
            out.append(int(solve(jnp.zeros(n).at[c].set(1.0))))
    return out


def c_api_references(mod, points=None):
    """The C API's curve fit (chip_smoke.curve_fit_c_api): (m, c, final
    cost, records, whether the report was printed)."""
    capi = _module(mod, "c_api")
    sizes = {} if points is None else dict(points=points)
    m, c, s, text = chip_smoke.curve_fit_c_api(capi, **sizes, **_kw(mod))
    return float(m[0]), float(c[0]), s.final_cost, len(s.iterations), "Solver Summary" in text


def interpolation_references(mod, **sizes):
    """The translation recovery of examples/bicubic_interpolation.py on
    chip_smoke.interpolation_instance(**sizes), default SolverOptions, f64:
    (records, final cost, shift, termination, seconds)."""
    values, pts, vals = chip_smoke.interpolation_instance(**sizes)
    t0 = time.time()
    interp = mod.BiCubicInterpolator(mod.Grid2D(values, row_begin=-2, col_begin=-2))
    if mod is ct:
        def residual(shift, data):
            q, v = data
            return jax.vmap(lambda a: interp.evaluate(a[0] + shift[0], a[1] + shift[1])[0][0])(q) - v
        data = (jnp.asarray(pts), jnp.asarray(vals))
    else:
        def residual(shift, data):
            q, v = data
            f = torch.func.vmap(lambda a: interp.evaluate(a[0:1] + shift[0:1], a[1:2] + shift[1:2])[0])
            return f(q).reshape(-1) - v
        data = (pts, vals)
    p = mod.Problem()
    b = p.add_parameter_block(np.zeros(2))
    p.add_residual_block(residual, None, [b], data=data)
    s = mod.solve(mod.SolverOptions(max_num_iterations=50), p, **_kw(mod))
    return (_records(s), s.final_cost, p.parameter_block_value(b).tolist(),
            s.termination_type.name, time.time() - t0)


def libmv_spread(directory, variant="gauge_fixed", **sizes):
    """JAX's libmv solve of ``variant`` from its start and from starts one
    ulp away in the first point's first coordinate, either way: (records,
    final cost, termination of the start's solve; the largest relative
    change of a shared record and of the final cost; the record counts)."""
    runs = [libmv_references(ct, directory, (variant,), n, **sizes)[variant] for n in (0, 1, -1)]
    base = runs[0]
    records = max(abs(a[0] - b[0]) / b[0] for r in runs[1:] for a, b in zip(r[0], base[0]))
    final = max(abs(r[1] - base[1]) / base[1] for r in runs[1:])
    return base[:3], (records, final), [len(r[0]) for r in runs]


def libmv_test_size_spread(directory, **sizes):
    """At ``sizes`` (tests/test_torch_libmv.py's): for the refined and the
    gauge-fixed solve, the largest relative difference of the port's
    records from JAX's, and of JAX's own records under one-ulp changes of
    the first point either way."""
    out = {}
    for variant in (True, "gauge_fixed"):
        j, t = (libmv_references(m, directory, (variant,), **sizes)[variant][0] for m in (ct, ctt))
        nudged = [libmv_references(ct, directory, (variant,), n, **sizes)[variant][0]
                  for n in (1, -1)]
        out[str(variant)] = dict(
            port=max(abs(a[0] - b[0]) / b[0] for a, b in zip(t, j)),
            jax_nudged=[max(abs(a[0] - b[0]) / b[0] for a, b in zip(r, j)) for r in nudged],
            records=[len(t), len(j)] + [len(r) for r in nudged])
    return out


def cg_column_counts(mod, poses=2500, seed=0):
    """The single-vector CG of the matrix-free covariance on the first
    coordinate of pose 1's quaternion of synthesize_sphere(poses, seed),
    with its settings (r_tolerance 1e-10, residual reset every 100, Jacobi
    on J'J): the iterations with the preconditioner as computed and moved
    one ulp up and down, which test stopped the first solve ("r": |r| at
    the r tolerance, else "q": the quadratic-model test), and the
    iterations when only the r test may stop it (q_tolerance -inf)."""
    pg = jpg if mod is ct else tpg
    problem, _, quat_id = pg.build_problem_3d(*pg.synthesize_sphere(poses, seed=seed)[:3])
    if mod is ct:
        from ceres_tpu.evaluator import Evaluator

        cg = importlib.import_module("ceres_tpu.linear.cg")
        program = problem.program()
        ctx = Evaluator(program).cost_gradient_jacobian(program.initial_ambient()).jacobian_context
        col = int(program.tangent_offset[quat_id[1]])
        d = np.asarray(ctx.squared_column_norms(), dtype=np.float64)
        e = jnp.zeros(program.num_tangent).at[col].set(1.0)

        def solve(inv, q_tolerance=0.0):
            inv = jnp.asarray(inv)
            r = jax.jit(lambda b: cg.conjugate_gradients(
                ctx.normal_matvec, b, preconditioner=lambda v: v * inv,
                max_num_iterations=20_000, r_tolerance=1e-10, residual_reset_period=100,
                q_tolerance=q_tolerance))(e)
            return int(r.num_iterations), float(r.final_norm_r)
    else:
        from ceres_tpu_torch.evaluator import Evaluator
        from ceres_tpu_torch.linear import cg

        program = problem.program("cpu")
        x = torch.from_numpy(program.initial_ambient())
        ctx = Evaluator(program).cost_gradient_jacobian(x).jacobian_context
        col = int(program.tangent_offsets[quat_id[1]])
        d = ctx.squared_column_norms().numpy()
        e = torch.zeros(program.num_tangent, dtype=torch.float64)
        e[col] = 1.0

        def solve(inv, q_tolerance=0.0):
            inv = torch.from_numpy(inv)
            r = cg.conjugate_gradients(
                ctx.normal_matvec, e, preconditioner=lambda v: v * inv,
                max_num_iterations=20_000, r_tolerance=1e-10, residual_reset_period=100,
                q_tolerance=q_tolerance)
            return int(r.num_iterations), float(r.final_norm_r)

    inv = 1.0 / d
    base = solve(inv)
    return dict(iterations=base[0], up=solve(np.nextafter(inv, np.inf))[0],
                down=solve(np.nextafter(inv, -np.inf))[0], final_norm_r=base[1],
                stopped_by="r" if base[1] <= 1e-10 else "q",
                r_test_only=solve(inv, -np.inf)[0])


def _inner_f32_problem(bm, nudge=0, which="point", state=None, sizes=LARGE):
    """The large instance at LARGE_MINIMIZERS' inner-iterations options in
    float32, the first point's or camera's first coordinate moved ``nudge``
    float32 ulps, or started from ``state`` (cameras, points)."""
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    if state is not None:
        inst.cameras[:], inst.points[:] = state
    p, cams, pts = bm.build_problem(inst)
    if nudge:
        pid = int(pts[0] if which == "point" else cams[0])
        v = np.array(p.parameter_block_value(pid), dtype=np.float64)
        v[0] = float(np.nextafter(np.float32(v[0]), np.float32(nudge * np.inf)))
        p.set_parameter_block_value(pid, v)
    return p, cams, pts


def inner_f32_references(mod, starts=((0, "point"), (1, "point"), (-1, "point"),
                                      (1, "camera"), (-1, "camera"))):
    """The large solve with inner iterations in float32 from its start and
    from starts one float32 ulp away: [(nudge, block, records, final cost,
    relative distance from the float64 cost LARGE_INNER_REFERENCE)]."""
    bm, kw = _package(mod)
    out = []
    for nudge, which in starts:
        opts = _set_options(mod, bm.default_options(iterative=False), dict(
            max_num_iterations=50, evaluation_dtype="float32", use_inner_iterations=True))
        s = mod.solve(opts, _inner_f32_problem(bm, nudge, which)[0], **kw)
        f64 = chip_smoke.LARGE_INNER_REFERENCE[1]
        out.append((nudge, which, len(s.iterations), s.final_cost, abs(s.final_cost - f64) / f64))
    return out


def inner_f32_restart():
    """Both packages' float32 solves with inner iterations restarted from
    JAX's state after 2 iterations (records: cost, success), and at that
    state each package's float32 costs (full evaluation, cost only, the
    exact sum of its own float32 residuals) against the float64 cost."""
    from ceres_tpu.evaluator import Evaluator as JEv, family_residuals as jres
    from ceres_tpu.problem import cast_program as jcast
    from ceres_tpu_torch.evaluator import Evaluator as TEv, family_residuals as tres
    from ceres_tpu_torch.problem import cast_program as tcast

    opts = dict(evaluation_dtype="float32", use_inner_iterations=True)
    p, cams, pts = _inner_f32_problem(jbal)
    ct.solve(_set_options(ct, jbal.default_options(iterative=False),
                          dict(max_num_iterations=2, **opts)), p)
    state = (np.stack([p.parameter_block_value(int(c)) for c in cams]),
             np.stack([p.parameter_block_value(int(q)) for q in pts]))
    out = {}
    for mod in (ct, ctt):
        bm, kw = _package(mod)
        s = mod.solve(_set_options(mod, bm.default_options(iterative=False),
                                   dict(max_num_iterations=10, **opts)),
                      _inner_f32_problem(bm, state=state)[0], **kw)
        out[mod.__name__] = dict(records=[(r.cost, r.step_is_successful) for r in s.iterations],
                                 message=s.message)
    f64 = None
    for mod, dtype in ((ct, "float64"), (ct, "float32"), (ctt, "float32")):
        q = _inner_f32_problem(_package(mod)[0], state=state)[0]
        if mod is ct:
            program = jcast(q.program(), dtype)
            ev, x = JEv(program), jnp.asarray(program.initial_ambient(), dtype=dtype)
            r = [np.asarray(jres(f, x), dtype=np.float64) for f in program.families]
        else:
            program = tcast(q.program("cpu"), dtype)
            ev = TEv(program)
            x = torch.from_numpy(program.initial_ambient()).to(program.eval_dtype)
            r = [tres(f, x).to(torch.float64).numpy() for f in program.families]
        costs = dict(full=float(ev.cost_gradient_jacobian(x).cost), cost_only=float(ev.cost(x)),
                     residual_sum=float(sum(0.5 * np.sum(a * a) for a in r)))
        f64 = f64 or costs["full"]
        out[f"{mod.__name__}_{dtype}_costs"] = {k: (v, (v - f64) / f64) for k, v in costs.items()}
    return out


def _block_costs(program, x, sets_T):
    """Per block of each size group of a set, the f64 sum of 0.5 |r|^2 over
    its rows, r the port's f32 residuals at x (the large case has no
    loss): {T: (G,) numpy}."""
    from ceres_tpu_torch.evaluator import family_residuals

    out = {T: np.zeros(G) for T, G in sets_T.items()}
    for fam in program.families:
        r = family_residuals(fam, x).to(torch.float64).numpy()
        c = 0.5 * np.sum(r * r, axis=1)
        for j, T in enumerate(fam.structure.tangent_sizes):
            if T in out:
                pos = fam.block_pos[T][j]
                keep = pos < out[T].shape[0]
                out[T] += np.bincount(pos[keep], weights=c[keep], minlength=out[T].shape[0])
    return out


def inner_pass(sizes=LARGE):
    """One inner-iteration pass of both packages, block by block (ROADMAP
    Queue 3 item 10). Both start from JAX's float32 state after two
    iterations of the inner_f32 solve; every set step of both packages
    starts from JAX's x and radii of that step, so nothing drifts. JAX's
    step runs jitted, as its solve runs it, and op by op
    (``jax.disable_jit``), the same arithmetic in another rounding. Per
    step: the blocks each accepts (its radius doubled), the blocks where the
    jitted JAX step and the port differ, and for those the f64-summed block
    cost before the step and after the accepting package's step (relative
    margin), how many the two JAX runs differ in; after the step, each
    package's own cost and the f64 sum of its f32 residuals."""
    from ceres_tpu.evaluator import Evaluator as JEv
    from ceres_tpu.inner_iterations import CoordinateDescentMinimizer as JCD
    from ceres_tpu.problem import cast_program as jcast
    from ceres_tpu_torch.evaluator import Evaluator as TEv
    from ceres_tpu_torch.inner_iterations import CoordinateDescentMinimizer as TCD
    from ceres_tpu_torch.problem import cast_program as tcast

    opts = dict(evaluation_dtype="float32", use_inner_iterations=True)
    p, cams, pts = _inner_f32_problem(jbal, sizes=sizes)
    ct.solve(_set_options(ct, jbal.default_options(iterative=False),
                          dict(max_num_iterations=2, **opts)), p)
    state = (np.stack([p.parameter_block_value(int(c)) for c in cams]),
             np.stack([p.parameter_block_value(int(q)) for q in pts]))
    jopts = _set_options(ct, jbal.default_options(iterative=False), opts)
    topts = _set_options(ctt, tbal.default_options(iterative=False), opts)
    jprog = jcast(_inner_f32_problem(jbal, state=state, sizes=sizes)[0].program(), "float32")
    tprog = tcast(_inner_f32_problem(tbal, state=state, sizes=sizes)[0].program("cpu"), "float32")
    jmin, tmin = JCD(jprog, jopts, JEv(jprog)), TCD(tprog, topts, TEv(tprog))
    out = dict(sets_equal=[list(a) for a in jmin.sets] == [list(b) for b in tmin.sets],
               set_sizes=[len(a) for a in jmin.sets], steps=[])
    x = jnp.asarray(jprog.initial_ambient(), dtype=jnp.float32)
    r0 = jopts.initial_trust_region_radius
    for si, s in enumerate(jmin.sets):
        sizes = {T: int(rows.shape[0]) for T, (rows, _) in tmin._set_structs[si].items()}
        # each family arg's row -> block position in its size group (G: none)
        for fam in tprog.families:
            fam.block_pos = {}
            for T, G in sizes.items():
                pos = np.full(tprog.num_pids, G, dtype=np.int64)
                members = np.asarray(s)[tprog.tangent_sizes[np.asarray(s)] == T]
                pos[members] = np.arange(members.shape[0])
                fam.block_pos[T] = [pos[fam.block_ids[:, j]] for j in range(fam.num_args)]
        radii = {T: jnp.full((G,), r0, jnp.float64) for T, G in sizes.items()}
        for k in range(jmin.num_steps):
            xt = torch.from_numpy(np.asarray(x))
            before = _block_costs(tprog, xt, sizes)
            jx, jr, jcost = jmin._step_fns[si](x, dict(radii))
            with jax.disable_jit():
                er = jmin._step_fns[si](x, dict(radii))[1]
            tx, tr_, tcost = tmin._set_step(
                tmin._set_structs[si], xt, {T: torch.from_numpy(np.asarray(v)) for T, v in radii.items()})
            after_j = _block_costs(tprog, torch.from_numpy(np.asarray(jx)), sizes)
            after_t = _block_costs(tprog, tx, sizes)
            step = dict(set=si, step=k, groups={})
            for T in sizes:
                acc_j = np.asarray(jr[T]) > np.asarray(radii[T])
                acc_t = tr_[T].numpy() > np.asarray(radii[T])
                acc_e = np.asarray(er[T]) > np.asarray(radii[T])
                differ = np.nonzero(acc_j != acc_t)[0]
                margin = [float((np.where(acc_j[b], after_j[T][b], after_t[T][b]) - before[T][b])
                                / before[T][b]) for b in differ]
                step["groups"][T] = dict(
                    blocks=int(acc_j.shape[0]), accepted_jax=int(acc_j.sum()),
                    accepted_jax_op_by_op=int(acc_e.sum()), accepted_port=int(acc_t.sum()),
                    differ=int(differ.shape[0]), jax_runs_differ=int((acc_j != acc_e).sum()),
                    op_by_op_and_port_differ=int((acc_e != acc_t).sum()),
                    differ_margins=sorted(margin, key=abs)[-8:],
                    exact_after_jax=float(after_j[T].sum()), exact_after_port=float(after_t[T].sum()))
            step.update(cost_jax=float(jcost), cost_port=float(tcost),
                        x_max_rel_diff=float(np.max(np.abs(np.asarray(jx, np.float64) - tx.numpy())
                                                    / np.maximum(np.abs(tx.numpy()), 1e-30))))
            out["steps"].append(step)
            print(json.dumps(step), flush=True)
            x, radii = jx, jr
    return out


def examples_references(mod, directory, names=None):
    """The example programs of chip_smoke.EXAMPLES (``names`` of them, or
    all) at the examples phase's argv, their inputs written into
    ``directory`` by chip_smoke.write_example_inputs: {program:
    chip_smoke.example_result}. The JAX package's programs are
    ``examples.<name>.main`` with sys.argv set, the port's
    ``ceres_tpu_torch.examples.<name>.main`` on the CPU."""
    programs = [(n, a) for n, a in chip_smoke.EXAMPLES if names is None or n in names]
    if any("{dir}" in a for _, argv in programs for a in argv):
        chip_smoke.write_example_inputs(directory)
    nist_module = _module(mod, "models.nist")
    out = {}
    for name, argv in programs:
        argv = chip_smoke.example_argv(argv, directory)
        t0 = time.time()
        with chip_smoke.recording_solves(mod, nist_module) as (summaries, suites), \
                contextlib.redirect_stdout(io.StringIO()):
            if mod is ct:
                saved, sys.argv = sys.argv, ["x"] + argv
                try:
                    importlib.import_module(f"examples.{name}").main()
                finally:
                    sys.argv = saved
            else:
                importlib.import_module(f"ceres_tpu_torch.examples.{name}").main(
                    argv + ["--device", "cpu"])
        out[name] = chip_smoke.example_result(summaries, suites)
        print(json.dumps(dict(program=name, seconds=time.time() - t0)), file=sys.stderr,
              flush=True)
    return out


def test_wrong_jacobian_message_matches_jax():
    assert wrong_jacobian_message(ctt) == wrong_jacobian_message(ct)


def test_flagship_inner_solve_matches_jax():
    """The inner_iterations_flagship phase's solve at a small size: JAX's
    records, termination, inner-iteration steps and CG iterations, the
    final cost within 1e-10."""
    j, t = (flagship_inner_references(m, SMALL) for m in (ct, ctt))
    assert t[0] == j[0] > 3 and t[2:5] == j[2:5] and t[3] > 0
    np.testing.assert_allclose(t[1], j[1], rtol=1e-10)


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


@pytest.mark.parametrize("what", ["pose_graph", "pose_graph_dogleg", "pose_graph_dogleg_mixed",
                                  "sequential", "flagship_clusters"])
def test_sparse_references_match_jax(what):
    """The sparse phases' solves at a small size: the same records,
    termination and costs (rtol 1e-10; DOGLEG with mixed precision, whose
    f32 system sums J'J in another order than the JAX package's host
    callback, measured 5.7e-15) and, for the clusters, CG iterations."""
    if what.startswith("pose_graph"):
        j, t = (pose_graph_sparse_references(m, poses=60, seed=1, dogleg="dogleg" in what,
                                             mixed=what.endswith("mixed"))
                for m in (ct, ctt))
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


def test_pose_graph_subset_references_match_jax():
    """The captured loop's CGNR + SUBSET pose graph at 60 poses: JAX's
    records, CG iterations and termination, the final cost within 1e-10."""
    j, t = (pose_graph_subset_references(m, poses=60, seed=1) for m in (ct, ctt))
    assert t[0] == j[0] > 2 and t[1] == j[1] and t[3] == j[3]
    np.testing.assert_allclose(t[2], j[2], rtol=1e-10)


def test_flagship_host_loop_solves_match_jax():
    (bj, nj), (bt, nt) = (flagship_host_loop_references(m, SMALL) for m in (ct, ctt))
    assert bt[0] == bj[0] and bt[2] == bj[2] > 0
    assert nt[0] == nj[0] and nt[2] == nj[2] > 0
    np.testing.assert_allclose([bt[1], nt[1]], [bj[1], nj[1]], rtol=1e-10)


def test_covariance_references_match_jax(monkeypatch):
    """The covariance phase's Schur-marginal computation at a small size
    (the path forced by lowering DENSE_COVARIANCE_MAX_TANGENT in both
    packages): the named blocks within 1e-8 of their largest entry and
    trace(S^-1) within 1e-10."""
    for name in ("ceres_tpu.covariance", "ceres_tpu_torch.covariance"):
        monkeypatch.setattr(importlib.import_module(name), "DENSE_COVARIANCE_MAX_TANGENT", 1)
    j, t = (covariance_references(m, SMALL) for m in (ct, ctt))
    assert j[2] == t[2] == "schur"
    for k in j[0]:
        a, b = np.asarray(t[0][k]), np.asarray(j[0][k])
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b)), k
    np.testing.assert_allclose(t[1], j[1], rtol=1e-10)


def test_numeric_diff_references_match_jax():
    """The numeric-diff phase's solves at a small size with a short
    Ridders tableau: JAX's records and CG iterations, costs within 1e-8
    (a finite difference turns last-bit differences of the residual into
    1e-10 of the Jacobian), the final cost within 1e-10."""
    j, t = (numeric_diff_references(m, SMALL, ridders_extrapolations=3) for m in (ct, ctt))
    for method in ("CENTRAL", "RIDDERS"):
        assert [r[1] for r in t[method][0]] == [r[1] for r in j[method][0]], method
        assert t[method][2] == j[method][2]
        np.testing.assert_allclose([r[0] for r in t[method][0]], [r[0] for r in j[method][0]],
                                   rtol=1e-8)
        np.testing.assert_allclose(t[method][1], j[method][1], rtol=1e-10)


def test_c_api_references_match_jax():
    """The C API phase's curve fit on 10 points: m, c and the final cost
    within 1e-10, the same record count, the report printed."""
    j, t = (c_api_references(m, points=10) for m in (ct, ctt))
    assert t[3:] == j[3:] and t[4]
    np.testing.assert_allclose(t[:3], j[:3], rtol=1e-10)


def test_examples_references_match_jax(tmp_path):
    """The examples entry at the phase's argv, through both packages, for
    programs that need no input: the port's results held to JAX's by the
    phase's own check."""
    names = ("helloworld", "powell", "rosenbrock", "robot_pose_mle")
    j = examples_references(ct, tmp_path, names)
    t = examples_references(ctt, tmp_path, names)
    assert sorted(t) == sorted(j) == sorted(names)
    for name in names:
        chip_smoke.held_to_example(name, t[name], j[name])


def _spread(runs):
    """Largest relative difference of each number of the nudged runs from
    the first run's."""
    base = np.asarray(runs[0], dtype=np.float64)
    return np.max([np.abs(np.asarray(r, dtype=np.float64) - base) / np.maximum(np.abs(base), 1e-300)
                   for r in runs[1:]], axis=0).tolist()


if __name__ == "__main__":
    sparse = ["sparse_pose_graph", "sparse_pose_graph_dogleg", "sparse_pose_graph_dogleg_mixed",
              "sparse_sequential", "sparse_flagship_clusters"]
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
        elif what == "flagship_inner":
            print(json.dumps(dict(reference=what, result=flagship_inner_references(ct))),
                  flush=True)
        elif what == "flagship_line_search":
            runs = [flagship_line_search_references(ct, nudge=n) for n in (0, 1, -1)]
            print(json.dumps(dict(
                reference=what, result=runs[0], nudged=runs[1:],
                spread_of_final_and_checked_costs=_spread([[r[1], *r[4]] for r in runs]),
                seconds=time.time() - t0)), flush=True)
        elif what.startswith("sparse_pose_graph"):
            print(json.dumps(dict(reference=what, result=pose_graph_sparse_references(
                ct, dogleg="dogleg" in what, mixed=what.endswith("mixed")))), flush=True)
        elif what == "pose_graph_subset":
            print(json.dumps(dict(reference=what, result=pose_graph_subset_references(ct))),
                  flush=True)
        elif what == "sparse_sequential":
            print(json.dumps(dict(reference=what, result=sequential_sparse_schur_references(ct))),
                  flush=True)
        elif what == "sparse_flagship_clusters":
            print(json.dumps(dict(reference=what, result=flagship_cluster_references(ct))),
                  flush=True)
        elif what == "check_gradients":
            print(json.dumps(dict(reference=what, message=wrong_jacobian_message(ct))), flush=True)
        elif what == "covariance":
            for dtype in ("float64",):
                blocks, trace, path, seconds = covariance_references(ct, dtype=dtype)
                print(json.dumps(dict(reference=what, dtype=dtype, path=path, trace=trace,
                                      blocks={k: block_fingerprint(v) for k, v in blocks.items()},
                                      seconds=seconds)), flush=True)
        elif what == "covariance_matrix_free":
            blocks, path, iterations, seconds = covariance_matrix_free_references(ct)
            print(json.dumps(dict(reference=what, path=path, cg_iterations=iterations,
                                  blocks=[block_fingerprint(b) for b in blocks],
                                  seconds=seconds)), flush=True)
        elif what == "numeric_diff":
            print(json.dumps(dict(reference=what, result=numeric_diff_references(ct))), flush=True)
        elif what in ("denoising", "libmv", "nist"):
            import tempfile

            with tempfile.TemporaryDirectory() as d:  # the inputs, written as the phase does
                fn = dict(denoising=denoising_references, libmv=libmv_references,
                          nist=nist_references)[what]
                print(json.dumps(dict(reference=what, result=fn(ct, d))), flush=True)
        elif what == "tiny":
            _, checksums, seconds = tiny_references(ct)
            print(json.dumps(dict(reference=what, checksums=checksums, seconds=seconds)),
                  flush=True)
        elif what == "c_api":
            print(json.dumps(dict(reference=what, result=c_api_references(ct))), flush=True)
        elif what == "interpolation":
            print(json.dumps(dict(reference=what, result=interpolation_references(ct))),
                  flush=True)
        elif what == "libmv_gauge_fixed":
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                print(json.dumps(dict(reference=what, result=libmv_spread(d),
                                      test_size=libmv_test_size_spread(
                                          d, frames=12, tracks=40, window=6),
                                      seconds=time.time() - t0)), flush=True)
        elif what == "cg_column":
            print(json.dumps(dict(reference=what, jax=cg_column_counts(ct),
                                  port=cg_column_counts(ctt), seconds=time.time() - t0)),
                  flush=True)
        elif what == "inner_f32":
            print(json.dumps(dict(reference=what, jax=inner_f32_references(ct),
                                  port=inner_f32_references(ctt),
                                  restart=inner_f32_restart(), seconds=time.time() - t0)),
                  flush=True)
        elif what == "inner_pass":
            print(json.dumps(dict(reference=what, result=inner_pass(),
                                  seconds=time.time() - t0)), flush=True)
        elif what == "examples":
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                print(json.dumps(dict(reference=what, result=examples_references(ct, d),
                                      seconds=time.time() - t0)), flush=True)
        elif what == "rosenbrock":
            runs = [rosenbrock_references(ct, nudge=n) for n in (0, 1, -1)]
            print(json.dumps(dict(
                reference=what, result=runs[0], nudged=runs[1:],
                x_spread={d: float(np.max(np.abs(np.subtract(
                    [r[d][2] for r in runs[1:]], runs[0][d][2])))) for d in DIRECTIONS},
                seconds=time.time() - t0)), flush=True)
