"""Sharded solves of the port (``ceres_tpu_torch/parallel/``) on gloo ranks
on the CPU, held to the port's one-process solve and to the JAX package's
sharded and unsharded solves (``tests/test_parallel.py``'s instance and
bars).

Each world size is spawned once per file (a module-scoped fixture runs every
case of the file in the same ranks and returns their summaries); the
asserts are parametrized over the cases. The ranks import nothing of JAX:
this module imports ``ceres_tpu`` only inside the functions that compute the
JAX references, in the test process.

Tolerances: the port's one-process solve, the same records (count, accept
flags) and final cost within 1e-10 relative, each record's cost within
1e-8 (the sums over ranks are added in another order); the JAX package's
solves, the final cost within 1e-8 (``tests/test_parallel.py:87``); every
rank, the same summary to the bit.
"""

import contextlib

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.parallel import bucket_program, make_mesh, pad_family
from ceres_tpu_torch.parallel.launch import spawn_ranks
from ceres_tpu_torch.parallel.sharding import _row_owners
from ceres_tpu_torch.problem import cast_program

INSTANCE = dict(num_cameras=4, num_points=100, num_observations=397, seed=9)
MAX_ITERATIONS = 10
FINAL_RTOL = 1e-10  # against the port's one-process solve
RECORD_RTOL = 1e-8
JAX_RTOL = 1e-8  # tests/test_parallel.py:87
SPAWN_TIMEOUT = 240.0

# name -> (options, {"huber": bool, "implicit": bool, "mesh": "1d" | "2x2"})
CASES = {
    "iterative_schur_explicit": (dict(linear_solver_type="ITERATIVE_SCHUR",
                                      preconditioner_type="SCHUR_JACOBI"), {}),
    "iterative_schur_implicit": (dict(linear_solver_type="ITERATIVE_SCHUR",
                                      preconditioner_type="SCHUR_JACOBI"), {"implicit": True}),
    "dense_schur": (dict(linear_solver_type="DENSE_SCHUR",
                         preconditioner_type="SCHUR_JACOBI"), {}),
    "cgnr_jacobi": (dict(linear_solver_type="CGNR", preconditioner_type="JACOBI"), {}),
    "iterative_schur_huber": (dict(linear_solver_type="ITERATIVE_SCHUR",
                                   preconditioner_type="SCHUR_JACOBI"), {"huber": True}),
    "line_search": (dict(minimizer_type="LINE_SEARCH"), {}),
    "dogleg": (dict(linear_solver_type="DENSE_SCHUR", trust_region_strategy_type="DOGLEG"), {}),
}
FILE_CASES = ["iterative_schur_explicit", "iterative_schur_implicit", "dense_schur",
              "cgnr_jacobi"]


def _options(module, kw, mesh=None):
    enums = dict(linear_solver_type=module.LinearSolverType,
                 preconditioner_type=module.PreconditionerType,
                 minimizer_type=module.MinimizerType,
                 trust_region_strategy_type=module.TrustRegionStrategyType)
    return module.SolverOptions(max_num_iterations=MAX_ITERATIONS, mesh=mesh,
                                **{k: enums[k][v] for k, v in kw.items()})


@contextlib.contextmanager
def explicit_s_limit(limit, *modules):
    """Every module's EXPLICIT_S_AUTO_MAX_NF set to ``limit`` (0: ITERATIVE_
    SCHUR runs on the implicit S at the test's nf = 36)."""
    saved = [m.EXPLICIT_S_AUTO_MAX_NF for m in modules]
    for m in modules:
        m.EXPLICIT_S_AUTO_MAX_NF = limit
    try:
        yield
    finally:
        for m, v in zip(modules, saved):
            m.EXPLICIT_S_AUTO_MAX_NF = v


def _port_limits():
    import ceres_tpu_torch.linear.schur as schur
    import ceres_tpu_torch.trust_region as tr

    return schur, tr


def summary_record(s, problem):
    """What a solve's summary is held by: final cost, termination, per
    record (cost, successful), the all-reduces' calls and bytes, and the
    cost ``problem.evaluate`` gives after the solve (a whole program, also
    after a sharded solve)."""
    collectives = None if s.collectives is None else {
        k: (v["calls"], v["bytes"]) for k, v in s.collectives.items()}
    return dict(final_cost=s.final_cost, termination=str(s.termination_type),
                message=s.message, num_devices=s.num_devices, collectives=collectives,
                evaluated_cost=problem.evaluate(device="cpu")["cost"],
                records=[(r.cost, r.step_is_successful) for r in s.iterations])


def port_solve(name, mesh=None):
    """The port's solve of case ``name`` on the CPU (with ``mesh``: this
    rank's part of the sharded solve)."""
    kw, flags = CASES[name]
    loss = ctt.HuberLoss(1.0) if flags.get("huber") else None
    problem, _, _ = tbal.build_problem(tbal.synthesize_bal(**INSTANCE), loss=loss)
    limit = 0 if flags.get("implicit") else 2048
    with explicit_s_limit(limit, *_port_limits()):
        return summary_record(ctt.solve(_options(ctt, kw, mesh), problem, device="cpu"), problem)


def rank_main(rank, world, names):
    """One rank: every named case on a mesh over the world (``name@2x2``:
    on a 2 x 2 mesh; ``straddle`` and ``step_f32...``: the cases of
    tests/test_torch_parallel_minimizers.py)."""
    del rank
    torch.set_num_threads(1)
    from ceres_tpu_torch.parallel import make_mesh_2d

    meshes = {}

    def mesh_of(kind):
        if kind not in meshes:
            meshes[kind] = (make_mesh(world, device_type="cpu") if kind == "1d"
                            else make_mesh_2d(2, 2, device_type="cpu"))
        return meshes[kind]

    out = {}
    for name in names:
        base, _, kind = name.partition("@")
        mesh = mesh_of(kind or "1d")
        if base == "straddle":
            import test_torch_parallel_minimizers as m

            out[name] = m.straddle_solve(mesh)
        elif base == "step_f32":
            import test_torch_parallel_minimizers as m

            out[name] = m.one_lm_iteration(mesh)
        else:
            out[name] = port_solve(base, mesh)
    return out


def spawn_cases(world, names):
    return spawn_ranks(rank_main, world, (list(names),), timeout=SPAWN_TIMEOUT)


def jax_solve(name, mesh):
    """The JAX package's final cost for case ``name`` (``mesh``: an int
    number of the conftest's 8 virtual CPU devices, or None)."""
    import ceres_tpu as ct
    import ceres_tpu.linear.schur as jschur
    from ceres_tpu.models import bal as jbal
    from ceres_tpu.parallel import make_mesh as jax_make_mesh

    kw, flags = CASES[name]
    loss = ct.loss.HuberLoss(1.0) if flags.get("huber") else None
    problem, _, _ = jbal.build_problem(jbal.synthesize_bal(**INSTANCE), loss=loss)
    opts = _options(ct, kw, None if mesh is None else jax_make_mesh(mesh))
    with explicit_s_limit(0 if flags.get("implicit") else 2048, jschur):
        return ct.solve(opts, problem).final_cost


def held_to_one_process(got, ref):
    assert len(got["records"]) == len(ref["records"])
    assert [s for _, s in got["records"]] == [s for _, s in ref["records"]]
    assert got["termination"] == ref["termination"]
    np.testing.assert_allclose(got["final_cost"], ref["final_cost"], rtol=FINAL_RTOL)
    np.testing.assert_allclose(got["evaluated_cost"], ref["evaluated_cost"], rtol=FINAL_RTOL)
    np.testing.assert_allclose([c for c, _ in got["records"]],
                               [c for c, _ in ref["records"]], rtol=RECORD_RTOL)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request):
    """(world size, the ranks' results) for every case of this file."""
    return request.param, spawn_cases(request.param, FILE_CASES)


@pytest.fixture(scope="module")
def one_process():
    return {name: port_solve(name) for name in FILE_CASES}


@pytest.fixture(scope="module")
def jax_reference():
    return {name: (jax_solve(name, None), jax_solve(name, 8)) for name in FILE_CASES}


@pytest.mark.parametrize("name", FILE_CASES)
def test_sharded_solve_matches_one_process(sharded, one_process, name):
    world, ranks = sharded
    got = ranks[0][name]
    assert got["num_devices"] == world and got["collectives"]["all_reduce"][0] > 0
    assert one_process[name]["collectives"] is None
    held_to_one_process(got, one_process[name])


@pytest.mark.parametrize("name", FILE_CASES)
def test_sharded_solve_matches_the_jax_package(sharded, jax_reference, name):
    _, ranks = sharded
    unsharded, on_mesh = jax_reference[name]
    np.testing.assert_allclose(ranks[0][name]["final_cost"], unsharded, rtol=JAX_RTOL)
    np.testing.assert_allclose(ranks[0][name]["final_cost"], on_mesh, rtol=JAX_RTOL)


def test_every_rank_returns_the_same_summary(sharded):
    _, ranks = sharded
    assert all(r == ranks[0] for r in ranks[1:])


# -- without a process group ---------------------------------------------------


@pytest.fixture(scope="module")
def program():
    problem, _, _ = tbal.build_problem(tbal.synthesize_bal(**INSTANCE))
    return problem, problem.program("cpu")


def test_pad_family_masks_rows(program):
    _, prog = program
    fam = prog.families[0]
    padded = pad_family(fam, 8)
    assert padded.batch % 8 == 0 and padded.batch > fam.batch
    m = padded.mask.numpy()
    assert m.dtype == np.float64 and m[: fam.batch].sum() == fam.batch and m[fam.batch:].sum() == 0
    assert np.all(padded.residual_ids[fam.batch:] == -1)
    assert np.all(padded.block_ids[fam.batch:] == fam.block_ids[0])
    assert padded.source_rows is None  # an unsharded family stays one
    # the mask takes the evaluation dtype: f32 is not promoted
    assert pad_family(fam, 8, dtype=torch.float32).mask.dtype == torch.float32


def test_padded_evaluation_is_the_unpadded_one():
    """Cost 1e-14, gradient 1e-12 (tests/test_parallel.py:29-57's bars); the
    f32 residuals stay f32."""
    from ceres_tpu_torch.evaluator import Evaluator

    problem, _, _ = tbal.build_problem(tbal.synthesize_bal(**INSTANCE))
    prog = problem.program("cpu")
    x = torch.from_numpy(prog.initial_ambient())
    full = Evaluator(prog).cost_gradient_jacobian(x)
    prog.families = [pad_family(f, 8) for f in prog.families]
    padded = Evaluator(prog).cost_gradient_jacobian(x)
    np.testing.assert_allclose(float(padded.cost), float(full.cost), rtol=1e-14)
    np.testing.assert_allclose(padded.gradient.numpy(), full.gradient.numpy(), rtol=1e-12)
    cast_program(prog, "float32")
    r = Evaluator(prog).residuals(x.float())
    assert r.dtype == torch.float32 and r.shape[0] == 2 * prog.families[0].batch


def test_bucket_program_leaves_the_solve_unchanged():
    """A bucket smaller than the batch pads it (mask 0 rows): the solve's
    records are the unpadded ones (1e-10)."""
    problem, _, _ = tbal.build_problem(tbal.synthesize_bal(**INSTANCE))
    ref = summary_record(ctt.solve(_options(ctt, CASES["dense_schur"][0]), problem, device="cpu"),
                         problem)
    problem, _, _ = tbal.build_problem(tbal.synthesize_bal(**INSTANCE))
    prog = bucket_program(problem.program("cpu"), bucket_size=64)
    assert prog.families[0].batch == 448 and prog.families[0].mask is not None
    opts = _options(ctt, CASES["dense_schur"][0])
    got = summary_record(ctt.solve(opts, problem, device="cpu"), problem)
    held_to_one_process(got, ref)


def test_each_point_has_one_owner_and_the_cut_follows_the_points(program):
    """The owner rule on a point-sorted family: every row of a point on one
    rank, each rank's rows one contiguous range, the ranks' row counts
    within twice the largest point of each other (a rank's load is the
    even share give or take one point)."""
    from ceres_tpu_torch.linear.schur import compute_schur_ordering

    _, prog = program
    e_blocks = np.asarray(compute_schur_ordering(prog))
    fam = prog.families[0]
    pts = fam.block_ids[:, 1]
    for n in (2, 3, 4):
        (owner,), e_owner = _row_owners(prog, e_blocks, n)
        assert np.all(owner == e_owner[pts])
        assert np.all(np.diff(owner) >= 0) and set(owner.tolist()) == set(range(n))
        counts = np.bincount(owner, minlength=n)
        assert counts.max() - counts.min() <= 2 * np.bincount(pts).max()
        assert np.all(e_owner[e_blocks] >= 0) and np.all(e_owner[fam.block_ids[:, 0]] == -1)


def test_a_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2, device_type="cpu")


def test_evaluate_after_a_sharded_solve_is_the_whole_problem(program):
    """A program that a (here: simulated) sharded solve left behind is
    rebuilt by Problem.program, so Problem.evaluate (and the covariance and
    the gradient checker, which take the program the same way) see every
    row."""
    problem, prog = program
    ref = problem.evaluate(residuals=True, device="cpu")
    prog.mesh = "sharded"
    try:
        got = problem.evaluate(residuals=True, device="cpu")
    finally:
        prog.mesh = None
    assert got["residuals"].shape == ref["residuals"].shape
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-15)
