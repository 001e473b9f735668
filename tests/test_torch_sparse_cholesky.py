"""SPARSE_NORMAL_CHOLESKY in the port against ceres_tpu: the host factor
(``linear/sparse_cholesky.py``: every ordering, postordering, the f32 factor
with f64 refinement, a not positive definite matrix) against the JAX
package's and dense numpy (the cases of tests/test_sparse_cholesky.py and
tests/test_mixed_sparse.py); the J'J cells reduced on the device and their
CSC (``linear/inner_product.py``) against JAX's; the host loop's step; and
solves record by record against JAX f64 (rtol 1e-10) and f32: a BAL, a
pose graph, DOGLEG, dynamic sparsity, mixed precision and a reject streak
(tests/test_sparse_pipeline.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import Evaluator as JaxEvaluator
from ceres_tpu.linear import inner_product as jip
from ceres_tpu.linear import sparse_cholesky as jsc
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu.trust_region import _make_sparse_lm_step_fn as jax_sparse_step
from ceres_tpu_torch.evaluator import Evaluator, to_crs
from ceres_tpu_torch.linear import inner_product as tip
from ceres_tpu_torch.linear import sparse_cholesky as tsc
from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_SUCCESS
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg
from ceres_tpu_torch.trust_region import _config_from_options, _make_lm_step_fn

SNC = "SPARSE_NORMAL_CHOLESKY"
_EXACT = ("iteration", "step_is_valid", "step_is_successful", "linear_solver_iterations")


def random_spd_csc(n, density, seed):
    """Random sparse SPD matrix: (upper CSC, dense)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc").toarray()
    H = A @ A.T + n * np.eye(n)
    Hu = sp.triu(sp.csc_matrix(H), format="csc")
    Hu.sort_indices()
    return Hu, H


@pytest.mark.parametrize("n,density,seed", [(5, 0.6, 0), (40, 0.1, 1), (120, 0.03, 2)])
def test_factor_solve_matches_jax_and_dense(n, density, seed):
    Hu, H = random_spd_csc(n, density, seed)
    b = np.arange(1.0, n + 1.0)
    t = tsc.SparseCholesky(n, Hu.indptr, Hu.indices)
    j = jsc.SparseCholesky(n, Hu.indptr, Hu.indices)
    assert t.factorize(Hu.data) == j.factorize(Hu.data) == 0
    assert np.array_equal(t.perm, j.perm) and t.nnz_L == j.nnz_L
    x = t.solve(b)
    assert np.array_equal(x, j.solve(b))
    np.testing.assert_allclose(x, np.linalg.solve(H, b), rtol=1e-10)
    for scale in (2.5, 0.3):  # analyze once, refactor many
        assert t.factorize(Hu.data * scale) == 0
        np.testing.assert_allclose(t.solve(b), np.linalg.solve(H * scale, b), rtol=1e-10)
    B = np.random.default_rng(0).normal(size=(3, n))  # several right-hand sides
    np.testing.assert_allclose(t.solve(B), np.linalg.solve(H * 0.3, B.T).T, rtol=1e-9)


@pytest.mark.parametrize("ordering", ["AMD", "NESDIS", "NATURAL"])
@pytest.mark.parametrize("post", [False, True])
def test_orderings_and_postordering_match_jax(ordering, post):
    n = 80
    Hu, H = random_spd_csc(n, 0.06, 7)
    t = tsc.SparseCholesky(n, Hu.indptr, Hu.indices, ordering=ordering, use_postordering=post)
    j = jsc.SparseCholesky(n, Hu.indptr, Hu.indices, ordering=ordering, use_postordering=post)
    assert sorted(t.perm.tolist()) == list(range(n))
    assert np.array_equal(t.perm, j.perm) and np.array_equal(t.parent, j.parent)
    assert t.factorize(Hu.data) == 0 and j.factorize(Hu.data) == 0
    b = np.arange(1.0, n + 1.0)
    assert np.array_equal(t.solve(b), j.solve(b))
    np.testing.assert_allclose(t.solve(b), np.linalg.solve(H, b), rtol=1e-9)


def test_nested_dissection_and_postorder_equal_jax():
    n = 500
    band = sp.diags([np.ones(n), np.ones(n - 1), np.ones(n - 1)], [0, 1, -1])
    Hu = sp.triu(band.tocsc(), format="csc")
    perm = tsc.nested_dissection_order(n, Hu.indptr, Hu.indices)
    assert sorted(perm.tolist()) == list(range(n))
    assert np.array_equal(perm, jsc.nested_dissection_order(n, Hu.indptr, Hu.indices))
    parent = np.random.default_rng(3).integers(-1, 40, size=40)
    parent = np.where(parent > np.arange(40), parent, -1)  # a forest
    assert np.array_equal(tsc._etree_postorder(parent), jsc._etree_postorder(parent))


@pytest.mark.parametrize("precision", ["double", "single"])
def test_not_positive_definite_reports_the_column(precision):
    n = 10
    Hu, _ = random_spd_csc(n, 0.4, 3)
    bad = Hu.data.copy()
    last = [p for p in range(Hu.indptr[n - 1], Hu.indptr[n]) if Hu.indices[p] == n - 1]
    bad[last[0]] = -1e6
    t = tsc.SparseCholesky(n, Hu.indptr, Hu.indices, precision=precision)
    j = jsc.SparseCholesky(n, Hu.indptr, Hu.indices, precision=precision)
    rc = t.factorize(bad)
    assert rc > 0 and rc == j.factorize(bad)
    with pytest.raises(RuntimeError):
        t.solve(np.ones(n))
    x, term = tsc.factor_solve_csc({}, n, Hu.indptr, Hu.indices, bad, np.ones(n),
                                   mixed_precision=precision == "single")
    assert term == CG_FAILURE and not x.any()


@pytest.mark.parametrize("n,density,seed", [(30, 0.2, 0), (120, 0.05, 1)])
def test_f32_factor_with_f64_refinement(n, density, seed):
    Hu, H = random_spd_csc(n, density, seed)
    b = np.arange(1.0, n + 1.0)
    x64 = np.linalg.solve(H, b)
    f32 = tsc.SparseCholesky(n, Hu.indptr, Hu.indices, precision="single")
    assert f32.Lx.dtype == np.float32 and f32.factorize(Hu.data) == 0
    raw = np.linalg.norm(f32.solve(b) - x64) / np.linalg.norm(x64)
    assert raw < 1e-4
    ref = f32.refined_solve(Hu, b, num_refinement_iterations=3)
    assert np.linalg.norm(ref - x64) / np.linalg.norm(x64) < 1e-11
    j32 = jsc.SparseCholesky(n, Hu.indptr, Hu.indices, precision="single")
    j32.factorize(Hu.data)
    assert np.array_equal(ref, j32.refined_solve(Hu, b, num_refinement_iterations=3))
    cache = {}
    x, term = tsc.factor_solve_csc(cache, n, Hu.indptr, Hu.indices, Hu.data, b,
                                   mixed_precision=True, num_refinement_iterations=3)
    assert term == CG_SUCCESS and [k[2] for k in cache] == [True]
    np.testing.assert_allclose(x, x64, rtol=1e-9)


def _chain_problem(mod, seed=0, n_blocks=6):
    """Overlapping 2-vectors in a chain: a banded J'J."""
    rng = np.random.default_rng(seed)
    p = mod.Problem()
    blocks = [p.add_parameter_block(rng.normal(size=2)) for _ in range(n_blocks)]
    data = rng.normal(size=(n_blocks - 1, 2))
    if mod is ct:
        def chain(a, b, d):
            return jnp.asarray([a[0] * b[1] - d[0], a[1] + b[0] ** 2 - d[1]])
        data = jnp.asarray(data)
    else:
        def chain(a, b, d):
            return torch.cat([a[0:1] * b[1:2] - d[0:1], a[1:2] + b[0:1] ** 2 - d[1:2]])
        data = torch.from_numpy(data)
    p.add_residual_blocks(chain, None, [np.asarray(blocks[:-1]), np.asarray(blocks[1:])],
                          data=data)
    return p


def _contexts(jproblem, tproblem):
    jprog, tprog = jproblem.program(), tproblem.program("cpu")
    x = np.asarray(jprog.initial_ambient())
    ctx_j = JaxEvaluator(jprog).cost_gradient_jacobian(jnp.asarray(x)).jacobian_context
    ctx_t = Evaluator(tprog).cost_gradient_jacobian(torch.tensor(x)).jacobian_context
    return jprog, tprog, ctx_j, ctx_t


@pytest.mark.parametrize("dynamic", [False, True])
def test_host_normal_solve_matches_jax_and_dense(dynamic):
    jprog, tprog, ctx_j, ctx_t = _contexts(_chain_problem(ct), _chain_problem(ctt))
    nt = tprog.num_tangent
    D = np.linspace(0.5, 1.5, nt)
    rhs = ctx_t.gradient().numpy()
    y, term = tsc.host_sparse_normal_solve(to_crs(ctx_t), dynamic, D, rhs)
    pairs = [[(np.asarray(f.tangent_idx[j]), np.asarray(ctx_j.jacs[fi][j]))
              for j in range(f.num_args)] for fi, f in enumerate(ctx_j.families)]
    yj, _, term_j = jsc.host_sparse_normal_solve(nt, dynamic, D, rhs, pairs)
    assert term == int(term_j) == CG_SUCCESS
    np.testing.assert_allclose(y, yj, rtol=1e-12)
    Jd = ctx_t.to_dense().numpy()
    np.testing.assert_allclose(y, np.linalg.solve(Jd.T @ Jd + np.diag(D ** 2), rhs), rtol=1e-8)
    # the solve every other caller takes: the Jacobian sent to the host
    y_ctx, it, t = tsc.solve_sparse_normal_cholesky(ctx_t, torch.from_numpy(D), dynamic=dynamic)
    assert int(it) == 1 and int(t) == CG_SUCCESS and y_ctx.dtype == torch.float64
    np.testing.assert_allclose(y_ctx.numpy(), yj, rtol=1e-12)


def _bal(mod, seed=11, cams=6, pts=120, obs=480, noise=1.0, perturb=0.3, constant=0):
    """A small BAL; ``constant`` cameras held fixed (which fixes the gauge,
    so that a nearly undamped step is well posed)."""
    bm = jbal if mod is ct else tbal
    p, cam_ids, _ = bm.build_problem(bm.synthesize_bal(
        num_cameras=cams, num_points=pts, num_observations=obs, noise=noise, perturb=perturb,
        seed=seed))
    if constant:
        p.set_parameter_block_constant(cam_ids[:constant])
    return p


@pytest.mark.parametrize("case", ["chain", "bal"])
def test_normal_cells_and_csc_match_jax(case):
    mk = _chain_problem if case == "chain" else _bal
    jprog, tprog, ctx_j, ctx_t = _contexts(mk(ct), mk(ctt))
    tplan, jplan = tip.build_normal_plan(tprog), jip.build_normal_plan(jprog)
    assert [(s.fi, s.j1, s.j2, s.diagonal, s.transpose) for s in tplan.sites] == [
        (s.fi, s.j1, s.j2, s.diagonal, s.transpose) for s in jplan.sites]
    for a, b in zip(tplan.sites, jplan.sites):
        assert np.array_equal(a.rows, np.asarray(b.rows))
        assert np.array_equal(a.cols, np.asarray(b.cols))
    ta, ja = tip.build_normal_assembly(tplan), jip.build_normal_assembly(jplan)
    for f in ("indptr", "indices", "pos", "diag_pos"):
        assert np.array_equal(getattr(ta, f), getattr(ja, f)), f
    tcells = tip.compute_normal_cells(ctx_t, tplan)
    jcells = jip.compute_normal_cells(ctx_j, jplan)
    for a, b in zip(tcells, jcells):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12 * np.abs(b).max())
    Hu = sp.csc_matrix((ta.scatter(tcells), ta.indices, ta.indptr), shape=(ta.n, ta.n))
    H = (Hu + sp.triu(Hu, k=1).T).toarray()
    Jd = ctx_t.to_dense().numpy()
    np.testing.assert_allclose(H, Jd.T @ Jd, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dynamic", [False, True])
def test_lm_step_matches_jax(dynamic):
    jprog, tprog, ctx_j, ctx_t = _contexts(_bal(ct, seed=9), _bal(ctt, seed=9))
    jopts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType[SNC], dynamic_sparsity=dynamic)
    topts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType[SNC],
                              dynamic_sparsity=dynamic)
    jstep = jax_sparse_step(jax_config(jopts, jprog), jprog)
    tstep = _make_lm_step_fn(topts, tprog)
    try:
        for radius in (3e3, 1.5e3):  # the second is the cached transfer's
            yj, mj, _, termj = jstep(ctx_j, jnp.asarray(radius, jnp.float64))
            yt, mt, it, termt = tstep(ctx_t, radius)
            assert int(termt) == int(termj) == CG_SUCCESS and int(it) == 1
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(mt), float(mj), rtol=1e-10)
    finally:
        getattr(tstep, "close", lambda: None)()


def _records_match(st, sj, rtol=1e-10):
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    floor = 1e-16 * sj.iterations[0].cost
    for a, b in zip(st.iterations, sj.iterations):
        for f in _EXACT:
            assert getattr(a, f) == getattr(b, f), (f, b.iteration)
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol, atol=floor)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=rtol)


def _solve_both(make, **changes):
    out = []
    for mod in (ct, ctt):
        opts = mod.SolverOptions(linear_solver_type=mod.LinearSolverType[SNC])
        for k, v in changes.items():
            enum = {"trust_region_strategy_type": mod.TrustRegionStrategyType,
                    "linear_solver_ordering_type": mod.LinearSolverOrderingType}.get(k)
            setattr(opts, k, enum[v] if enum else v)
        p = make(mod)
        out.append(mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p))
    return out


@pytest.mark.parametrize("changes", [
    dict(),
    dict(dynamic_sparsity=True),
    dict(trust_region_strategy_type="DOGLEG"),
    dict(use_mixed_precision_solves=True, max_num_refinement_iterations=3),
    dict(linear_solver_ordering_type="NESDIS", use_postordering=True),
], ids=["static", "dynamic", "dogleg", "mixed", "nesdis"])
def test_bal_solve_matches_jax_record_by_record(changes):
    # DOGLEG's first steps are nearly Gauss-Newton: with the gauge free
    # their rounding decides the records, so two cameras are held fixed
    constant = 2 if "trust_region_strategy_type" in changes else 0
    sj, st = _solve_both(lambda m: _bal(m, constant=constant), max_num_iterations=12, **changes)
    assert st.linear_solver_type_used == ctt.LinearSolverType[SNC]
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    _records_match(st, sj)


def test_pose_graph_solve_matches_jax_record_by_record():
    def make(mod):
        pg = jpg if mod is ct else tpg
        return pg.build_problem_3d(*pg.synthesize_sphere(60, seed=1)[:3])[0]

    sj, st = _solve_both(make, max_num_iterations=50)
    assert len(st.iterations) > 3
    _records_match(st, sj)


def test_reject_streak_matches_jax():
    """A large first radius and a strict step-quality bar force rejected
    steps in a row (tests/test_sparse_pipeline.py, whose 1e14 leaves the
    gauge-free steps to rounding): the cached transfer and the pre-factored
    next radius give JAX's records."""
    sj, st = _solve_both(lambda m: _bal(m, seed=3, cams=5, pts=80, obs=320, noise=6.0,
                                        perturb=2.5),
                         initial_trust_region_radius=1e6, min_relative_decrease=0.9,
                         max_num_iterations=30)
    assert sum(not r.step_is_successful for r in st.iterations) >= 4
    _records_match(st, sj)


def test_float32_solve_near_jax():
    sj, st = _solve_both(lambda m: _bal(m), max_num_iterations=12, evaluation_dtype="float32")
    assert st.is_solution_usable()
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-5)
    sj64, st64 = _solve_both(lambda m: _bal(m), max_num_iterations=12)
    np.testing.assert_allclose(st.final_cost, st64.final_cost, rtol=1e-5)


def test_options_and_config():
    opts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.CGNR, dynamic_sparsity=True)
    assert opts.validate() == ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.CGNR, dynamic_sparsity=True).validate(0)
    opts = dataclasses.replace(opts, linear_solver_type=ctt.LinearSolverType[SNC],
                               linear_solver_ordering_type=ctt.LinearSolverOrderingType.NESDIS,
                               use_postordering=True, logging_type=ctt.LoggingType.SILENT)
    assert opts.validate() is None
    c = _config_from_options(opts)
    assert (c.dynamic_sparsity, c.ordering_type, c.use_postordering) == (True, "NESDIS", True)
