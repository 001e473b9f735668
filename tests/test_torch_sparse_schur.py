"""SPARSE_SCHUR in the port against ceres_tpu (tests/test_sparse_schur.py's
cases at 6 cameras / 40 points / 160 observations): the host CSC of upper(S)
built from the device's cells equal to the dense S and to the JAX package's,
the host loop's step equal to JAX's and to DENSE_SCHUR's, the dense route
``solve_schur`` takes for the other callers, and solves record by record
against JAX f64 (rtol 1e-10) and f32: plain, mixed precision, a reject
streak, DOGLEG, and a small instance of chip_smoke.py's sequential bundle
adjustment.
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
from ceres_tpu.linear.schur import SchurOperator as JaxOperator
from ceres_tpu.linear.schur_explicit import compute_cell_blocks as jax_cells
from ceres_tpu.linear.sparse_schur import build_sparse_schur_assembly as jax_assembly
from ceres_tpu.linear.sparse_schur import make_sparse_schur_step_fn
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _build_solve_aux as jax_aux
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linear import sparse_schur as tss
from ceres_tpu_torch.linear.cg import CG_SUCCESS
from ceres_tpu_torch.linear.schur import SchurOperator, solve_schur
from ceres_tpu_torch.linear.schur_explicit import assemble_reduced_system, compute_cell_blocks
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import _build_solve_aux, _config_from_options, _make_lm_step_fn

_EXACT = ("iteration", "step_is_valid", "step_is_successful", "linear_solver_iterations")


def _small_bal(mod, cams=6, pts=40, obs=160, seed=3, noise=1.0, perturb=0.3, constant=0):
    bm = jbal if mod is ct else tbal
    p, cam_ids, _ = bm.build_problem(bm.synthesize_bal(
        num_cameras=cams, num_points=pts, num_observations=obs, noise=noise, perturb=perturb,
        seed=seed))
    if constant:
        p.set_parameter_block_constant(cam_ids[:constant])
    return p


def _setup(seed, lst="SPARSE_SCHUR"):
    """Both packages' program, solve structures, config and context at the
    start of the same instance."""
    jprog = _small_bal(ct, seed=seed).program()
    tprog = _small_bal(ctt, seed=seed).program("cpu")
    jopts = jbal.default_options(iterative=False)
    topts = tbal.default_options(iterative=False)
    jopts.linear_solver_type = ct.LinearSolverType[lst]
    topts.linear_solver_type = ctt.LinearSolverType[lst]
    x = np.asarray(jprog.initial_ambient())
    ctx_j = JaxEvaluator(jprog).cost_gradient_jacobian(jnp.asarray(x)).jacobian_context
    ctx_t = Evaluator(tprog).cost_gradient_jacobian(torch.tensor(x)).jacobian_context
    return dict(jprog=jprog, tprog=tprog, jopts=jopts, topts=topts, ctx_j=ctx_j, ctx_t=ctx_t,
                aux_j=jax_aux(jopts, jprog), aux_t=_build_solve_aux(topts, tprog))


def _dense(assembly, data):
    Hu = sp.csc_matrix((data, assembly.indices, assembly.indptr),
                       shape=(assembly.n, assembly.n)).toarray()
    return Hu + np.triu(Hu, k=1).T


def test_sparse_assembly_matches_dense_s_and_jax():
    b = _setup(3)
    ss_t, ss_j = b["aux_t"]["ss"], b["aux_j"]["ss"]
    nt = b["tprog"].num_tangent
    D = np.full(nt, 0.37)
    op_t = SchurOperator(b["ctx_t"], torch.tensor(D), ss_t)
    op_j = JaxOperator(b["ctx_j"], jnp.asarray(D), ss_j)
    asm = tss.build_sparse_schur_assembly(ss_t.explicit)
    data = asm.scatter([blocks for _, blocks in compute_cell_blocks(op_t, ss_t.explicit)])
    df = D[ss_t.f_idx.numpy()]
    data[asm.diag_pos] += df * df
    S = _dense(asm, data)
    np.testing.assert_allclose(S, assemble_reduced_system(op_t, ss_t.explicit).numpy(),
                               rtol=1e-10, atol=1e-8)
    ja = jax_assembly(ss_j.explicit, ss_j)
    _, jblocks = jax_cells(op_j, ss_j.explicit)
    vals = np.concatenate([np.asarray(v, dtype=np.float64).ravel() for v in jblocks])
    jdata = np.bincount(ja.pos, weights=vals, minlength=ja.nnz + 1)[: ja.nnz]
    jdata[ja.diag_pos] += df * df
    assert asm.nnz == ja.nnz and np.array_equal(asm.indptr, ja.indptr)
    assert np.array_equal(asm.indices, ja.indices)
    np.testing.assert_allclose(data, jdata, rtol=1e-10, atol=1e-10 * np.abs(jdata).max())


@pytest.mark.parametrize("seed", [11, 5])
def test_step_matches_jax_and_dense_schur(seed):
    b = _setup(seed)
    jcfg = jax_config(b["jopts"], b["jprog"])
    jstep = make_sparse_schur_step_fn(jcfg, b["aux_j"])
    tstep = _make_lm_step_fn(b["topts"], b["tprog"])
    for radius in (1e3, 250.0):
        yj, mj, _, termj = jstep(b["ctx_j"], jnp.asarray(radius, jnp.float64))
        yt, mt, it, termt = tstep(b["ctx_t"], radius)
        assert int(termt) == int(termj) == CG_SUCCESS and int(it) == 1
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(float(mt), float(mj), rtol=1e-9)
    # the dense route of solve_schur (DOGLEG, refinement, the fused loop)
    # gives the same step as the host factorization
    cfg = dataclasses.replace(_config_from_options(b["topts"]))
    D = torch.full((b["tprog"].num_tangent,), 0.5, dtype=torch.float64)
    y_dense, _, term = solve_schur(b["ctx_t"], D, cfg, b["aux_t"]["ss"])
    dense_cfg = dataclasses.replace(cfg, linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    y_ref, _, _ = solve_schur(b["ctx_t"], D, dense_cfg, b["aux_t"]["ss"])
    assert int(term) == CG_SUCCESS and torch.equal(y_dense, y_ref)


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
        bm = jbal if mod is ct else tbal
        opts = bm.default_options(iterative=False)
        opts.linear_solver_type = mod.LinearSolverType.SPARSE_SCHUR
        for k, v in changes.items():
            setattr(opts, k, mod.TrustRegionStrategyType[v]
                    if k == "trust_region_strategy_type" else v)
        p = make(mod)
        out.append(mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p))
    return out


@pytest.mark.parametrize("changes", [
    dict(),
    dict(use_mixed_precision_solves=True, max_num_refinement_iterations=3),
    dict(initial_trust_region_radius=1e6, min_relative_decrease=0.9),
    dict(trust_region_strategy_type="DOGLEG"),
], ids=["plain", "mixed", "reject_streak", "dogleg"])
def test_solve_matches_jax_record_by_record(changes):
    if "min_relative_decrease" in changes:  # tests/test_sparse_pipeline.py's instance
        make = lambda m: _small_bal(m, cams=5, pts=80, obs=320, noise=6.0, perturb=2.5)  # noqa
    else:  # DOGLEG: two cameras fixed (the gauge), as in test_torch_sparse_cholesky.py
        constant = 2 if "trust_region_strategy_type" in changes else 0
        make = lambda m: _small_bal(m, seed=5, obs=240, constant=constant)  # noqa
    sj, st = _solve_both(make, max_num_iterations=20, **changes)
    assert st.linear_solver_type_used == ctt.LinearSolverType.SPARSE_SCHUR
    assert st.is_solution_usable() and len(st.iterations) > 3
    if "min_relative_decrease" in changes:
        assert sum(not r.step_is_successful for r in st.iterations) >= 2
    _records_match(st, sj)


def test_float32_solve_near_jax():
    sj, st = _solve_both(lambda m: _small_bal(m, seed=5, obs=240), max_num_iterations=20,
                         evaluation_dtype="float32")
    sj64, st64 = _solve_both(lambda m: _small_bal(m, seed=5, obs=240), max_num_iterations=20)
    assert st.is_solution_usable()
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-5)
    np.testing.assert_allclose(st.final_cost, st64.final_cost, rtol=1e-5)


def test_sequential_instance_matches_jax():
    """chip_smoke.py's banded sequential bundle adjustment at a small size,
    through both packages' SPARSE_SCHUR host loop."""
    import chip_smoke

    inst = chip_smoke.sequential_instance(num_cameras=20, num_points=150, fifth=50, seed=11)
    assert inst.num_observations == 4 * 150 + 50
    sj, st = _solve_both(
        lambda m: (jbal if m is ct else tbal).build_problem(
            (jbal if m is ct else tbal).BALProblem(*dataclasses.astuple(inst)))[0],
        max_num_iterations=6)
    _records_match(st, sj)
