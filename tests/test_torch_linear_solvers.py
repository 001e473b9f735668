"""Linear solvers on one Jacobian: DENSE_QR, DENSE_NORMAL_CHOLESKY and CGNR
(identity, scalar Jacobi, block Jacobi, subset) of ceres_tpu_torch against
ceres_tpu, through ``_linear_solve`` as the LM loop calls it.

The Jacobian is a small robust bundle-adjustment one (Huber loss, one
constant camera) with Jacobi column scaling, as inside the loop. float64:
dense steps rtol 1e-10; CGNR steps 1e-8 (the two CG loops run the same
iterations on Jacobians equal to 1e-12, and CG amplifies that), equal CG
iteration counts; preconditioner applications 1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.linear import preconditioners as jpre
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _build_solve_aux as jax_aux
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu.trust_region import _linear_solve as jax_linear_solve
from ceres_tpu.trust_region import _lm_damping as jax_damping
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import preconditioners as tpre
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import (
    _build_solve_aux,
    _config_from_options,
    _linear_solve,
    _lm_damping,
)

SIZES = dict(num_cameras=5, num_points=60, num_observations=240, noise=2.0, perturb=0.5)
SUBSET = list(range(0, 240, 3))


def _close(t, j, rtol):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def system():
    inst = jbal.synthesize_bal(**SIZES, seed=9)
    jp, jcams, _ = jbal.build_problem(inst, loss=ct.loss.HuberLoss(1.0))
    tp, tcams, _ = tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))
    jp.set_parameter_block_constant(int(jcams[0]))
    tp.set_parameter_block_constant(int(tcams[0]))
    jprog, tprog = jp.program(), tp.program("cpu")
    x0 = np.asarray(jprog.initial_ambient())
    _, _, cj = jax_full(jnp.asarray(x0), jprog.families, True, jprog.num_tangent,
                        jprog.jnp_bd_groups())
    _, _, ctx = _full_impl(torch.from_numpy(x0), tprog.families, tprog.num_tangent, tprog.groups)
    nj, nt = cj.squared_column_norms(), ctx.squared_column_norms()
    cj = cj.scale_columns(1.0 / (1.0 + jnp.sqrt(nj)))
    ctx = ctx.scale_columns(1.0 / (1.0 + torch.sqrt(nt)))
    dj = jnp.clip(cj.squared_column_norms(), 1e-6, 1e32)
    dt = torch.clamp(ctx.squared_column_norms(), 1e-6, 1e32)
    Dj = jax_damping(dj, jnp.asarray(1e4))
    Dt = _lm_damping(dt, torch.tensor(1e4, dtype=torch.float64))
    return dict(jprog=jprog, tprog=tprog, cj=cj, ctx=ctx, Dj=Dj, Dt=Dt)


def _options(mod, solver, precond, **kw):
    return mod.SolverOptions(
        linear_solver_type=getattr(mod.LinearSolverType, solver),
        preconditioner_type=getattr(mod.PreconditionerType, precond),
        **kw,
    )


def _solve_both(system, solver, precond, rhs=None, **kw):
    oj, ot = _options(ct, solver, precond, **kw), _options(ctt, solver, precond, **kw)
    yj = jax_linear_solve(
        system["cj"], system["Dj"], jax_aux(oj, system["jprog"]),
        jax_config(oj, system["jprog"]), rhs=None if rhs is None else jnp.asarray(rhs),
    )
    yt = _linear_solve(
        system["ctx"], system["Dt"], _build_solve_aux(ot, system["tprog"]),
        _config_from_options(ot), rhs=None if rhs is None else torch.from_numpy(rhs),
    )
    return yt, yj


@pytest.mark.parametrize("explicit_rhs", [False, True], ids=["jtf", "rhs"])
@pytest.mark.parametrize("solver", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
def test_dense_step_matches_jax(system, solver, explicit_rhs):
    rhs = None
    if explicit_rhs:
        rhs = np.random.default_rng(1).standard_normal(system["tprog"].num_tangent)
    (yt, it, tt), (yj, ij, tj) = _solve_both(system, solver, "JACOBI", rhs)
    _close(yt, yj, 1e-10)
    assert int(it) == int(ij) == 1 and int(tt) == int(tj) == 1
    # and it solves the damped normal equations
    ctx, D = system["ctx"], system["Dt"]
    b = ctx.gradient() if rhs is None else torch.from_numpy(rhs)
    res = ctx.normal_matvec(yt) + D * D * yt - b
    assert float(res.norm() / b.norm()) < 1e-9


def test_dense_qr_and_cholesky_agree(system):
    (yq, _, _), _ = _solve_both(system, "DENSE_QR", "JACOBI")
    (yc, _, _), _ = _solve_both(system, "DENSE_NORMAL_CHOLESKY", "JACOBI")
    _close(yq, yc.numpy(), 1e-9)


CGNR_CASES = {
    "identity": ("IDENTITY", {}),
    "block_jacobi": ("JACOBI", {}),
    "subset": ("SUBSET", dict(residual_blocks_for_subset_preconditioner=SUBSET)),
    "block_jacobi_tight": ("JACOBI", dict(eta=1e-6, max_linear_solver_iterations=200)),
}


@pytest.mark.parametrize("case", CGNR_CASES)
def test_cgnr_step_matches_jax(system, case):
    precond, kw = CGNR_CASES[case]
    (yt, it, tt), (yj, ij, tj) = _solve_both(system, "CGNR", precond, **kw)
    assert int(it) == int(ij) > 1 and int(tt) == int(tj)
    _close(yt, yj, 1e-8)


def test_cgnr_explicit_rhs_and_direct_agreement(system):
    rhs = np.random.default_rng(2).standard_normal(system["tprog"].num_tangent)
    kw = dict(eta=1e-12, max_linear_solver_iterations=500)
    (yt, it, _), (yj, ij, _) = _solve_both(system, "CGNR", "JACOBI", rhs, **kw)
    (yd, _, _), _ = _solve_both(system, "DENSE_NORMAL_CHOLESKY", "JACOBI", rhs)
    _close(yt, yj, 1e-7)
    _close(yt, yd.numpy(), 1e-6)  # CG's floor against the factorization


def test_preconditioner_applications_match_jax(system):
    cj, ctx, Dj, Dt = system["cj"], system["ctx"], system["Dj"], system["Dt"]
    v = np.random.default_rng(3).standard_normal(ctx.num_tangent)
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    assert tpre.identity_preconditioner()(vt) is vt
    _close(tpre.scalar_jacobi_preconditioner(ctx, Dt)(vt),
           jpre.scalar_jacobi_preconditioner(cj, Dj)(vj), 1e-10)
    _close(tpre.scalar_jacobi_preconditioner(ctx)(vt),
           jpre.scalar_jacobi_preconditioner(cj)(vj), 1e-10)
    _close(tpre.block_jacobi_preconditioner(ctx, system["tprog"].groups, Dt)(vt),
           jpre.block_jacobi_preconditioner(cj, system["jprog"].jnp_bd_groups(), Dj)(vj), 1e-10)
    oj = _options(ct, "CGNR", "SUBSET", residual_blocks_for_subset_preconditioner=SUBSET)
    ot = _options(ctt, "CGNR", "SUBSET", residual_blocks_for_subset_preconditioner=SUBSET)
    mj = jax_aux(oj, system["jprog"])["subset_masks"]
    mt = _build_solve_aux(ot, system["tprog"])["subset_masks"]
    assert np.array_equal(mt[0].numpy(), np.asarray(mj[0]))
    _close(tpre.subset_preconditioner(ctx, mt, Dt)(vt),
           jpre.subset_preconditioner(cj, mj, Dj)(vj), 1e-9)


def test_scalar_jacobi_cgnr_matches_jax(system):
    """JACOBI without block groups is scalar Jacobi (solve_cgnr's
    ``bd_groups=None``), as in the JAX package."""
    from ceres_tpu.linear.cgnr import solve_cgnr as jax_cgnr
    from ceres_tpu_torch.linear.cgnr import solve_cgnr

    rt = solve_cgnr(system["ctx"], system["Dt"], ctt.PreconditionerType.JACOBI,
                    max_num_iterations=60, q_tolerance=0.01)
    rj = jax_cgnr(system["cj"], system["Dj"], ct.PreconditionerType.JACOBI,
                  max_num_iterations=60, q_tolerance=0.01)
    assert int(rt.num_iterations) == int(rj.num_iterations)
    _close(rt.x, rj.x, 1e-8)
    with pytest.raises(ValueError, match="CGNR supports"):
        solve_cgnr(system["ctx"], system["Dt"], ctt.PreconditionerType.SCHUR_JACOBI)


def test_failed_factorization_reports_failure(system):
    """A non-finite Jacobian gives a non-finite dense step and FAILURE."""
    ctx = system["ctx"]
    bad = dataclasses.replace(
        ctx, jacs=tuple(tuple(J * float("nan") for J in js) for js in ctx.jacs)
    )
    ot = _options(ctt, "DENSE_NORMAL_CHOLESKY", "JACOBI")
    y, _, term = _linear_solve(bad, system["Dt"], _build_solve_aux(ot, system["tprog"]),
                               _config_from_options(ot))
    assert int(term) == ctt.LinearSolverTerminationType.FAILURE.value
    assert not torch.isfinite(y).any()
