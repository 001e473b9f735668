"""Mixed-precision linear solves (``use_mixed_precision_solves``):
``ceres_tpu_torch.trust_region._linear_solve`` against ceres_tpu's, with
every solve in float32 and the refinement residual and the step in float64.

The Jacobian is a small robust bundle-adjustment one (Huber loss, one
constant camera, Jacobi column scaling and LM damping as inside the loop),
evaluated in float64 and in float32: the wrapper must cast an f32 context
to f64 for the refinement and an f64 one to f32 for the solves, and leave
the caller's arrays as they were. Five linear solvers (DENSE_QR,
DENSE_NORMAL_CHOLESKY, CGNR, DENSE_SCHUR, ITERATIVE_SCHUR on an assembled
and on the implicit S) with 1 and 3 refinement steps: the step within 1e-4
relative of the JAX package's, equal summed iteration counts and
termination codes, and the refined step closer to the float64 solution than
one float32 solve. Last, a float32 fused solve with refinement against the
JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.linear import schur as jschur
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _build_solve_aux as jax_aux
from ceres_tpu.trust_region import _cast_tree
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu.trust_region import _linear_solve as jax_linear_solve
from ceres_tpu.trust_region import _lm_damping as jax_damping
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import (
    _build_solve_aux,
    _config_from_options,
    _linear_solve,
    _lm_damping,
)

SIZES = dict(num_cameras=5, num_points=60, num_observations=240, noise=2.0, perturb=0.5)
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def system():
    inst = jbal.synthesize_bal(**SIZES, seed=9)
    jp, jcams, _ = jbal.build_problem(inst, loss=ct.loss.HuberLoss(1.0))
    tp, tcams, _ = tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))
    jp.set_parameter_block_constant(int(jcams[0]))
    tp.set_parameter_block_constant(int(tcams[0]))
    jprog, tprog = jp.program(), tp.program("cpu")
    x0 = np.asarray(jprog.initial_ambient())

    def jax_system(x):
        _, _, cj = jax_full(x, jprog.families, True, jprog.num_tangent, jprog.jnp_bd_groups())
        cj = cj.scale_columns(1.0 / (1.0 + jnp.sqrt(cj.squared_column_norms())))
        return cj, jax_damping(jnp.clip(cj.squared_column_norms(), 1e-6, 1e32),
                               jnp.asarray(1e2))

    cj, Dj = jax.jit(jax_system)(jnp.asarray(x0))
    _, _, ctx = _full_impl(torch.from_numpy(x0.copy()), tprog.families, tprog.num_tangent,
                           tprog.groups)
    ctx = ctx.scale_columns(1.0 / (1.0 + torch.sqrt(ctx.squared_column_norms())))
    Dt = _lm_damping(torch.clamp(ctx.squared_column_norms(), 1e-6, 1e32),
                     torch.tensor(1e2, dtype=torch.float64))
    return dict(jprog=jprog, tprog=tprog, cj=cj, ctx=ctx, Dj=Dj, Dt=Dt)


SOLVERS = {
    "DENSE_QR": ("DENSE_QR", "JACOBI"),
    "DENSE_NORMAL_CHOLESKY": ("DENSE_NORMAL_CHOLESKY", "JACOBI"),
    "CGNR": ("CGNR", "JACOBI"),
    "DENSE_SCHUR": ("DENSE_SCHUR", "SCHUR_JACOBI"),
    "ITERATIVE_SCHUR": ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
    "ITERATIVE_SCHUR_implicit": ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
}


def _options(mod, solver, precond, refinements, mixed=True):
    return mod.SolverOptions(
        linear_solver_type=getattr(mod.LinearSolverType, solver),
        preconditioner_type=getattr(mod.PreconditionerType, precond),
        use_mixed_precision_solves=mixed, max_num_refinement_iterations=refinements,
        eta=1e-3,
    )


def _aux(case, options, program, ss_build, aux_build):
    aux = aux_build(options, program)
    if case == "ITERATIVE_SCHUR_implicit":  # the structure without its assembly plan
        aux = dict(aux, ss=ss_build(program))
        assert aux["ss"].explicit is None
    return aux


def _solve_both(system, case, dtype, refinements, mixed=True):
    td, jd = DTYPES[dtype]
    solver, precond = SOLVERS[case]
    oj = _options(ct, solver, precond, refinements, mixed)
    ot = _options(ctt, solver, precond, refinements, mixed)
    aux_j = _aux(case, oj, system["jprog"], jschur.build_schur_structure, jax_aux)
    aux_t = _aux(case, ot, system["tprog"], tschur.build_schur_structure, _build_solve_aux)
    ctx, D = system["ctx"].to_dtype(td), system["Dt"].to(td)
    out_t = _linear_solve(ctx, D, aux_t, _config_from_options(ot))
    out_j = jax_linear_solve(_cast_tree(system["cj"], jd), system["Dj"].astype(jd),
                             _cast_tree(aux_j, jd), jax_config(oj, system["jprog"]))
    return out_t, out_j, ctx, D


@pytest.mark.parametrize("refinements", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SOLVERS)
def test_mixed_precision_solve_matches_jax(system, case, dtype, refinements):
    (yt, it, tt), (yj, ij, tj), ctx, D = _solve_both(system, case, dtype, refinements)
    assert yt.dtype == torch.float64 and np.asarray(yj).dtype == np.float64
    # the caller's context and damping keep their dtype
    assert ctx.dtype == D.dtype == DTYPES[dtype][0]
    assert all(J.dtype == ctx.dtype for js in ctx.jacs for J in js)
    assert int(it) == int(ij) and int(tt) == int(tj)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-4, atol=1e-4 * np.abs(yj).max())


@pytest.mark.parametrize("case", ["DENSE_NORMAL_CHOLESKY", "DENSE_SCHUR"])
def test_refinement_recovers_float64_accuracy(system, case):
    """Direct solvers: the refined step is closer to the float64 solve than
    one float32 solve, by orders of magnitude."""
    solver, precond = SOLVERS[case]
    ot = _options(ctt, solver, precond, 3, mixed=False)
    aux = _build_solve_aux(ot, system["tprog"])
    cfg = _config_from_options(ot)
    y64 = _linear_solve(system["ctx"], system["Dt"], aux, cfg)[0]
    y32 = _linear_solve(system["ctx"].to_dtype(torch.float32), system["Dt"].float(),
                        {**aux, "ss": aux["ss"] and aux["ss"].to_dtype(torch.float32)}, cfg)[0]
    (ymix, _, _), _, _, _ = _solve_both(system, case, "f64", 3)
    err32 = float((y32.double() - y64).norm() / y64.norm())
    errmix = float((ymix - y64).norm() / y64.norm())
    assert errmix < 1e-3 * err32 and errmix < 1e-10


def test_context_and_structure_casts():
    """``JacobianContext.to_dtype`` and ``SchurStructure.to_dtype``: the
    floating arrays change dtype, indices and plans do not, and a cast to
    the same dtype is the object itself."""
    tp = tbal.build_problem(tbal.synthesize_bal(**SIZES, seed=2))[0]
    prog = tp.program("cpu")
    x = torch.from_numpy(prog.initial_ambient())
    _, _, ctx = _full_impl(x, prog.families, prog.num_tangent, prog.groups)
    assert ctx.to_dtype(torch.float64) is ctx
    c32 = ctx.to_dtype(torch.float32)
    assert c32.dtype == torch.float32 and c32.groups is ctx.groups
    assert all(J.dtype == torch.float32 for js in c32.jacs for J in js)
    np.testing.assert_allclose(c32.gradient().double().numpy(), ctx.gradient().numpy(),
                               rtol=1e-5, atol=1e-5 * float(ctx.gradient().abs().max()))
    ss = tschur.build_schur_structure(prog)
    s32 = ss.to_dtype(torch.float32)
    assert s32.f_mask.dtype == torch.float32 and ss.f_mask.dtype == torch.float64
    assert s32.e_group is ss.e_group and s32.f_plan is ss.f_plan


def test_float32_fused_solve_with_refinement_matches_jax():
    """evaluation_dtype float32 with mixed-precision refinement, ITERATIVE_SCHUR +
    SCHUR_JACOBI, against ceres_tpu.fused_solve: final cost within 1e-4."""
    inst = jbal.synthesize_bal(num_cameras=6, num_points=300, num_observations=1200,
                               noise=2.0, perturb=0.5, seed=3)
    costs = []
    for mod, solve, kw in ((jbal, jax_fused_solve, {}), (tbal, ctt.fused_solve, {"device": "cpu"})):
        opts = mod.default_options(iterative=True)
        opts.evaluation_dtype = "float32"
        opts.use_mixed_precision_solves = True
        opts.max_num_refinement_iterations = 3
        s = solve(opts, mod.build_problem(inst)[0], **kw)
        assert s.is_solution_usable() and s.final_cost < 1e-2 * s.initial_cost
        costs.append(s.final_cost)
    np.testing.assert_allclose(costs[1], costs[0], rtol=1e-4)
