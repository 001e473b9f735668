"""Implicit-S ITERATIVE_SCHUR parity: ceres_tpu_torch.linear.schur against
ceres_tpu.linear.schur without an assembled S.

On a small robust BAL (8 cameras / 500 points / 2000 observations, Huber
loss, one constant point, Jacobi column scaling as inside the loop and the LM
damping of a trust region of radius 10): the implicit SCHUR_JACOBI blocks, the reduced rhs of a tangent rhs and
its back substitution (float64 rtol 1e-10, float32 1e-4), and solve_schur
with no explicit plan (the JAX call with ``ss=`` takes its implicit branch)
for every preconditioner the port runs there, with and without the
power-series initialization and a tangent rhs, eta 1e-2: equal CG counts
(1 to 14) and termination codes, steps to 1e-10. (Unpreconditioned CG on
the barely damped system of radius 1e4 runs 47 iterations on a random rhs,
and there the two packages' rounding, 1e-15 apart, grows to 1e-4.) Then the user elimination ordering
(``ordered_groups.py`` against the JAX module, and a solve with two groups),
and ``fused_solve`` above the explicit-S threshold (230 cameras, nf = 2070)
against ``ceres_tpu.fused_solve``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu import ordered_groups as jog
from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.linear import schur as jschur
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _cast_tree
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu.trust_region import _lm_damping as jax_damping
from ceres_tpu_torch import ordered_groups as tog
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.linear.schur import EXPLICIT_S_AUTO_MAX_NF
from ceres_tpu_torch.linear.schur_explicit import assemble_reduced_system, build_explicit_plan
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import _config_from_options, _lm_damping

SMALL = dict(num_cameras=8, num_points=500, num_observations=2000, noise=2.0, perturb=0.5,
             seed=42)
RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _close(t, j, rtol):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def system():
    inst = jbal.synthesize_bal(**SMALL)
    jp, _, jpts = jbal.build_problem(inst, loss=ct.loss.HuberLoss(1.0))
    tp, _, tpts = tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))
    jp.set_parameter_block_constant(int(jpts[3]))
    tp.set_parameter_block_constant(int(tpts[3]))
    jprog, tprog = jp.program(), tp.program("cpu")
    x0 = np.asarray(jprog.initial_ambient())

    def jax_system(x):  # jitted: one compile in place of many eager ones
        _, _, cj = jax_full(x, jprog.families, True, jprog.num_tangent, jprog.jnp_bd_groups())
        cj = cj.scale_columns(1.0 / (1.0 + jnp.sqrt(cj.squared_column_norms())))
        return cj, jax_damping(jnp.clip(cj.squared_column_norms(), 1e-6, 1e32),
                               jnp.asarray(10.0))

    cj, Dj = jax.jit(jax_system)(jnp.asarray(x0))
    _, _, ct_ = _full_impl(torch.from_numpy(x0.copy()), tprog.families, tprog.num_tangent,
                           tprog.groups)
    ct_ = ct_.scale_columns(1.0 / (1.0 + torch.sqrt(ct_.squared_column_norms())))
    Dt = _lm_damping(torch.clamp(ct_.squared_column_norms(), 1e-6, 1e32),
                     torch.tensor(10.0, dtype=torch.float64))
    ss_j = jschur.build_schur_structure(jprog)
    ss_t = tschur.build_schur_structure(tprog)
    assert ss_j.explicit is None and ss_t.explicit is None
    return dict(jprog=jprog, tprog=tprog, cj=cj, ct=ct_, Dj=Dj, Dt=Dt, ss_j=ss_j, ss_t=ss_t)


def _ops(system, dtype):
    """The port's SchurOperator with the context, damping and structure in
    ``dtype``, and a function that runs a method of the JAX package's one
    in the same dtype, jitted."""
    jd = JDTYPE[dtype]
    args = (_cast_tree(system["cj"], jd), system["Dj"].astype(jd), _cast_tree(system["ss_j"], jd))

    def jax_op(method, *vs):
        return jax.jit(lambda c, d, s, *v: getattr(jschur.SchurOperator(c, d, s), method)(*v))(
            *args, *(jnp.asarray(v, jd) for v in vs))

    op_t = tschur.SchurOperator(system["ct"].to_dtype(dtype), system["Dt"].to(dtype),
                                system["ss_t"].to_dtype(dtype))
    return op_t, jax_op


def test_f_plans_match_jax(system):
    ss_t, ss_j = system["ss_t"], system["ss_j"]
    for fp_t, fp_j in zip(ss_t.f_pos, ss_j.f_pos):
        for a, b in zip(fp_t, fp_j):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b))
    # BA's camera rows are their block-diagonal rows: the family's plan serves.
    assert ss_t.f_plan[0][0] is system["tprog"].families[0].reduce_plans[0]
    assert ss_t.f_plan[0][1] is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_schur_jacobi_blocks_match_jax(system, dtype):
    op_t, jax_op = _ops(system, dtype)
    bt, bj = op_t.schur_jacobi_blocks(), jax_op("schur_jacobi_blocks")
    assert bt.keys() == bj.keys()
    for T in bt:
        assert bt[T].dtype == dtype
        _close(bt[T], bj[T], RTOL[dtype])
    v = np.random.default_rng(5).standard_normal(system["tprog"].num_tangent)
    jax_m = jax.jit(lambda c, d, s, v: jschur.SchurOperator(c, d, s)
                    .schur_jacobi_preconditioner()(v))
    _close(op_t.schur_jacobi_preconditioner()(torch.from_numpy(v).to(dtype)),
           jax_m(*_cast_tree((system["cj"], system["Dj"], system["ss_j"]), JDTYPE[dtype]),
                 jnp.asarray(v, JDTYPE[dtype])), RTOL[dtype])


def test_schur_jacobi_blocks_are_the_diagonal_of_s(system):
    """The implicit blocks against the diagonal cells of the port's own
    assembled S (the constant point's instances read the zero row)."""
    op_t, _ = _ops(system, torch.float64)
    ss = dataclasses.replace(system["ss_t"])
    ss.explicit = build_explicit_plan(system["tprog"], ss)
    S = assemble_reduced_system(tschur.SchurOperator(op_t.ctx, op_t.D, ss), ss.explicit)
    fr = ss.explicit.f_reduced
    for T, idx in ss.f_groups.items():
        r = fr[idx]
        _close(op_t.schur_jacobi_blocks()[T], S[r[:, :, None], r[:, None, :]], 1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tangent_rhs_and_back_substitution_match_jax(system, dtype):
    op_t, jax_op = _ops(system, dtype)
    rng = np.random.default_rng(6)
    r = rng.standard_normal(system["tprog"].num_tangent)
    x = rng.standard_normal(system["tprog"].num_tangent)
    rt, xt = torch.from_numpy(r).to(dtype), torch.from_numpy(x).to(dtype)
    out = op_t.rhs_from_tangent(rt)
    assert out.dtype == dtype
    _close(out, jax_op("rhs_from_tangent", r), RTOL[dtype])
    _close(op_t.back_substitute_tangent(xt, rt), jax_op("back_substitute_tangent", x, r),
           RTOL[dtype])


def test_tangent_rhs_of_the_gradient_is_the_plain_rhs(system):
    """rhs = J'f through the tangent path is the plain reduced rhs and back
    substitution."""
    op_t, _ = _ops(system, torch.float64)
    g = op_t.ctx.gradient()
    _close(op_t.rhs_from_tangent(g), op_t.rhs().numpy(), 1e-10)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(g.shape[0]))
    _close(op_t.back_substitute_tangent(x, g), op_t.back_substitute(x).numpy(), 1e-10)


PRECONDITIONERS = ["IDENTITY", "JACOBI", "SCHUR_JACOBI", "SCHUR_POWER_SERIES_EXPANSION"]


@pytest.mark.parametrize("tangent_rhs", [False, True], ids=["jtf", "rhs"])
@pytest.mark.parametrize("spse_init", [False, True], ids=["x0=0", "spse_init"])
@pytest.mark.parametrize("precond", PRECONDITIONERS)
def test_implicit_solve_schur_matches_jax(system, precond, spse_init, tangent_rhs):
    oj, ot = (mod.SolverOptions(linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
                                preconditioner_type=getattr(mod.PreconditionerType, precond),
                                use_spse_initialization=spse_init, eta=1e-2)
              for mod in (ct, ctt))
    rhs_t = rhs_j = None
    if tangent_rhs:
        r = np.random.default_rng(9).standard_normal(system["tprog"].num_tangent)
        rhs_t, rhs_j = torch.from_numpy(r), jnp.asarray(r)
    yt, it, tt = tschur.solve_schur(system["ct"], system["Dt"], _config_from_options(ot),
                                    system["ss_t"], rhs=rhs_t)
    yj, ij, tj = jschur.solve_schur(system["cj"], system["Dj"], system["jprog"],
                                    jax_config(oj, system["jprog"]), ss=system["ss_j"],
                                    rhs=rhs_j)
    assert int(it) == int(ij) >= 1 and int(tt) == int(tj)
    _close(yt, yj, 1e-10)


# -- the user elimination ordering ------------------------------------------


def test_ordered_groups_match_jax():
    gt, gj = tog.OrderedGroups(), jog.OrderedGroups()
    for el, g in ((5, 1), (2, 0), (9, 3), (4, 1), (7, 0)):
        gt.add_element_to_group(el, g)
        gj.add_element_to_group(el, g)
    assert gt.remove_element(9) == gj.remove_element(9)
    assert gt.remove_element(9) == gj.remove_element(9) is False
    for f in ("num_elements", "num_groups"):
        assert getattr(gt, f) == getattr(gj, f)
    assert gt.as_group_list() == gj.as_group_list() == [[2, 7], [4, 5]]
    assert gt.min_non_zero_group() == gj.min_non_zero_group()
    assert [gt.group(e) for e in range(10)] == [gj.group(e) for e in range(10)]
    assert gt.group_size(1) == gj.group_size(1) and gt.is_member(4) == gj.is_member(4)
    gt.reverse()
    gj.reverse()
    assert gt.group_to_elements() == gj.group_to_elements() == {0: [4, 5], 1: [2, 7]}
    for ordering in (None, gt, [[3, 1], (2,)]):
        assert tog.normalize_ordering(ordering) == jog.normalize_ordering(
            gj if ordering is gt else ordering)
    with pytest.raises(ValueError):
        gt.add_element_to_group(1, -1)


def test_ordering_validation_matches_jax(system):
    tprog, jprog = system["tprog"], system["jprog"]
    cams, pts = list(range(8)), list(range(8, 508))
    for groups in ([pts, cams], [pts[:-1], cams], [pts, cams + [8]]):
        errs = []
        for mod, prog in ((tog, tprog), (jog, jprog)):
            try:
                mod.validate_ordering_partition(prog, groups)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
    for mod, prog in ((tog, tprog), (jog, jprog)):
        mod.validate_independent_set(prog, pts)
        first_residual = [int(p) for p in np.asarray(prog.families[0].block_ids)[0]]
        with pytest.raises(ValueError, match="independent"):
            mod.validate_independent_set(prog, first_residual)


def test_two_group_ordering_solve_matches_jax():
    """linear_solver_ordering = [cameras, points]: the cameras are
    eliminated, where the automatic ordering takes the points, and S is
    the points' system; DENSE_SCHUR, f64, against ceres_tpu.fused_solve."""
    inst = jbal.synthesize_bal(num_cameras=5, num_points=120, num_observations=480,
                               noise=2.0, perturb=0.5, seed=11)
    jp, jcams, jpts = jbal.build_problem(inst)
    tp, tcams, tpts = tbal.build_problem(inst)
    order_t = ctt.OrderedGroups()
    for g, ids in enumerate((tcams, tpts)):
        for pid in ids:
            order_t.add_element_to_group(int(pid), g)
    oj, ot = jbal.default_options(iterative=False), tbal.default_options(iterative=False)
    oj.max_num_iterations = ot.max_num_iterations = 5
    oj.linear_solver_ordering = [[int(c) for c in jcams], [int(p) for p in jpts]]
    ot.linear_solver_ordering = order_t
    sj = jax_fused_solve(oj, jp)
    st = ctt.fused_solve(ot, tp, device="cpu")
    ss = tp.program("cpu").schur_structure
    assert ss.e_tangent_size == 9 and ss.f_idx.shape[0] == 3 * 120
    assert st.num_iterations == len(sj.iterations)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-9)
    ot.linear_solver_ordering = [[int(c) for c in tcams], [int(p) for p in tpts[1:]]]
    with pytest.raises(ValueError, match="missing"):
        ctt.fused_solve(ot, tbal.build_problem(inst)[0], device="cpu")


# -- end to end above the explicit-S threshold ------------------------------


def test_fused_solve_implicit_s_matches_jax():
    """230 cameras (nf = 2070 > 2048): S is never assembled; the port takes
    the JAX package's LM and CG iteration counts to a cost within 1e-9."""
    inst = jbal.synthesize_bal(num_cameras=230, num_points=300, num_observations=1400,
                               noise=2.0, perturb=0.5, seed=4)
    jp, tp = jbal.build_problem(inst)[0], tbal.build_problem(inst)[0]
    oj, ot = jbal.default_options(iterative=True), tbal.default_options(iterative=True)
    oj.max_num_iterations = ot.max_num_iterations = 5
    sj = jax_fused_solve(oj, jp)
    st = ctt.fused_solve(ot, tp, device="cpu")
    ss = tp.program("cpu").schur_structure
    assert ss.f_idx.shape[0] == 2070 > EXPLICIT_S_AUTO_MAX_NF and ss.explicit is None
    assert st.num_iterations == len(sj.iterations)
    assert st.num_linear_solver_iterations == sj.num_linear_solver_iterations
    assert st.termination_type.name == sj.termination_type.name
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-9)
