"""The whole slice: ceres_tpu_torch.fused_solve / solve against ceres_tpu's
on one small BAL instance, both with ITERATIVE_SCHUR + SCHUR_JACOBI, and
(second half) robust bundle adjustment with a Huber loss and a constant
camera under every linear solver the port has, record by record.

f64: equal LM iteration and successful-step counts, final cost rtol 1e-8,
parameters within 1e-6 x max|x|. f32: final cost rtol 1e-4 (near the
optimum f32 rounding decides individual accept/reject outcomes, so the
iteration counts may differ).
"""

import numpy as np
import pytest

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch.interop import state_from_numpy, state_to_numpy
from ceres_tpu_torch.models import bal as tbal

SIZES = dict(num_cameras=6, num_points=800, num_observations=3000, noise=2.0, perturb=0.7)


def _options(module, dtype):
    opts = module.default_options(iterative=True)
    opts.max_num_iterations = 50
    opts.function_tolerance = 1e-9
    opts.evaluation_dtype = dtype
    return opts


def _state(problem):
    return np.concatenate(
        [problem.parameter_block_value(p) for p in range(problem.num_parameter_blocks())]
    )


@pytest.mark.parametrize("seed", [3, 16])
def test_fused_solve_f64_matches_jax(seed):
    inst = jbal.synthesize_bal(**SIZES, seed=seed)
    jp = jbal.build_problem(inst)[0]
    tp = tbal.build_problem(inst)[0]
    sj = jax_fused_solve(_options(jbal, None), jp)
    st = ctt.fused_solve(_options(tbal, None), tp, device="cpu")
    assert st.num_iterations == len(sj.iterations)
    assert st.num_successful_steps == sj.num_successful_steps
    assert st.num_linear_solver_iterations == sj.num_linear_solver_iterations
    assert st.termination_type.name == sj.termination_type.name
    np.testing.assert_allclose(st.initial_cost, sj.initial_cost, rtol=1e-10)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-8)
    xj = _state(jp)
    np.testing.assert_allclose(_state(tp), xj, rtol=0, atol=1e-6 * np.abs(xj).max())


def test_fused_solve_f32_matches_jax():
    inst = jbal.synthesize_bal(**SIZES, seed=3)
    sj = jax_fused_solve(_options(jbal, "float32"), jbal.build_problem(inst)[0])
    st = ctt.fused_solve(_options(tbal, "float32"), tbal.build_problem(inst)[0], device="cpu")
    assert st.final_cost < 1e-2 * st.initial_cost
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-4)


def test_solve_matches_ct_solve_f64():
    """ct.solve's fused path returns the pre-step iterate when a step meets
    the function/parameter tolerance; the port's solve does the same."""
    inst = jbal.synthesize_bal(**SIZES, seed=5)
    jp = jbal.build_problem(inst)[0]
    tp = tbal.build_problem(inst)[0]
    sj = ct.solve(_options(jbal, None), jp)
    st = ctt.solve(_options(tbal, None), tp, device="cpu")
    assert st.num_successful_steps == sj.num_successful_steps
    assert st.termination_type.name == sj.termination_type.name
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-8)
    xj = _state(jp)
    np.testing.assert_allclose(_state(tp), xj, rtol=0, atol=1e-6 * np.abs(xj).max())


def test_interop_round_trips_initial_ambient():
    inst = jbal.synthesize_bal(**SIZES, seed=2)
    jprog = jbal.build_problem(inst)[0].program()
    x = np.asarray(jprog.initial_ambient())
    tp = tbal.build_problem(tbal.synthesize_bal(**SIZES, seed=8))[0]
    state_from_numpy(tp, x, jprog.ambient_offset)
    assert np.array_equal(state_to_numpy(tp), x)
    assert np.array_equal(tp.program("cpu").initial_ambient(), x)
    with pytest.raises(ValueError):
        state_from_numpy(tp, x[:-1])
    shifted = {pid: off + 1 for pid, off in jprog.ambient_offset.items()}
    with pytest.raises(ValueError, match="differently"):
        state_from_numpy(tp, x, shifted)


def test_unsupported_options_are_roadmap_items():
    """The sparse solvers and the cluster preconditioners, once ROADMAP
    items, run in the fused loop as in the JAX package (the sparse solvers
    through their solve for a (ctx, D) caller) and reach the host loop's
    cost (held to JAX's by test_torch_sparse_*.py and
    test_torch_cluster_preconditioners.py); a sharded evaluation runs too
    (item 19, tests/test_torch_parallel*.py), and a mesh that is no
    DeviceMesh is refused, naming what it must be."""
    tiny = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.7,
                seed=1)
    for changes in (dict(linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY),
                    dict(preconditioner_type=ctt.PreconditionerType.CLUSTER_JACOBI),
                    dict(preconditioner_type=ctt.PreconditionerType.CLUSTER_TRIDIAGONAL),
                    dict(linear_solver_type=ctt.LinearSolverType.SPARSE_SCHUR)):
        opts = _options(tbal, None)
        for field, value in changes.items():
            setattr(opts, field, value)
        fused = ctt.fused_solve(opts, tbal.build_problem(tbal.synthesize_bal(**tiny))[0],
                                device="cpu")
        host = ctt.solve(opts, tbal.build_problem(tbal.synthesize_bal(**tiny))[0], device="cpu")
        assert fused.is_solution_usable() and host.is_solution_usable(), changes
        np.testing.assert_allclose(fused.final_cost, host.final_cost, rtol=1e-6)
    tp = tbal.build_problem(tbal.synthesize_bal(**SIZES, seed=1))[0]
    opts = _options(tbal, None)
    opts.mesh = object()
    with pytest.raises(TypeError, match="DeviceMesh"):
        ctt.fused_solve(opts, tp, device="cpu")
    # what only the host loop or the line search honours: fused_solve
    # refuses it and names solve
    for changes in (dict(callbacks=[lambda it: None]),
                    dict(trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
                         linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
                    dict(minimizer_type=ctt.MinimizerType.LINE_SEARCH),
                    dict(use_inner_iterations=True),
                    dict(check_gradients=True)):
        opts = _options(tbal, None)
        for field, value in changes.items():
            setattr(opts, field, value)
        with pytest.raises(ValueError, match="ctt.solve"):
            ctt.fused_solve(opts, tp, device="cpu")


# -- robust bundle adjustment through solve ----------------------------------

ROBUST = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)


def _robust_pair(constant_cameras=0, **sizes):
    inst = jbal.synthesize_bal(**(sizes or ROBUST))
    jp, jcams, _ = jbal.build_problem(inst, loss=ct.loss.HuberLoss(1.0))
    tp, tcams, _ = tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))
    if constant_cameras:
        jp.set_parameter_block_constant(jcams[:constant_cameras])
        tp.set_parameter_block_constant(tcams[:constant_cameras])
    return jp, tp


def _same_records(st, sj, cost_rtol=1e-9, grad_rtol=1e-5):
    """Equal iteration counts and per-iteration records: costs to
    ``cost_rtol``, the flags and the CG iteration counts exactly."""
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    for a, b in zip(st.iterations, sj.iterations):
        assert a.iteration == b.iteration
        np.testing.assert_allclose(a.cost, b.cost, rtol=cost_rtol)
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-6)
        np.testing.assert_allclose(a.gradient_max_norm, b.gradient_max_norm, rtol=grad_rtol)
        # (not the step norm: without a fixed gauge the step's component
        # along the gauge directions is set by rounding alone)
    np.testing.assert_allclose(st.initial_cost, sj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=cost_rtol)
    assert st.num_successful_steps == sj.num_successful_steps
    assert st.num_unsuccessful_steps == sj.num_unsuccessful_steps
    assert st.num_linear_solver_iterations == sj.num_linear_solver_iterations


@pytest.mark.parametrize("constant_camera", [False, True], ids=["free", "constant_camera"])
@pytest.mark.parametrize("iterative", [True, False], ids=["iterative_schur", "dense_schur"])
def test_robust_bal_solve_matches_jax_record_by_record(iterative, constant_camera):
    """The canonical drive: BAL 8/500/2000, seed 42, HuberLoss(1.0), f64."""
    jp, tp = _robust_pair(int(constant_camera))
    sj = ct.solve(jbal.default_options(iterative=iterative), jp)
    st = ctt.solve(tbal.default_options(iterative=iterative), tp, device="cpu")
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    assert len(st.iterations) > 10
    _same_records(st, sj)
    xj = _state(jp)
    np.testing.assert_allclose(_state(tp), xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    assert st.num_effective_parameters == sj.num_effective_parameters
    assert "Huber" not in st.full_report() and "ITERATIVE_SCHUR" in st.full_report() or not iterative


@pytest.mark.parametrize("solver", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "CGNR"])
def test_robust_bal_small_with_dense_solvers_and_cgnr(solver):
    """A BAL small enough to factor densely (5/60/240), Huber, two constant
    cameras (they fix the gauge, so the normal equations are well
    conditioned and LAPACK's and XLA's factorizations agree). The dense
    solvers match JAX record by record. CGNR's final cost is held at 1e-6
    (each CG solve stops by the same test on Jacobians equal to 1e-12, but
    its rounding differs and the LM loop carries it)."""
    sizes = dict(num_cameras=5, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
    jp, tp = _robust_pair(2, **sizes)
    oj = ct.SolverOptions(linear_solver_type=ct.LinearSolverType[solver], max_num_iterations=30)
    ot = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType[solver], max_num_iterations=30)
    sj, st = ct.solve(oj, jp), ctt.solve(ot, tp, device="cpu")
    assert st.linear_solver_type_used.name == solver
    if solver == "CGNR":
        assert len(st.iterations) == len(sj.iterations)
        np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-6)
    else:
        _same_records(st, sj)
        xj = _state(jp)
        np.testing.assert_allclose(_state(tp), xj, rtol=0, atol=1e-8 * np.abs(xj).max())


def test_auto_linear_solver_resolves_as_jax():
    sizes = dict(num_cameras=5, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
    jp, tp = _robust_pair(0, **sizes)
    sj = ct.solve(ct.SolverOptions(max_num_iterations=5), jp)
    st = ctt.solve(ctt.SolverOptions(max_num_iterations=5), tp, device="cpu")
    assert st.linear_solver_type_used.name == sj.linear_solver_type_used.name == "DENSE_NORMAL_CHOLESKY"
    _same_records(st, sj)
    assert st.termination_type == ctt.TerminationType.NO_CONVERGENCE


def test_robust_fused_solve_f32_close_to_f64():
    jp, tp = _robust_pair()
    o64, o32 = tbal.default_options(), tbal.default_options()
    o32.evaluation_dtype = "float32"
    s64 = ctt.fused_solve(o64, tp, device="cpu")
    s32 = ctt.fused_solve(o32, _robust_pair()[1], device="cpu")
    sj = jax_fused_solve(jbal.default_options(), jp)
    np.testing.assert_allclose(s64.final_cost, sj.final_cost, rtol=1e-9)
    assert s64.num_iterations == len(sj.iterations)
    np.testing.assert_allclose(s32.final_cost, s64.final_cost, rtol=1e-4)
    assert s64.iterations == []  # fused_solve keeps the count only


def test_exits_before_the_loop():
    """Invalid options, no non-constant blocks and an infeasible start end
    as in the JAX package's solve, without running the loop."""
    sizes = dict(num_cameras=3, num_points=20, num_observations=60, seed=2)
    for mod, module, kw in ((ct, jbal, {}), (ctt, tbal, dict(device="cpu"))):
        inst = module.synthesize_bal(**sizes)
        p = module.build_problem(inst, loss=mod.loss.HuberLoss(1.0))[0]
        bad = module.default_options()
        bad.max_trust_region_radius = 1.0  # below the initial radius
        s = mod.solve(bad, p, **kw)
        assert s.termination_type.name == "FAILURE" and s.message.startswith("Invalid options")
        bad = module.default_options()
        bad.linear_solver_type = mod.LinearSolverType.CGNR  # with SCHUR_JACOBI
        assert "CGNR" in mod.solve(bad, p, **kw).message

        p.set_parameter_block_constant(np.arange(p.num_parameter_blocks()))
        s = mod.solve(module.default_options(), p, **kw)
        assert s.termination_type.name == "CONVERGENCE"
        assert s.message.endswith("No non-constant parameter blocks found.")
        assert s.initial_cost == s.final_cost == s.fixed_cost > 0
        if mod is ct:
            fixed_jax = s.fixed_cost
        else:
            np.testing.assert_allclose(s.fixed_cost, fixed_jax, rtol=1e-12)

        p = module.build_problem(inst)[0]
        p.set_parameter_lower_bound(0, 0, 1e3)
        s = mod.solve(module.default_options(), p, **kw)
        assert s.termination_type.name == "FAILURE" and "infeasible" in s.message


@pytest.mark.parametrize("field,value,complaint", [
    ("max_num_iterations", -1, "max_num_iterations"),
    ("eta", 0.0, "eta"),
    ("min_lm_diagonal", 1e40, "min_lm_diagonal > max_lm_diagonal"),
    ("min_linear_solver_iterations", 1000, "min_linear_solver_iterations >"),
    ("evaluation_dtype", "float16", "evaluation_dtype"),
    ("preconditioner_type", "SUBSET", "SUBSET"),
    ("trust_region_strategy_type", "DOGLEG", "DOGLEG"),
])
def test_validate_matches_jax(field, value, complaint):
    oj, ot = jbal.default_options(), tbal.default_options()
    for o, mod in ((oj, ct), (ot, ctt)):
        v = value
        if field == "preconditioner_type":
            v = mod.PreconditionerType[value]
        if field == "trust_region_strategy_type":
            v = mod.TrustRegionStrategyType[value]
        setattr(o, field, v)
    assert ot.validate(0) == oj.validate(0)
    assert complaint in ot.validate(0)
    assert tbal.default_options().validate(0) is None
