"""DOGLEG in the port's host loop against ceres_tpu's (tests/test_dogleg.py
mirrored): Powell's function and a tiny robust BAL with both dogleg types,
record by record; the traditional step's three cases and the boundary
minimum of the subspace step against ``ceres_tpu.dogleg``; the radius rules.

f64 tolerances: costs rtol 1e-10 (above 1e-16 of the initial cost), cost
changes rtol 1e-10 or 1e-10 of the cost, relative decrease, radius and
gradient norms rtol 1e-6, step norms 1e-4 (as tests/test_torch_host_loop.py);
counts, flags and linear iterations exactly. f32: the dtypes, and the final
cost rtol 1e-4 of f64.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch import dogleg as tdl
from ceres_tpu_torch import trust_region as ttr
from ceres_tpu_torch.models import bal as tbal

TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
TYPES = ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"]
_EXACT = ("iteration", "step_is_valid", "step_is_successful", "linear_solver_iterations")


def _same_records(st, sj):
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    floor = 1e-16 * sj.iterations[0].cost
    g_floor = 1e-12 * sj.iterations[0].gradient_max_norm
    for a, b in zip(st.iterations, sj.iterations):
        for f in _EXACT:
            assert getattr(a, f) == getattr(b, f), (f, b.iteration)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10, atol=floor)
        np.testing.assert_allclose(a.cost_change, b.cost_change, rtol=1e-10,
                                   atol=max(1e-10 * b.cost, floor))
        for f, rtol in (("relative_decrease", 1e-6), ("trust_region_radius", 1e-6),
                        ("gradient_max_norm", 1e-6), ("gradient_norm", 1e-6),
                        ("step_norm", 1e-4)):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol,
                                       atol=g_floor if f.startswith("gradient") else 0.0)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10, atol=floor)


def _dogleg_options(mod, kind, **kw):
    return mod.SolverOptions(
        trust_region_strategy_type=mod.TrustRegionStrategyType.DOGLEG,
        dogleg_type=mod.DoglegType[kind], **kw,
    )


def _powell(mod):
    stack = jnp.stack if mod is ct else torch.cat

    def powell_fn(x1, x2, x3, x4):
        return stack([
            x1[0:1] + 10 * x2[0:1],
            5**0.5 * (x3[0:1] - x4[0:1]),
            (x2[0:1] - 2 * x3[0:1]) ** 2,
            10**0.5 * (x1[0:1] - x4[0:1]) ** 2,
        ]).reshape(4)

    p = mod.Problem()
    ids = [p.add_parameter_block(np.array([v])) for v in (3.0, -1.0, 0.0, 1.0)]
    p.add_residual_block(powell_fn, None, ids)
    return p


def _solve(mod, problem, opts):
    return mod.solve(opts, problem, device="cpu") if mod is ctt else mod.solve(opts, problem)


@pytest.mark.parametrize("kind", TYPES)
def test_powell_matches_jax(kind):
    out = []
    for mod in (ct, ctt):
        opts = _dogleg_options(mod, kind, linear_solver_type=mod.LinearSolverType.DENSE_QR,
                               max_num_iterations=100)
        out.append(_solve(mod, _powell(mod), opts))
    sj, st = out
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    assert st.final_cost < 1e-8  # system_test.cc:88 accuracy bar analog
    _same_records(st, sj)


def _tiny_bal(mod, kind, dtype="float64"):
    bm = jbal if mod is ct else tbal
    p, cams, _ = bm.build_problem(bm.synthesize_bal(**TINY), loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    opts = bm.default_options(iterative=False)  # DENSE_SCHUR
    opts.trust_region_strategy_type = mod.TrustRegionStrategyType.DOGLEG
    opts.dogleg_type = mod.DoglegType[kind]
    opts.evaluation_dtype = dtype
    return _solve(mod, p, opts)


@functools.lru_cache(maxsize=None)
def _tiny_both(kind):
    return _tiny_bal(ct, kind), _tiny_bal(ctt, kind)


@pytest.mark.parametrize("kind", TYPES)
def test_small_bal_matches_jax_record_by_record(kind):
    sj, st = _tiny_both(kind)
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    assert len(st.iterations) > 10
    assert st.trust_region_strategy_type_used == ctt.TrustRegionStrategyType.DOGLEG
    _same_records(st, sj)


@pytest.mark.parametrize("kind", TYPES)
def test_small_bal_float32(kind, monkeypatch):
    """f32 keeps every array of the step in f32 (the JAX package scales by
    an f64 sqrt(mu), which torch would promote silently)."""
    seen = []
    real = tdl.precompute

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(tuple(t.dtype for t in out[:4]))
        return out

    monkeypatch.setattr(tdl, "precompute", spy)
    s32 = _tiny_bal(ctt, kind, "float32")
    _, s64 = _tiny_both(kind)
    assert seen and all(d == (torch.float32,) * 4 for d in seen)
    assert s32.is_solution_usable()
    np.testing.assert_allclose(s32.final_cost, s64.final_cost, rtol=1e-4)


def _random_system(mod):
    """The random dense system of tests/test_dogleg.py in one package:
    (program, JacobianContext, dense J, residual vector)."""
    rng = np.random.default_rng(0)
    p = mod.Problem()
    ids = p.add_parameter_blocks(rng.standard_normal((3, 2)))

    def resid(a, b, data):
        A1, A2, rhs = data
        return A1 @ a + A2 @ b - rhs

    data = (rng.standard_normal((8, 3, 2)), rng.standard_normal((8, 3, 2)),
            rng.standard_normal((8, 3)))
    i = rng.integers(0, 3, 8)
    p.add_residual_blocks(resid, None, [ids[i], ids[(i + 1) % 3]], data=data)
    if mod is ct:
        from ceres_tpu.evaluator import Evaluator

        program = p.program()
        ctx = Evaluator(program).cost_gradient_jacobian(program.initial_ambient()).jacobian_context
        return program, ctx, np.asarray(ctx.to_dense()), np.asarray(ctx.residual_vector())
    program = p.program("cpu")
    x = torch.from_numpy(program.initial_ambient())
    ctx = ttr.Evaluator(program).cost_gradient_jacobian(x).jacobian_context
    return program, ctx, ctx.to_dense().numpy(), ctx.residual_vector().numpy()


def _strategies(kind="TRADITIONAL_DOGLEG"):
    from ceres_tpu.dogleg import DoglegStrategy
    from ceres_tpu.trust_region import _make_linear_solve

    out = []
    for mod in (ct, ctt):
        program, ctx, J, f = _random_system(mod)
        opts = _dogleg_options(mod, kind, linear_solver_type=mod.LinearSolverType.DENSE_QR)
        if mod is ct:
            strat = DoglegStrategy(opts, *_make_linear_solve(opts, program))
        else:
            strat = tdl.DoglegStrategy(opts, *ttr._make_linear_solve(opts, program))
        out.append((strat, ctx, J, f))
    return out


@pytest.mark.parametrize("kind", TYPES)
@pytest.mark.parametrize("radius", [1e12, 1e-6, 0.5, 2.0])
def test_step_cases_match_jax(kind, radius):
    """The Gauss-Newton step (huge radius), the Cauchy point (tiny radius)
    and the interpolant or subspace minimum (radii between), each against
    ceres_tpu.dogleg on the same system; the Gauss-Newton step also against
    its closed form and the Cauchy step's scaled norm against the radius."""
    (sj, cj, J, f), (st, ctx, Jt, _) = _strategies(kind)
    np.testing.assert_allclose(Jt, J, rtol=1e-14)
    sj.radius = st.radius = radius
    step_j, mcc_j, _, _ = sj.compute_step(cj)
    step_t, mcc_t, _, _ = st.compute_step(ctx)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(mcc_t, float(mcc_j), rtol=1e-9)
    np.testing.assert_allclose(st.dogleg_step_norm, sj.dogleg_step_norm, rtol=1e-9)
    assert mcc_t > 0
    D = np.sqrt(np.clip((J * J).sum(0), 1e-6, None))
    if radius == 1e12:
        gn = -np.linalg.solve(J.T @ J + st.mu * np.diag(D * D), J.T @ f)
        np.testing.assert_allclose(step_t.numpy(), gn, rtol=1e-6, atol=1e-10)
    if radius == 1e-6:
        np.testing.assert_allclose(np.linalg.norm(D * step_t.numpy()), radius, rtol=1e-8)


def test_boundary_minimum_matches_jax():
    from ceres_tpu.dogleg import DoglegStrategy

    rng = np.random.default_rng(3)
    for _ in range(20):
        A = rng.standard_normal((2, 2))
        B = A @ A.T + rng.uniform(0.0, 1.0) * np.eye(2)
        g = rng.standard_normal(2)
        radius = float(rng.uniform(0.05, 2.0))
        mj = DoglegStrategy._find_boundary_minimum(B, g, radius)
        mt = tdl.find_boundary_minimum(B, g, radius)
        assert (mj is None) == (mt is None)
        if mj is not None:
            np.testing.assert_array_equal(mt, mj)
    assert tdl.find_boundary_minimum(np.full((2, 2), np.nan), np.ones(2), 1.0) is None


def test_radius_update_rules():
    """StepAccepted / StepRejected / StepIsInvalid (dogleg_strategy.cc:617-643)."""
    opts = ctt.SolverOptions(
        trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
        initial_trust_region_radius=4.0,
    )
    s = tdl.DoglegStrategy(opts, lambda ctx, D, aux: (None, 0, 0))
    s.dogleg_step_norm = 10.0
    s.step_accepted(0.9)  # quality > 0.75 -> radius >= 3 * step_norm
    assert s.radius == 30.0
    s.step_accepted(0.1)  # quality < 0.25 -> radius halves
    assert s.radius == 15.0
    s.step_rejected(0.0)
    assert s.radius == 7.5 and s.reuse
    mu = s.mu
    s.step_is_invalid()
    assert not s.reuse and s.mu == 10 * mu


def test_dogleg_with_an_iterative_solver_is_invalid():
    """solver.cc:431-438, with the JAX message."""
    for solver in ("CGNR", "ITERATIVE_SCHUR"):
        messages = []
        for mod in (ct, ctt):
            opts = _dogleg_options(mod, "TRADITIONAL_DOGLEG",
                                   linear_solver_type=mod.LinearSolverType[solver])
            messages.append(_solve(mod, _powell(mod), opts).message)
        assert messages[1] == messages[0] and messages[0].startswith("Invalid options: DOGLEG")
