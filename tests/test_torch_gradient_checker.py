"""Gradient checks of the port against ceres_tpu's
(tests/test_gradient_check_during_solve.py and the GradientChecker of
tests/test_misc_components.py): a check that passes and one that fails
before the loop and during it, with the JAX messages, and GradientChecker's
probe. The residuals with a wrong derivative are hand-written Jacobians
(``analytic_cost``) in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.gradient_checker import GradientChecker as JaxChecker
from ceres_tpu.gradient_checker import check_problem_gradients as jax_check
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch.gradient_checker import GradientChecker, check_problem_gradients
from ceres_tpu_torch.models import bal as tbal


@jax.custom_jvp
def _sneaky_jax(t):
    return 0.5 * t


@_sneaky_jax.defjvp
def _sneaky_jvp(primals, tangents):
    (t,), (dt,) = primals, tangents
    return 0.5 * t, jnp.where(t < 1.0, 0.5 * dt, 7.0 * dt)


class _SneakyTorch(torch.autograd.Function):
    """0.5 t with a derivative that is right below t = 1 and wrong past it:
    the bug that only shows up mid-solve."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t):
        return 0.5 * t

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, dt):
        (t,) = ctx.saved_tensors
        return torch.where(t < 1.0, 0.5 * dt, 7.0 * dt)


def _bad_mid_solve_problem(mod):
    p = mod.Problem()
    pid = p.add_parameter_block(np.array([0.0]))
    if mod is ct:
        def resid(x):
            return jnp.asarray([x[0] - 3.0, _sneaky_jax(x[0])])
    else:
        def resid(x):
            return torch.cat([x[0:1] - 3.0, _SneakyTorch.apply(x[0:1])])
    p.add_residual_block(resid, None, [pid])
    return p


def _wrong_from_the_start(mod):
    """r = x^2 - 2 with a Jacobian of 3x."""
    stack = jnp.stack if mod is ct else torch.stack
    fn = mod.cost_functions.analytic_cost(
        lambda x: x * x - 2.0, lambda x: (stack([3.0 * x[0]]).reshape(1, 1),))
    p = mod.Problem()
    pid = p.add_parameter_block(np.array([1.5]))
    p.add_residual_block(fn, None, [pid])
    return p


def _solve(mod, problem, **kw):
    opts = mod.SolverOptions(linear_solver_type=mod.LinearSolverType.DENSE_QR,
                             check_gradients=True, **kw)
    return mod.solve(opts, problem, device="cpu") if mod is ctt else mod.solve(opts, problem)


def test_pre_solve_check_passes_at_x0():
    ok_j, msg_j = jax_check(_bad_mid_solve_problem(ct), 1e-6)
    ok_t, msg_t = check_problem_gradients(_bad_mid_solve_problem(ctt), 1e-6, device="cpu")
    assert ok_t and ok_j and msg_t == msg_j == ""


def test_solve_aborts_on_mid_solve_gradient_mismatch():
    sj, st = (_solve(mod, _bad_mid_solve_problem(mod), max_num_iterations=20,
                     gradient_check_relative_precision=1e-6) for mod in (ct, ctt))
    assert st.termination_type == ctt.TerminationType.FAILURE
    assert st.message.startswith("Gradient check failed at iteration")
    assert st.message == sj.message
    assert len(st.iterations) == len(sj.iterations)


def test_solve_fails_before_the_loop():
    sj, st = (_solve(mod, _wrong_from_the_start(mod)) for mod in (ct, ctt))
    assert st.termination_type == ctt.TerminationType.FAILURE
    assert st.message.startswith("Gradient check failed: family ")
    assert st.message == sj.message
    assert st.iterations == [] == sj.iterations


@pytest.mark.parametrize("minimizer", ["TRUST_REGION", "LINE_SEARCH"])
def test_healthy_solve_passes_with_checking_enabled(minimizer):
    def p_of(mod):
        p = mod.Problem()
        pid = p.add_parameter_block(np.array([0.0, 0.0]))
        if mod is ct:
            p.add_residual_block(lambda x: jnp.asarray([x[0] - 1.0, x[1] + 2.0, x[0] * x[1]]),
                                 None, [pid])
        else:
            p.add_residual_block(lambda x: torch.cat([x[0:1] - 1.0, x[1:2] + 2.0,
                                                      x[0:1] * x[1:2]]), None, [pid])
        return p

    sj, st = (_solve(mod, p_of(mod), max_num_iterations=30,
                     minimizer_type=mod.MinimizerType[minimizer]) for mod in (ct, ctt))
    assert st.termination_type.name == sj.termination_type.name == "CONVERGENCE"
    assert len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10, atol=1e-20)


def test_small_bal_passes_the_check_at_each_iterate():
    """A robust BAL with manifold-free cameras and points: the check runs
    on the first instances of each family at every accepted iterate."""
    out = []
    for mod in (ct, ctt):
        bm = jbal if mod is ct else tbal
        p = bm.build_problem(bm.synthesize_bal(num_cameras=3, num_points=30,
                                               num_observations=90, seed=4),
                             loss=mod.loss.HuberLoss(1.0))[0]
        opts = bm.default_options(iterative=False)
        opts.linear_solver_type = mod.LinearSolverType.DENSE_QR
        opts.check_gradients = True
        opts.gradient_check_relative_precision = 1e-6
        opts.max_num_iterations = 2
        out.append(mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p))
    sj, st = out
    assert st.is_solution_usable() and sj.is_solution_usable()
    assert len(st.iterations) == len(sj.iterations) == 3
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10)


def test_gradient_checker_probe():
    def fj(a, b):
        return jnp.stack([a[0] * b[1], jnp.sin(a[1]) + b[0] ** 2])

    def ft(a, b):
        return torch.cat([a[0:1] * b[1:2], torch.sin(a[1:2]) + b[0:1] ** 2])

    args = [np.array([0.3, -1.2]), np.array([2.0, 0.5])]
    okj, errj, msgj = JaxChecker(fj, (2, 2)).probe(args)
    okt, errt, msgt = GradientChecker(ft, (2, 2)).probe(args)
    assert okt and okj and msgt == msgj == ""
    np.testing.assert_allclose(errt, errj, rtol=1e-3, atol=1e-12)

    bad = ctt.cost_functions.analytic_cost(
        lambda a: a * a, lambda a: (2.5 * torch.diag(a),))
    ok, err, msg = GradientChecker(bad, (2,), relative_precision=1e-6).probe([np.array([1.0, 2.0])])
    assert not ok and err > 0.1 and msg.startswith("max relative jacobian error")
