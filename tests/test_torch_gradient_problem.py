"""GradientProblem and solve_gradient_problem of the port against ceres_tpu's
(tests/test_misc_components.py:37-90 mirrored): Rosenbrock with each
direction type, a quadratic, a problem on the quaternion manifold and a
user (analytic) gradient. f64: the same record count and termination, x
rtol 1e-8 and costs rtol 1e-9 (floored at 1e-10 of the start's cost), where
the reference's own trajectory is steady; Rosenbrock under nonlinear CG and steepest descent is not (a start
one ulp away changes its record count and its x by 2e-5, ROSENBROCK_REFERENCE
in chip_smoke.py), and those two are held to the JAX test's bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt

DIRECTIONS = ["LBFGS", "BFGS", "NONLINEAR_CONJUGATE_GRADIENT", "STEEPEST_DESCENT"]


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _solve(mod, fn, x0, n=None, **kw):
    manifold = kw.pop("manifold", None)
    gradient_fn = kw.pop("gradient_fn", None)
    gp = mod.GradientProblem(fn, num_parameters=n or len(x0), manifold=manifold,
                             gradient_fn=gradient_fn)
    opts = mod.GradientProblemOptions(**kw)
    x = np.array(x0, dtype=np.float64)
    if mod is ctt:
        s = mod.solve_gradient_problem(opts, gp, x, device="cpu")
    else:
        s = mod.solve_gradient_problem(opts, gp, x)
    return s, x


def _same(out, rtol=1e-9):
    """The same records and x: costs rtol 1e-9, x rtol 1e-8."""
    (sj, xj), (st, xt) = out
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-12)
    # near the minimum a cost is a small difference: floored at 1e-10 of
    # the start's
    np.testing.assert_allclose([r.cost for r in st.iterations],
                               [r.cost for r in sj.iterations], rtol=rtol,
                               atol=1e-10 * sj.iterations[0].cost)
    assert [r.line_search_function_evaluations for r in st.iterations] == [
        r.line_search_function_evaluations for r in sj.iterations]
    assert st.num_iterations == len(st.iterations) - 1
    assert st.initial_cost == st.iterations[0].cost


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_rosenbrock(direction):
    """examples/rosenbrock.py with each direction type."""
    out = [_solve(mod, rosenbrock, [-1.2, 1.0], max_num_iterations=200,
                  line_search_direction_type=mod.LineSearchDirectionType[direction])
           for mod in (ct, ctt)]
    if direction in ("LBFGS", "BFGS"):
        _same(out)
        assert out[1][0].termination_type == ctt.TerminationType.CONVERGENCE
        np.testing.assert_allclose(out[1][1], [1.0, 1.0], atol=1e-5)
    else:
        # the reference's own trajectory moves under a one-ulp change of
        # the start: its termination and the JAX test's bars
        (sj, _), (st, xt) = out
        assert st.termination_type.name == sj.termination_type.name
        assert st.is_solution_usable()
        if direction == "NONLINEAR_CONJUGATE_GRADIENT":
            np.testing.assert_allclose(xt, [1.0, 1.0], atol=1e-4)
        else:
            assert len(st.iterations) == len(sj.iterations) == 201
            assert st.final_cost < rosenbrock(np.array([-1.2, 1.0]))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_quadratic(direction):
    """test_misc_components.py's test_gradient_problem_directions."""
    target = [1.0, -2.0, 3.0]

    def f_jax(x):
        return jnp.sum((x - jnp.asarray(target)) ** 2)

    def f_torch(x):
        return torch.sum((x - torch.tensor(target, dtype=x.dtype)) ** 2)

    out = [_solve(mod, f, np.zeros(3), max_num_iterations=300,
                  line_search_direction_type=mod.LineSearchDirectionType[direction])
           for mod, f in ((ct, f_jax), (ctt, f_torch))]
    _same(out)
    assert out[1][0].is_solution_usable()
    np.testing.assert_allclose(out[1][1], target, atol=1e-4)


def test_on_the_quaternion_manifold():
    """Distance to a target rotation, on the quaternion manifold: the
    gradient goes into the tangent space through the chart."""
    target = np.array([0.5, 0.5, 0.5, 0.5])

    def f_jax(q):
        return jnp.sum((q - jnp.asarray(target)) ** 2)

    def f_torch(q):
        return torch.sum((q - torch.from_numpy(target).to(q.dtype)) ** 2)

    out = [_solve(mod, f, [1.0, 0.0, 0.0, 0.0], manifold=mod.QuaternionManifold(),
                  max_num_iterations=200)
           for mod, f in ((ct, f_jax), (ctt, f_torch))]
    _same(out)
    x = out[1][1]
    np.testing.assert_allclose(x, target, atol=1e-4)
    assert np.linalg.norm(x) == pytest.approx(1.0, abs=1e-10)
    assert out[1][0].num_effective_parameters == 3


def test_user_gradient():
    """examples/rosenbrock_analytic_diff.py: a hand-written gradient, on
    R^2 and, mapped by the plus Jacobian, on a manifold."""

    def grad_jax(x):
        g0 = -2.0 * (1.0 - x[0]) - 400.0 * x[0] * (x[1] - x[0] ** 2)
        return jnp.stack([g0, 200.0 * (x[1] - x[0] ** 2)])

    def grad_torch(x):
        g0 = -2.0 * (1.0 - x[0]) - 400.0 * x[0] * (x[1] - x[0] ** 2)
        return torch.stack([g0, 200.0 * (x[1] - x[0] ** 2)])

    out = [_solve(mod, rosenbrock, [-1.2, 1.0], gradient_fn=g, max_num_iterations=200)
           for mod, g in ((ct, grad_jax), (ctt, grad_torch))]
    _same(out)
    auto = _solve(ctt, rosenbrock, [-1.2, 1.0], max_num_iterations=200)
    assert len(auto[0].iterations) == len(out[1][0].iterations)
    np.testing.assert_allclose(auto[1], out[1][1], rtol=1e-12)

    def f_sphere(x):
        return x[0] + 2.0 * x[1] + 3.0 * x[2]

    out = [_solve(mod, f_sphere, [1.0, 0.0, 0.0], manifold=mod.SphereManifold(3),
                  gradient_fn=(lambda x, m=m: m.stack([x[0] * 0 + 1.0, x[0] * 0 + 2.0,
                                                       x[0] * 0 + 3.0])),
                  max_num_iterations=100)
           for mod, m in ((ct, jnp), (ctt, torch))]
    _same(out)
    np.testing.assert_allclose(out[1][1], -np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0), atol=1e-5)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    gp = ctt.GradientProblem(rosenbrock, num_parameters=2)
    with pytest.raises((RuntimeError, AssertionError)):
        ctt.solve_gradient_problem(ctt.GradientProblemOptions(), gp, np.array([-1.2, 1.0]))


def test_manifold_size_is_checked():
    with pytest.raises(ValueError, match="ambient size"):
        ctt.GradientProblem(rosenbrock, num_parameters=3, manifold=ctt.QuaternionManifold())
