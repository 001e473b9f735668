"""Cost-function adapters: ceres_tpu_torch.cost_functions against
ceres_tpu.cost_functions (float64, rtol 1e-12), values and the Jacobians the
evaluator takes with vmap(jacfwd).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ceres_tpu import cost_functions as jc
from ceres_tpu_torch import cost_functions as tc

RNG = np.random.default_rng(33)


def _close(t, j, tol=1e-12):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def test_normal_prior():
    A, b, x = RNG.standard_normal((2, 4)), RNG.standard_normal(4), RNG.standard_normal(4)
    ft, fj = tc.normal_prior(A, b), jc.normal_prior(A, b)
    _close(ft(torch.from_numpy(x)), fj(jnp.asarray(x)))
    _close(jacfwd(ft)(torch.from_numpy(x)), jax.jacfwd(fj)(jnp.asarray(x)))
    assert ft(torch.from_numpy(x).float()).dtype == torch.float32
    with pytest.raises(ValueError):
        tc.normal_prior(np.zeros((2, 3)), np.zeros(4))


def _residual_t(x, y):
    return torch.cat([x[:2] * y[0:1], torch.sin(x[2:3]) + y[1:2]])


def _residual_j(x, y):
    return jnp.stack([x[0] * y[0], x[1] * y[0], jnp.sin(x[2]) + y[1]])


def test_conditioned_scaled_fixed_and_to_functor():
    x, y = RNG.standard_normal(3), RNG.standard_normal(2)
    xt, yt, xj, yj = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    ct_ = tc.conditioned(_residual_t, [lambda v: 2.0 * v, torch.tanh, lambda v: v * v])
    cj = jc.conditioned(_residual_j, [lambda v: 2.0 * v, jnp.tanh, lambda v: v * v])
    _close(ct_(xt, yt), cj(xj, yj))
    _close(jacfwd(ct_)(xt, yt), jax.jacfwd(cj)(xj, yj))
    M = RNG.standard_normal((2, 3))
    for scale in (0.5, M):
        _close(tc.scaled(_residual_t, scale)(xt, yt), jc.scaled(_residual_j, scale)(xj, yj))
    _close(tc.fixed_arguments(_residual_t, {1: y})(xt), jc.fixed_arguments(_residual_j, {1: y})(xj))
    _close(tc.fixed_arguments(_residual_t, {0: x})(yt), jc.fixed_arguments(_residual_j, {0: x})(yj))
    assert tc.to_functor(_residual_t) is _residual_t


def _analytic_pair():
    def jac_t(x, y):
        z = torch.zeros_like(x[0:1])
        Jx = torch.stack([
            torch.cat([y[0:1], z, z]), torch.cat([z, y[0:1], z]),
            torch.cat([z, z, torch.cos(x[2:3])]),
        ])
        Jy = torch.stack([torch.cat([x[0:1], z]), torch.cat([x[1:2], z]),
                          torch.cat([z, torch.ones_like(z)])])
        return Jx, Jy

    def jac_j(x, y):
        Jx = jnp.array([[y[0], 0.0, 0.0], [0.0, y[0], 0.0], [0.0, 0.0, jnp.cos(x[2])]])
        Jy = jnp.array([[x[0], 0.0], [x[1], 0.0], [0.0, 1.0]])
        return Jx, Jy

    return tc.analytic_cost(_residual_t, jac_t), jc.analytic_cost(_residual_j, jac_j), jac_t


def test_analytic_cost_under_vmap_jacfwd():
    """The hand-written Jacobian is what vmap(jacfwd) returns, batched, for
    every argument, and equals both JAX's and autodiff's."""
    ft, fj, _ = _analytic_pair()
    X, Y = RNG.standard_normal((7, 3)), RNG.standard_normal((7, 2))
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    _close(vmap(ft)(Xt, Yt), jax.vmap(fj)(jnp.asarray(X), jnp.asarray(Y)))
    Jt = vmap(jacfwd(ft, argnums=(0, 1)))(Xt, Yt)
    Jj = jax.vmap(jax.jacfwd(fj, argnums=(0, 1)))(jnp.asarray(X), jnp.asarray(Y))
    Ja = vmap(jacfwd(_residual_t, argnums=(0, 1)))(Xt, Yt)
    for t, j, a in zip(Jt, Jj, Ja):
        _close(t, j)
        _close(t, a)


def test_analytic_cost_uses_the_given_jacobian_and_none_means_zero():
    """A deliberately wrong Jacobian comes back as given (the rule is used,
    not autodiff); None gives a zero block."""
    def wrong(x, y):
        return 3.0 * torch.ones((3, 3), dtype=x.dtype), None

    f = tc.analytic_cost(_residual_t, wrong)
    x, y = torch.from_numpy(RNG.standard_normal(3)), torch.from_numpy(RNG.standard_normal(2))
    Jx, Jy = jacfwd(f, argnums=(0, 1))(x, y)
    assert torch.equal(Jx, 3.0 * torch.ones((3, 3), dtype=torch.float64))
    assert torch.equal(Jy, torch.zeros((3, 2), dtype=torch.float64))
    bad = tc.analytic_cost(_residual_t, lambda x, y: (torch.eye(3),))
    with pytest.raises(ValueError, match="Jacobians"):
        jacfwd(bad, argnums=(0, 1))(x, y)


def test_analytic_cost_in_a_solve():
    """Through the port's evaluator: a curve fit with an analytic Jacobian
    reaches the same cost as the autodiff one."""
    import ceres_tpu_torch as ctt

    t = np.linspace(0, 1, 30)
    obs = 2.0 * np.exp(-1.5 * t) + 0.01 * RNG.standard_normal(30)

    def res(p, d):
        return p[0:1] * torch.exp(p[1:2] * d[0:1]) - d[1:2]

    def jac(p, d):
        e = torch.exp(p[1:2] * d[0:1])
        return torch.cat([e, p[0:1] * d[0:1] * e]).reshape(1, 2), None

    costs = []
    for fn in (res, tc.analytic_cost(res, jac)):
        problem = ctt.Problem()
        pid = problem.add_parameter_block(np.array([1.0, -1.0]))
        problem.add_residual_blocks(
            fn, None, [np.full(30, pid)], data=np.stack([t, obs], axis=1)
        )
        s = ctt.solve(ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.DENSE_QR),
                      problem, device="cpu")
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        costs.append(s.final_cost)
    np.testing.assert_allclose(costs[1], costs[0], rtol=1e-10)
