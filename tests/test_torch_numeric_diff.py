"""numeric_diff of the port against ceres_tpu's: the same seeded inputs
through both packages' finite-difference rules, under jacfwd and under the
evaluator's vmap(jacfwd), and a small BAL solve whose Jacobians come from
them.

Tolerances: a finite difference divides rounding differences of f (torch's
and XLA's exp, sin, ... may differ by an ulp) by the step, 1e-6 of x for
CENTRAL, so Jacobians are held to 1e-8 of their largest entry. f32
Jacobians stay f32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt

jnd = importlib.import_module("ceres_tpu.numeric_diff")
tnd = importlib.import_module("ceres_tpu_torch.numeric_diff")
METHODS = ["FORWARD", "CENTRAL", "RIDDERS"]
FEW_RIDDERS = dict(max_num_ridders_extrapolations=4)  # a short tableau: fast JAX compiles


def jax_f(x, y):
    return jnp.stack([jnp.sin(x[0]) * y[1], x[1] ** 3 + jnp.exp(y[0] * x[0]), x[0] * x[1] * y[1]])


def torch_f(x, y):
    return torch.cat([torch.sin(x[0:1]) * y[1:2], x[1:2] ** 3 + torch.exp(y[0:1] * x[0:1]),
                      x[0:1] * x[1:2] * y[1:2]])


def _inputs(B=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2,) if B is None else (B, 2)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _close(a, b, rel=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rel * max(np.max(np.abs(a)), 1e-300)


@pytest.mark.parametrize("method", METHODS)
def test_jacobian_matches_jax(method):
    x, y = _inputs()
    jo, to = jnd.NumericDiffOptions(**FEW_RIDDERS), tnd.NumericDiffOptions(**FEW_RIDDERS)
    J = jax.jacfwd(jnd.numeric_diff(jax_f, method, jo), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    T = torch.func.jacfwd(tnd.numeric_diff(torch_f, method, to), argnums=(0, 1))(
        torch.tensor(x), torch.tensor(y))
    for a, b in zip(J, T):
        _close(a, b.numpy())


@pytest.mark.parametrize("method", METHODS)
def test_batched_jacobian_matches_jax(method):
    """Under vmap(jacfwd), as the evaluator calls it: every lane gets one
    basis direction and its own step."""
    x, y = _inputs(B=7, seed=1)
    jo, to = jnd.NumericDiffOptions(**FEW_RIDDERS), tnd.NumericDiffOptions(**FEW_RIDDERS)
    J = jax.vmap(jax.jacfwd(jnd.numeric_diff(jax_f, method, jo), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    T = torch.func.vmap(torch.func.jacfwd(tnd.numeric_diff(torch_f, method, to), argnums=(0, 1)))(
        torch.tensor(x), torch.tensor(y))
    for a, b in zip(J, T):
        _close(a, b.numpy())


def test_values_and_a_direction_match_jax():
    """The primal is the function's own, and a jvp along a non-basis
    direction normalises it and steps over the coordinates it moves."""
    x, y = _inputs(seed=2)
    v = np.array([0.3, -2.0])
    jy, jt = jax.jvp(lambda a: jnd.numeric_diff(jax_f)(a, jnp.asarray(y)), (jnp.asarray(x),),
                     (jnp.asarray(v),))
    ty, tt = torch.func.jvp(lambda a: tnd.numeric_diff(torch_f)(a, torch.tensor(y)),
                            (torch.tensor(x),), (torch.tensor(v),))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    _close(jt, tt.numpy())


def test_data_tuple_is_constant():
    """A trailing data tuple gets no tangent: only the blocks move."""
    def f(a, data):
        return torch.cat([a[0:1] * data[0][0:1], a[1:2] * torch.exp(data[1][0:1])])

    x, y = _inputs(B=4, seed=3)
    data = (torch.tensor(y), torch.tensor(x))
    J = torch.func.vmap(torch.func.jacfwd(tnd.numeric_diff(f)))(torch.tensor(x), data)
    exact = torch.func.vmap(torch.func.jacfwd(f))(torch.tensor(x), data)
    _close(J.numpy(), exact.numpy(), rel=1e-8)


def test_float32_jacobian_stays_float32():
    x, y = _inputs(B=3)
    opts = tnd.NumericDiffOptions(relative_step_size=1e-3)
    J = torch.func.vmap(torch.func.jacfwd(tnd.numeric_diff(torch_f, "CENTRAL", opts)))(
        torch.tensor(x, dtype=torch.float32), torch.tensor(y, dtype=torch.float32))
    assert J.dtype == torch.float32


def test_numeric_diff_jacobian_and_gradient_match_jax():
    def jr(z):
        return (1.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2

    def tr(z):
        return ((1.0 - z[0:1]) ** 2 + 100.0 * (z[1:2] - z[0:1] ** 2) ** 2).reshape(())

    x = np.array([-1.2, 1.0])
    g = jnd.numeric_diff_gradient(jr)(jnp.asarray(x))
    _close(g, tnd.numeric_diff_gradient(tr)(torch.tensor(x)).numpy())
    J = jnd.numeric_diff_jacobian(lambda z: jnp.stack([jr(z), z[0] * z[1]]), jnp.asarray(x))
    T = ctt.numeric_diff_jacobian(lambda z: torch.stack([tr(z), z[0] * z[1]]), torch.tensor(x))
    _close(J, T.numpy())


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        ctt.numeric_diff(torch_f, "BACKWARD")
