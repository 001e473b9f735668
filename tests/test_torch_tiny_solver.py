"""tiny_solve of the port against ceres_tpu's vmap(tiny_solve): the same
seeded starts through both, one problem and batches whose lanes finish at
different iterations, with a lane whose damped normal matrix is not
positive definite (the JAX package's Cholesky gives NaN and rejects the
step; the port's cholesky_ex reports it and rejects the same way).

Tolerances: iterations and status equal lane by lane; x and costs rtol
1e-10 (atol 1e-12 near 0).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import tiny_solver as ts

jts = importlib.import_module("ceres_tpu.tiny_solver")


def jax_rosenbrock(x):
    return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def torch_rosenbrock(x):
    return torch.cat([10.0 * (x[1:2] - x[0:1] ** 2), 1.0 - x[0:1]])


def _compare(j, t):
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    for name in ("x", "cost", "initial_cost", "gradient_max_norm"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_one_problem_matches_jax():
    x0 = np.array([-1.2, 1.0])
    j = jts.tiny_solve(jax_rosenbrock, jnp.asarray(x0))
    t = ts.tiny_solve(torch_rosenbrock, x0, device="cpu")
    assert t.x.shape == (2,) and int(t.converged) == int(j.converged) == 2
    _compare(j, t)


def test_batch_lanes_finish_at_different_iterations():
    x0 = np.array([-1.2, 1.0]) + 0.8 * np.random.default_rng(0).standard_normal((48, 2))
    j = jax.vmap(lambda z: jts.tiny_solve(jax_rosenbrock, z))(jnp.asarray(x0))
    t = ts.tiny_solve(torch_rosenbrock, torch.tensor(x0), device="cpu")
    assert len(set(t.iterations.tolist())) > 5  # lanes end at many different iterations
    _compare(j, t)


def test_mixed_batch_matches_jax():
    """chip_smoke.tiny_batch's two problem kinds in one batch."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import tiny_references

    (jx, ji, jc, jcost), jsum, _ = tiny_references(__import__("ceres_tpu"), problems=64)
    (tx, ti, tc, tcost), tsum, _ = tiny_references(ctt, problems=64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tx, jx, rtol=1e-10, atol=1e-12)
    assert {k: tsum[k] for k in ("iterations_by_lane", "status_by_lane")} == \
        {k: jsum[k] for k in ("iterations_by_lane", "status_by_lane")}


def jax_flat(x):  # zero Jacobian at x = 0: J'J + u I with u = 0 is singular
    return jnp.stack([x[0] ** 2 - 1.0, x[1] ** 2 + 0.5])


def torch_flat(x):
    return torch.cat([x[0:1] ** 2 - 1.0, x[1:2] ** 2 + 0.5])


def test_non_spd_step_is_rejected_like_jax():
    """A lane that starts where J = 0 has u = 0 and a singular J'J + uI:
    every step fails to factor and is rejected, x stays, the lane runs to
    the iteration limit (the gradient test is switched off), while the other
    lanes of the batch converge as usual."""
    x0 = np.array([[0.0, 0.0], [0.7, 0.3], [2.0, -1.0]])
    kw = dict(max_num_iterations=12, gradient_tolerance=-1.0)
    j = jax.vmap(lambda z: jts.tiny_solve(jax_flat, z, 12, -1.0))(jnp.asarray(x0))
    t = ts.tiny_solve(torch_flat, x0, device="cpu", **kw)
    assert int(t.iterations[0]) == 12 and int(t.converged[0]) == 0
    np.testing.assert_array_equal(t.x[0].numpy(), x0[0])
    _compare(j, t)


def test_tiny_solver_class_matches_jax():
    j = jts.TinySolver(max_num_iterations=5).solve(jax_rosenbrock, [-1.2, 1.0])
    t = ctt.TinySolver(max_num_iterations=5).solve(torch_rosenbrock, [-1.2, 1.0], device="cpu")
    assert int(t.iterations) == 5
    _compare(j, t)


def test_float32_batch():
    x0 = np.array([[-1.2, 1.0], [0.5, 0.5]], dtype=np.float32)
    t = ts.tiny_solve(torch_rosenbrock, torch.from_numpy(x0), device="cpu")
    assert t.x.dtype == torch.float32
    np.testing.assert_allclose(t.x.numpy(), 1.0, atol=1e-3)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        ts.tiny_solve(torch_rosenbrock, np.array([-1.2, 1.0]))
