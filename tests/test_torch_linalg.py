"""Small dense linear algebra and PCG: ceres_tpu_torch.ops.small_linalg and
ceres_tpu_torch.linear.cg against ceres_tpu's, f64, rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.linear.cg import conjugate_gradients as jax_cg
from ceres_tpu.ops.small_linalg import spd_inverse as jax_spd_inverse
from ceres_tpu.linear.cg import direct_termination as jax_direct_termination
from ceres_tpu_torch.linear.cg import CG_FAILURE, conjugate_gradients, direct_termination
from ceres_tpu_torch.ops.small_linalg import spd_inverse, spd_solve


def _spd(rng, batch, n):
    a = rng.standard_normal((batch, n, n))
    return a @ np.swapaxes(a, 1, 2) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 2, 3, 9])
def test_spd_inverse_matches_jax(n):
    m = _spd(np.random.default_rng(n), 20, n)
    out = spd_inverse(torch.tensor(m)).numpy()
    ref = np.asarray(jax_spd_inverse(jnp.asarray(m)))
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    b = np.random.default_rng(0).standard_normal((20, n))
    x = spd_solve(torch.tensor(out), torch.tensor(b)).numpy()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", m, x), b, atol=1e-10)


SPD_INVERSE_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", range(4, 13))
def test_spd_inverse_by_cholesky_matches_jax(n, dtype):
    """Above n = 3 the port's inverse is a batched Cholesky and two
    triangular solves, the JAX package's an unrolled Cholesky and L^-T L^-1:
    held to each other relative to the largest entry."""
    m = _spd(np.random.default_rng(n), 20, n).astype(dtype)
    out = spd_inverse(torch.tensor(m)).numpy()
    ref = np.asarray(jax_spd_inverse(jnp.asarray(m)))
    assert out.dtype == ref.dtype == dtype
    np.testing.assert_allclose(out, ref, rtol=0, atol=SPD_INVERSE_RTOL[dtype] * np.abs(ref).max())


def test_spd_inverse_marks_non_spd_blocks_nan():
    m = _spd(np.random.default_rng(1), 3, 9)
    m[1] = -m[1]
    out = spd_inverse(torch.tensor(m)).numpy()
    assert np.isnan(out[1]).all() and np.isfinite(out[[0, 2]]).all()
    assert not np.isfinite(np.asarray(jax_spd_inverse(jnp.asarray(m)))[1]).all()


@pytest.mark.parametrize(
    "q_tol,r_tol,max_iters", [(0.1, -1.0, 500), (0.0, 1e-9, 500), (0.0, -1.0, 7)]
)
def test_cg_matches_jax(q_tol, r_tol, max_iters):
    rng = np.random.default_rng(2)
    n = 60
    a = rng.standard_normal((n, n))
    # well conditioned, so both runs stay far from CG's rounding regime,
    # where the summation order of the dot products alone moves the counts
    A = a @ a.T / n + np.diag(rng.uniform(0.5, 2.0, n))
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    out = conjugate_gradients(
        lambda v: torch.tensor(A) @ v, torch.tensor(b),
        preconditioner=lambda v: torch.tensor(dinv) * v,
        max_num_iterations=max_iters, min_num_iterations=0,
        q_tolerance=q_tol, r_tolerance=r_tol,
    )
    ref = jax_cg(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        preconditioner=lambda v: jnp.asarray(dinv) * v,
        max_num_iterations=max_iters, min_num_iterations=0,
        q_tolerance=q_tol, r_tolerance=r_tol,
    )
    assert int(out.num_iterations) == int(ref.num_iterations)
    assert int(out.termination) == int(ref.termination)
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(out.x.numpy(), x_ref, rtol=1e-10,
                               atol=1e-10 * np.abs(x_ref).max())


def test_cg_reports_indefinite_operator_as_failure():
    A = np.diag([1.0, -2.0, 3.0])
    b = np.array([1.0, 1.0, 1.0])
    out = conjugate_gradients(lambda v: torch.tensor(A) @ v, torch.tensor(b),
                              max_num_iterations=10, r_tolerance=1e-12)
    ref = jax_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                 max_num_iterations=10, r_tolerance=1e-12)
    assert int(out.termination) == int(ref.termination) == CG_FAILURE
    assert int(out.num_iterations) == int(ref.num_iterations)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_direct_termination_matches_jax(bad):
    y = np.ones(5)
    if bad is not None:
        y[2] = bad
    assert int(direct_termination(torch.tensor(y))) == int(jax_direct_termination(jnp.asarray(y)))
