"""Cubic interpolation of the port against ceres_tpu's: the same seeded
grids and points through both packages' splines, grids (edge clamping
included) and interpolators, derivatives through ``floor(x)`` indexing of
dual, batched tensors inside vmap(jacfwd), and the translation recovery of
examples/bicubic_interpolation.py as a solve.

Tolerances: values and derivatives rtol 1e-12 (the same polynomial in the
same order), solve records rtol 1e-10; f32 Jacobians stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu import interpolation as jint
from ceres_tpu_torch import interpolation as tint


def _grid1d(seed=0, n=20, dim=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if dim is None else (n, dim))


@pytest.mark.parametrize("dim", [None, 3])
def test_cubic_interpolator_matches_jax(dim):
    """f and df/dx on and between the samples and outside the grid (the
    edge samples), scalar and vector samples."""
    data = _grid1d(dim=dim)
    xs = np.linspace(-6.0, 25.0, 63)
    j = jax.vmap(jint.CubicInterpolator(jint.Grid1D(data, begin=-2)).evaluate)(jnp.asarray(xs))
    t = torch.func.vmap(tint.CubicInterpolator(tint.Grid1D(data, begin=-2)).evaluate)(
        torch.tensor(xs))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)


def test_spline_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((4, 5))
    x = rng.uniform(0.0, 1.0, 5)
    j = jint.cubic_hermite_spline(*map(jnp.asarray, p), jnp.asarray(x))
    t = tint.cubic_hermite_spline(*map(torch.tensor, p), torch.tensor(x))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13)


@pytest.mark.parametrize("dim", [None, 2])
def test_bicubic_interpolator_matches_jax(dim):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((9, 11) if dim is None else (9, 11, dim))
    pts = rng.uniform(-3.0, 13.0, (40, 2))
    j = jax.vmap(lambda q: jint.BiCubicInterpolator(jint.Grid2D(data, -1, 2)).evaluate(q[0], q[1]))(
        jnp.asarray(pts))
    ti = tint.BiCubicInterpolator(tint.Grid2D(data, -1, 2))
    t = torch.func.vmap(lambda q: ti.evaluate(q[0], q[1]))(torch.tensor(pts))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)


def test_derivative_flows_through_the_fraction_only():
    """jacfwd through floor-indexed, batched points equals the spline's own
    df/dr, df/dc, as JAX's does (1-element slices, vmap over points)."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal((12, 12))
    ti = tint.BiCubicInterpolator(tint.Grid2D(data))
    pts = torch.tensor(rng.uniform(1.0, 10.0, (16, 2)))
    J = torch.func.vmap(torch.func.jacfwd(lambda q: ti.evaluate(q[0:1], q[1:2])[0].reshape(-1)))(pts)
    _, dfdr, dfdc = torch.func.vmap(lambda q: ti.evaluate(q[0:1], q[1:2]))(pts)
    np.testing.assert_allclose(J[:, 0, 0].numpy(), dfdr.reshape(-1).numpy(), rtol=1e-12)
    np.testing.assert_allclose(J[:, 0, 1].numpy(), dfdc.reshape(-1).numpy(), rtol=1e-12)
    ji = jint.BiCubicInterpolator(jint.Grid2D(data))
    JJ = jax.vmap(jax.jacfwd(lambda q: ji.evaluate(q[0], q[1])[0]))(jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(J.numpy(), np.asarray(JJ), rtol=1e-12, atol=1e-13)


def test_float32_jacobian_stays_float32():
    ti = tint.CubicInterpolator(tint.Grid1D(_grid1d()))
    x = torch.tensor([[2.5], [7.25]], dtype=torch.float32)
    J = torch.func.vmap(torch.func.jacfwd(lambda z: ti.evaluate(z)[0].reshape(-1)))(x)
    assert J.dtype == torch.float32


def test_values_without_a_point_are_float64():
    g = tint.Grid2D(np.arange(12.0).reshape(3, 4))
    v = g.value(torch.tensor([0, 5]), torch.tensor([1, -1]))
    assert v.dtype == torch.float64
    np.testing.assert_array_equal(v.numpy().reshape(-1), [1.0, 8.0])


def test_bicubic_translation_recovery_matches_jax():
    """examples/bicubic_interpolation.py's problem, small: JAX's records."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import interpolation_references

    j = interpolation_references(ct, grid=24, samples=60)
    t = interpolation_references(ctt, grid=24, samples=60)
    assert len(t[0]) == len(j[0]) > 2 and t[3] == j[3] == "CONVERGENCE"
    np.testing.assert_allclose([r[0] for r in t[0]], [r[0] for r in j[0]], rtol=1e-10)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-10)
    np.testing.assert_allclose(t[2], [1.3, -0.7], atol=1e-2)
