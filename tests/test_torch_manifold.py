"""Manifold parity: plus, minus and both Jacobians of every manifold of
ceres_tpu_torch.manifold against ceres_tpu.manifold, at delta = 0 and away
from it (float64, rtol 1e-12 with an absolute floor of 1e-12; the float32
check is on dtypes: a Jacobian taken under vmap(jacfwd) stays float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ceres_tpu import manifold as jm
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch import manifold as tm
from ceres_tpu_torch.interop import manifold_from
from ceres_tpu_torch.models import pose_graph as tpg

EXTRA = {"AngleManifold": tpg.AngleManifold}


def _unit(v):
    return v / np.linalg.norm(v)


def _cases():
    rng = np.random.default_rng(12)
    q = _unit(rng.standard_normal(4))
    return {
        "euclidean": (lambda m, _: m.EuclideanManifold(3), rng.standard_normal(3)),
        "subset": (lambda m, _: m.SubsetManifold(5, [1, 3]), rng.standard_normal(5)),
        "subset_all_free": (lambda m, _: m.SubsetManifold(3, []), rng.standard_normal(3)),
        "quaternion": (lambda m, _: m.QuaternionManifold(), q),
        "eigen_quaternion": (lambda m, _: m.EigenQuaternionManifold(), np.roll(q, -1)),
        "sphere": (lambda m, _: m.SphereManifold(4), 2.5 * _unit(rng.standard_normal(4))),
        "sphere_negative_pivot": (lambda m, _: m.SphereManifold(3), np.array([0.3, -0.2, -1.7])),
        "sphere_on_axis": (lambda m, _: m.SphereManifold(3), np.array([0.0, 0.0, 2.0])),
        "line": (
            lambda m, _: m.LineManifold(3),
            np.concatenate([rng.standard_normal(3), _unit(rng.standard_normal(3))]),
        ),
        "product_euclidean_angle": (
            lambda m, pg: m.ProductManifold(m.EuclideanManifold(2), pg.AngleManifold()),
            np.array([0.4, -1.2, 3.0]),
        ),
        "product_quaternion_sphere": (
            lambda m, _: m.ProductManifold(m.QuaternionManifold(), m.SphereManifold(3)),
            np.concatenate([q, _unit(rng.standard_normal(3))]),
        ),
    }


CASES = _cases()


def _close(t, j, tol=1e-12):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def _deltas(T):
    rng = np.random.default_rng(5)
    return [np.zeros(T), 1e-14 * rng.standard_normal(T), 0.3 * rng.standard_normal(T),
            1.5 * rng.standard_normal(T)]


@pytest.mark.parametrize("name", CASES)
def test_plus_minus_and_jacobians_match_jax(name):
    make, x = CASES[name]
    mj, mt = make(jm, jpg), make(tm, tpg)
    assert (mt.ambient_size, mt.tangent_size) == (mj.ambient_size, mj.tangent_size)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(mt.plus_jacobian(xt), mj.plus_jacobian(xj))
    _close(mt.minus_jacobian(xt), mj.minus_jacobian(xj))
    for d in _deltas(mt.tangent_size):
        yt, yj = mt.plus(xt, torch.from_numpy(d)), mj.plus(xj, jnp.asarray(d))
        _close(yt, yj)
        _close(mt.minus(yt, xt), mj.minus(yj, xj))
        # Jacobian of plus with respect to delta, at this delta: finite at 0
        # (the guarded sqrt and division) and equal to JAX's.
        Jt = jacfwd(lambda v: mt.plus(xt, v))(torch.from_numpy(d))
        Jj = jax.jacfwd(lambda v: mj.plus(xj, v))(jnp.asarray(d))
        assert torch.isfinite(Jt).all()
        _close(Jt, Jj, 1e-10)


@pytest.mark.parametrize("name", [n for n in CASES if "angle" not in n])
def test_minus_inverts_plus(name):
    make, x = CASES[name]
    mt = make(tm, tpg)
    xt = torch.from_numpy(x)
    d = 0.4 * np.random.default_rng(8).standard_normal(mt.tangent_size)
    back = mt.minus(mt.plus(xt, torch.from_numpy(d)), xt)
    np.testing.assert_allclose(back.numpy(), d, rtol=0, atol=1e-12)
    zero = mt.minus(mt.plus(xt, torch.zeros(mt.tangent_size, dtype=torch.float64)), xt)
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=1e-15)


def test_angle_manifold_wraps():
    mt, mj = tpg.AngleManifold(), jpg.AngleManifold()
    for x, d in ((3.0, 0.5), (-3.0, -0.5), (0.1, 0.2)):
        yt = mt.plus(torch.tensor([x], dtype=torch.float64), torch.tensor([d], dtype=torch.float64))
        yj = mj.plus(jnp.asarray([x]), jnp.asarray([d]))
        _close(yt, yj)
        assert -np.pi <= yt.item() < np.pi
        _close(mt.minus(yt, torch.tensor([x], dtype=torch.float64)), mj.minus(yj, jnp.asarray([x])))


@pytest.mark.parametrize("name", CASES)
def test_float32_jacobian_stays_float32_under_vmap(name):
    """The evaluator's use: vmap(jacfwd(plus)) over a batch of blocks at
    delta = 0, in float32."""
    make, x = CASES[name]
    mt, mj = make(tm, tpg), make(jm, jpg)
    xs = torch.tensor(np.stack([x, x]), dtype=torch.float32)
    zeros = torch.zeros((2, mt.tangent_size), dtype=torch.float32)
    J = vmap(lambda b, d: jacfwd(lambda v: mt.plus(b, v))(d))(xs, zeros)
    assert J.dtype == torch.float32 and torch.isfinite(J).all()
    ref = mj.plus_jacobian(jnp.asarray(x))
    np.testing.assert_allclose(J[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_family_key_and_manifold_from(name):
    """Equality and hash make a manifold a family key; manifold_from
    rebuilds the JAX object as the port's."""
    make, _ = CASES[name]
    a, b = make(tm, tpg), make(tm, tpg)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != tm.EuclideanManifold(17)
    rebuilt = manifold_from(make(jm, jpg), EXTRA)
    assert rebuilt == a
    assert manifold_from(None) is None


def test_householder_vector_matches_jax():
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal(4), np.array([0.0, 0.0, -1.5]), np.array([1e-9, 0.0, 2.0])):
        vt, bt = tm.householder_vector(torch.from_numpy(x))
        vj, bj = jm.householder_vector(jnp.asarray(x))
        _close(vt, vj)
        np.testing.assert_allclose(bt.item(), float(bj), rtol=1e-12)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        tm.SubsetManifold(3, [5])
    with pytest.raises(ValueError):
        tm.SphereManifold(1)
    with pytest.raises(ValueError):
        tm.LineManifold(1)
    with pytest.raises(ValueError):
        tm.ProductManifold()
