"""Rotation toolbox parity: every function of ceres_tpu_torch.rotation
against ceres_tpu.rotation on random and near-singular inputs (float64,
rtol 1e-12 with an absolute floor of 1e-12), single and batched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu import rotation as jr
from ceres_tpu_torch import rotation as tr

RNG = np.random.default_rng(21)


def _close(t, j, tol=1e-12):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def _angle_axes():
    aa = RNG.standard_normal((40, 3)) * RNG.uniform(0.01, 3.0, (40, 1))
    aa[0] = 0.0
    aa[1] = 1e-14
    return aa


def _quats():
    q = RNG.standard_normal((40, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [-0.5, 0.5, 0.5, 0.5]
    return q


def _matrices():
    return np.asarray(jr.angle_axis_to_rotation_matrix(jnp.asarray(_angle_axes())))


ONE_ARG = {
    "angle_axis_to_quaternion": _angle_axes,
    "quaternion_to_angle_axis": _quats,
    "quaternion_to_rotation_matrix": lambda: _quats() * 1.7,
    "rotation_matrix_to_quaternion": _matrices,
    "angle_axis_to_rotation_matrix": _angle_axes,
    "rotation_matrix_to_angle_axis": _matrices,
    "euler_angles_to_rotation_matrix": lambda: RNG.uniform(-180, 180, (40, 3)),
}


@pytest.mark.parametrize("name", ONE_ARG)
def test_conversion_matches_jax(name):
    x = ONE_ARG[name]()
    _close(getattr(tr, name)(torch.from_numpy(x)), getattr(jr, name)(jnp.asarray(x)))
    _close(getattr(tr, name)(torch.from_numpy(x[3])), getattr(jr, name)(jnp.asarray(x[3])))


TWO_ARG = {
    "cross": (lambda: RNG.standard_normal((40, 3)), lambda: RNG.standard_normal((40, 3))),
    "quaternion_product": (_quats, _quats),
    "unit_quaternion_rotate_point": (_quats, lambda: RNG.standard_normal((40, 3))),
    "quaternion_rotate_point": (lambda: 3.0 * _quats(), lambda: RNG.standard_normal((40, 3))),
    "angle_axis_rotate_point": (_angle_axes, lambda: RNG.standard_normal((40, 3))),
    "rotate_point": (_matrices, lambda: RNG.standard_normal((40, 3))),
}


@pytest.mark.parametrize("name", TWO_ARG)
def test_two_argument_function_matches_jax(name):
    a, b = (make() for make in TWO_ARG[name])
    _close(getattr(tr, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jr, name)(jnp.asarray(a), jnp.asarray(b)))


SEQUENCES = ["ZYX", "XYZ", "YZX", "ZXZ", "XYX", "YXY"]


@pytest.mark.parametrize("intrinsic", [True, False], ids=["intrinsic", "extrinsic"])
@pytest.mark.parametrize("seq", SEQUENCES)
def test_generalized_euler_matches_jax_and_round_trips(seq, intrinsic):
    angles = np.array([0.4, -0.7, 1.1]) if seq[0] != seq[2] else np.array([0.4, 0.9, -1.1])
    Rt = tr.euler_to_rotation(torch.from_numpy(angles), seq, intrinsic)
    _close(Rt, jr.euler_to_rotation(jnp.asarray(angles), seq, intrinsic))
    back = tr.rotation_to_euler(Rt, seq, intrinsic)
    _close(back, jr.rotation_to_euler(jnp.asarray(Rt.numpy()), seq, intrinsic), 1e-10)
    np.testing.assert_allclose(back.numpy(), angles, atol=1e-10)


@pytest.mark.parametrize("seq,angles", [("ZYX", [0.3, np.pi / 2, 0.0]), ("ZXZ", [0.3, 0.0, 0.0])])
def test_gimbal_lock_matches_jax(seq, angles):
    R = np.asarray(jr.euler_to_rotation(jnp.asarray(angles), seq, True))
    _close(tr.rotation_to_euler(torch.from_numpy(R), seq, True),
           jr.rotation_to_euler(jnp.asarray(R), seq, True), 1e-7)


def test_bad_euler_sequence_raises():
    with pytest.raises(ValueError):
        tr.euler_to_rotation(torch.zeros(3), "ZZX")
    with pytest.raises(ValueError):
        tr.euler_to_rotation(torch.zeros(3), "AB")
