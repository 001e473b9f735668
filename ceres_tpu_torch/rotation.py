"""Rotation toolbox: conversions between angle-axis, quaternion, matrix,
Euler (port of ``ceres_tpu/rotation.py``; the reference's
``include/ceres/rotation.h:1-861``).

Every routine is a torch function written without branches and with safe
denominators, so it is differentiable and ``vmap``-able.

Conventions match Ceres: quaternions are [w, x, y, z] (scalar first, unit
norm for "unit" variants), angle-axis vectors encode axis * angle in
radians, rotation matrices are 3x3 with ``R @ p`` rotating ``p``, Euler
angles are in degrees with R = R_z(e0) R_y(e1) R_x(e2).
"""

from __future__ import annotations

import math

import torch

_SMALL = 1e-24


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product (rotation.h CrossProduct)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1, keepdim=True)


def angle_axis_to_quaternion(angle_axis: torch.Tensor) -> torch.Tensor:
    """rotation.h AngleAxisToQuaternion."""
    theta_sq = _sumsq(angle_axis)
    small = theta_sq < _SMALL
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    half = 0.5 * theta
    # k = sin(theta/2)/theta; Taylor 0.5 - theta^2/48 near zero.
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * angle_axis], dim=-1)


def quaternion_to_angle_axis(quaternion: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionToAngleAxis."""
    q = quaternion
    sin_sq = _sumsq(q[..., 1:])
    small = sin_sq < _SMALL
    sin_theta = torch.sqrt(torch.where(small, 1.0, sin_sq))
    cos_theta = q[..., 0:1]
    # Angle in [-pi, pi): flip both arguments when cos < 0 (rotation.h:489-506).
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k = torch.where(small, 2.0, two_theta / sin_theta)
    return k * q[..., 1:]


def _matrix(rows) -> torch.Tensor:
    """3x3 (batched) matrix from three triples of entries."""
    return torch.stack([torch.stack(list(r), dim=-1) for r in rows], dim=-2)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionToScaledRotation normalized (QuaternionToRotation)."""
    q = q / torch.sqrt(_sumsq(q))
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, ab, ac, ad = a * a, a * b, a * c, a * d
    bb, bc, bd = b * b, b * c, b * d
    cc, cd = c * c, c * d
    dd = d * d
    return _matrix(
        [
            (aa + bb - cc - dd, 2 * (bc - ad), 2 * (ac + bd)),
            (2 * (ad + bc), aa - bb + cc - dd, 2 * (cd - ab)),
            (2 * (bd - ac), 2 * (ab + cd), aa - bb - cc + dd),
        ]
    )


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """rotation.h RotationMatrixToQuaternion: Shepperd's method without
    branches, the quaternion of all four pivots with the numerically best
    (largest pivot) selected."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = r00 + r11 + r22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    t0 = safe_sqrt(1.0 + trace)  # trace pivot
    q0 = torch.stack(
        [0.5 * t0, 0.5 * (r21 - r12) / t0, 0.5 * (r02 - r20) / t0, 0.5 * (r10 - r01) / t0],
        dim=-1,
    )
    t1 = safe_sqrt(1.0 + r00 - r11 - r22)  # r00 pivot
    q1 = torch.stack(
        [0.5 * (r21 - r12) / t1, 0.5 * t1, 0.5 * (r01 + r10) / t1, 0.5 * (r02 + r20) / t1],
        dim=-1,
    )
    t2 = safe_sqrt(1.0 - r00 + r11 - r22)  # r11 pivot
    q2 = torch.stack(
        [0.5 * (r02 - r20) / t2, 0.5 * (r01 + r10) / t2, 0.5 * t2, 0.5 * (r12 + r21) / t2],
        dim=-1,
    )
    t3 = safe_sqrt(1.0 - r00 - r11 + r22)  # r22 pivot
    q3 = torch.stack(
        [0.5 * (r10 - r01) / t3, 0.5 * (r02 + r20) / t3, 0.5 * (r12 + r21) / t3, 0.5 * t3],
        dim=-1,
    )
    pivots = torch.stack([trace, r00, r11, r22], dim=-1)
    case = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(case == 0, q0, torch.where(case == 1, q1, torch.where(case == 2, q2, q3)))
    # Canonical sign: w >= 0.
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def angle_axis_to_rotation_matrix(angle_axis: torch.Tensor) -> torch.Tensor:
    """rotation.h AngleAxisToRotationMatrix (Rodrigues)."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1)
    small = theta_sq < _SMALL
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    axis = angle_axis / theta[..., None]
    wx, wy, wz = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(theta)
    s = torch.sin(theta)
    one_c = 1.0 - c
    R_full = _matrix(
        [
            (c + wx * wx * one_c, wx * wy * one_c - wz * s, wy * s + wx * wz * one_c),
            (wz * s + wx * wy * one_c, c + wy * wy * one_c, -wx * s + wy * wz * one_c),
            (-wy * s + wx * wz * one_c, wx * s + wy * wz * one_c, c + wz * wz * one_c),
        ]
    )
    # Near zero: R = I + skew(angle_axis) (rotation.h:417-430).
    ax, ay, az = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    one = torch.ones_like(ax)
    R_small = _matrix([(one, -az, ay), (az, one, -ax), (-ay, ax, one)])
    return torch.where(small[..., None, None], R_small, R_full)


def rotation_matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """rotation.h RotationMatrixToAngleAxis (via quaternion)."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


def euler_angles_to_rotation_matrix(euler_deg: torch.Tensor) -> torch.Tensor:
    """rotation.h EulerAnglesToRotationMatrix: degrees, R = Rz(e0) Ry(e1) Rx(e2)."""
    rad = euler_deg * (math.pi / 180.0)
    c1, c2, c3 = torch.cos(rad[..., 0]), torch.cos(rad[..., 1]), torch.cos(rad[..., 2])
    s1, s2, s3 = torch.sin(rad[..., 0]), torch.sin(rad[..., 1]), torch.sin(rad[..., 2])
    return _matrix(
        [
            (c1 * c2, -s1 * c3 + c1 * s2 * s3, s1 * s3 + c1 * s2 * c3),
            (s1 * c2, c1 * c3 + s1 * s2 * s3, -c1 * s3 + s1 * s2 * c3),
            (-s2, c2 * s3, c2 * c3),
        ]
    )


def quaternion_product(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionProduct, [w, x, y, z] order."""
    return torch.stack(
        [
            z[..., 0] * w[..., 0] - z[..., 1] * w[..., 1] - z[..., 2] * w[..., 2] - z[..., 3] * w[..., 3],
            z[..., 0] * w[..., 1] + z[..., 1] * w[..., 0] + z[..., 2] * w[..., 3] - z[..., 3] * w[..., 2],
            z[..., 0] * w[..., 2] - z[..., 1] * w[..., 3] + z[..., 2] * w[..., 0] + z[..., 3] * w[..., 1],
            z[..., 0] * w[..., 3] + z[..., 1] * w[..., 2] - z[..., 2] * w[..., 1] + z[..., 3] * w[..., 0],
        ],
        dim=-1,
    )


def unit_quaternion_rotate_point(q: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """rotation.h UnitQuaternionRotatePoint: p' = p + 2 q0 (v x p) + 2 v x (v x p)."""
    v = q[..., 1:]
    t = 2.0 * cross(v, pt)
    return pt + q[..., 0:1] * t + cross(v, t)


def quaternion_rotate_point(q: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionRotatePoint: normalizes first."""
    return unit_quaternion_rotate_point(q / torch.sqrt(_sumsq(q)), pt)


def angle_axis_rotate_point(
    angle_axis: torch.Tensor, pt: torch.Tensor
) -> torch.Tensor:
    """rotation.h AngleAxisRotatePoint (Rodrigues, safe at theta = 0)."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1, keepdim=True)
    small = theta_sq < _SMALL
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    w = angle_axis / theta
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    w_cross_pt = cross(w, pt)
    w_dot_pt = torch.sum(w * pt, dim=-1, keepdim=True)
    full = pt * cos_t + w_cross_pt * sin_t + w * (w_dot_pt * (1.0 - cos_t))
    # Near zero: p + aa x p, first-order exact and differentiable
    # (rotation.h:598-622).
    near = pt + cross(angle_axis, pt)
    return torch.where(small, near, full)


def rotate_point(R: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """R @ p for batched R."""
    return torch.einsum("...ij,...j->...i", R, pt)


# ---------------------------------------------------------------------------
# Generalized Euler angle conventions (include/ceres/rotation.h:167-216,
# internal/euler_angles.h): all 24 Shoemake conventions via sequence
# strings like "ZYX" (Tait-Bryan) or "ZXZ" (proper Euler), intrinsic or
# extrinsic.
# ---------------------------------------------------------------------------

_AXIS = {"X": 0, "Y": 1, "Z": 2}


def _axis_rotation(axis: int, theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    i = (axis + 1) % 3
    j = (axis + 2) % 3
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    entries = [[zero] * 3 for _ in range(3)]
    entries[axis][axis] = one
    entries[i][i] = entries[j][j] = c
    entries[i][j] = -s
    entries[j][i] = s
    return _matrix(entries)


def euler_to_rotation(angles, seq: str = "ZYX", intrinsic: bool = True):
    """R from three rotation angles about the axes named in ``seq``
    (EulerAnglesToRotation, rotation.h:167). Intrinsic: body-frame
    composition R = R1 R2 R3; extrinsic: world-frame, R = R3 R2 R1."""
    seq = seq.upper()
    if len(seq) != 3 or any(c not in _AXIS for c in seq):
        raise ValueError(f"bad Euler sequence {seq!r}")
    if seq[0] == seq[1] or seq[1] == seq[2]:
        raise ValueError(f"consecutive repeated axis in {seq!r}")
    angles = torch.as_tensor(angles)
    if not angles.is_floating_point():
        angles = angles.to(torch.float64)
    Rs = [_axis_rotation(_AXIS[c], angles[n]) for n, c in enumerate(seq)]
    if intrinsic:
        return Rs[0] @ Rs[1] @ Rs[2]
    return Rs[2] @ Rs[1] @ Rs[0]


def rotation_to_euler(R, seq: str = "ZYX", intrinsic: bool = True):
    """Inverse of euler_to_rotation (RotationMatrixToEulerAngles,
    rotation.h:199): supports all 12 intrinsic and 12 extrinsic
    conventions. Returns angles in the middle-angle principal range."""
    seq = seq.upper()
    if not intrinsic:
        # extrinsic (i,j,k) with angles (a,b,c) == intrinsic (k,j,i)
        # with angles (c,b,a)
        a3, a2, a1 = rotation_to_euler(R, seq[::-1], intrinsic=True)
        return torch.stack([a1, a2, a3])
    i, j, k = (_AXIS[c] for c in seq)
    # Gimbal lock (both branches): at the singular middle angle only
    # a +/- c is observable; the convention (Eigen's eulerAngles and
    # rotation.h:199's principal ranges) is c = 0 with the whole residual
    # rotation folded into a.
    i1, i2 = (i + 1) % 3, (i + 2) % 3
    zero = torch.zeros_like(R[0, 0])
    if i == k:  # proper Euler (i, j, i); singular at b = 0, pi
        l = 3 - i - j
        e = 1.0 if (j - i) % 3 == 1 else -1.0
        cb = torch.clamp(R[i, i], -1.0, 1.0)
        b = torch.acos(cb)
        a = torch.atan2(R[j, i], -e * R[l, i])
        c = torch.atan2(R[i, j], e * R[i, l])
        degenerate = torch.abs(cb) > 1.0 - 1e-10
        # b ~ 0: R = R_i(a + c);  b ~ pi: R_i(a) = R @ R_j(pi).
        M_pi = R @ _axis_rotation(j, zero + math.pi)
        a_deg = torch.where(
            cb > 0.0,
            torch.atan2(R[i2, i1], R[i1, i1]),
            torch.atan2(M_pi[i2, i1], M_pi[i1, i1]),
        )
    else:  # Tait-Bryan (i, j, k) all distinct; singular at b = +/- pi/2
        e = 1.0 if (j - i) % 3 == 1 else -1.0
        sb = torch.clamp(e * R[i, k], -1.0, 1.0)
        b = torch.asin(sb)
        a = torch.atan2(-e * R[j, k], R[k, k])
        c = torch.atan2(-e * R[i, j], R[i, i])
        degenerate = torch.abs(sb) > 1.0 - 1e-10
        # c = 0: R_i(a) = R @ R_j(-b) with b = +/- pi/2.
        M_p = R @ _axis_rotation(j, zero - math.pi / 2)
        M_m = R @ _axis_rotation(j, zero + math.pi / 2)
        a_deg = torch.where(
            sb > 0.0,
            torch.atan2(M_p[i2, i1], M_p[i1, i1]),
            torch.atan2(M_m[i2, i1], M_m[i1, i1]),
        )
    a = torch.where(degenerate, a_deg, a)
    c = torch.where(degenerate, zero, c)
    return torch.stack([a, b, c])
