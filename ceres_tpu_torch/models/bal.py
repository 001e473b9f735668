"""BAL (Bundle Adjustment in the Large) problems (port of
``ceres_tpu/models/bal.py``): BAL text files or synthetic instances of the
same structure, with or without a robust loss.

One residual family: cameras (9 parameters: angle-axis rotation,
translation, focal length, k1, k2), points (3), one 2-D Snavely
reprojection residual per observation (snavely_reprojection_error.h:31-110).
The synthetic generator is host numpy and is copied so that the same seed
gives bit-identical arrays in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.rotation import angle_axis_rotate_point
from ceres_tpu_torch.solver import SolverOptions
from ceres_tpu_torch.types import LinearSolverType, PreconditionerType


def snavely_reprojection_residual(camera, point, observed):
    """2-D reprojection error of one observation
    (snavely_reprojection_error.h:31-85).

    Written on 1-element slices rather than 0-dim scalars: under
    ``vmap(jacfwd)`` a Python float combined with a 0-dim tensor promotes
    the forward-mode tangent to float64, which would take the float32
    Jacobian through f64 arithmetic."""
    p = angle_axis_rotate_point(camera[:3], point) + camera[3:6]
    # BAL convention: the camera looks down -z.
    xp = -p[0:1] / p[2:3]
    yp = -p[1:2] / p[2:3]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (camera[7:8] + camera[8:9] * r2)
    focal = camera[6:7]
    predicted_x = focal * distortion * xp
    predicted_y = focal * distortion * yp
    return torch.cat([predicted_x - observed[0:1], predicted_y - observed[1:2]])


@dataclasses.dataclass
class BALProblem:
    """In-memory BAL instance (examples/bal_problem.h)."""

    cameras: np.ndarray  # (C, 9)
    points: np.ndarray  # (P, 3)
    camera_index: np.ndarray  # (O,)
    point_index: np.ndarray  # (O,)
    observations: np.ndarray  # (O, 2)

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]


def load_bal_file(path) -> BALProblem:
    """Parse the BAL text format (examples/bal_problem.cc ReadFile):
    ``C P O``, then O lines ``camera point x y``, then 9 C camera values and
    3 P point values."""
    with open(path) as f:
        tokens = f.read().split()
    try:
        C, P, O = (int(t) for t in tokens[:3])
    except ValueError:
        raise ValueError(f"{path}: not a BAL file (missing header)") from None
    if len(tokens) < 3:
        raise ValueError(f"{path}: not a BAL file (missing header)")
    if len(tokens) != 3 + 4 * O + 9 * C + 3 * P:
        raise ValueError(
            f"{path}: truncated BAL file: expected "
            f"{3 + 4 * O + 9 * C + 3 * P} tokens, got {len(tokens)}"
        )
    obs_tokens = np.asarray(tokens[3 : 3 + 4 * O]).reshape(O, 4)
    rest = np.asarray(tokens[3 + 4 * O :], dtype=np.float64)
    return BALProblem(
        cameras=rest[: 9 * C].reshape(C, 9),
        points=rest[9 * C :].reshape(P, 3),
        camera_index=obs_tokens[:, 0].astype(np.int64),
        point_index=obs_tokens[:, 1].astype(np.int64),
        observations=obs_tokens[:, 2:].astype(np.float64),
    )


def synthesize_bal(
    num_cameras: int = 16,
    num_points: int = 22106,
    num_observations: int = 83718,
    noise: float = 1.0,
    perturb: float = 0.2,
    seed: int = 0,
) -> BALProblem:
    """Synthetic BAL instance with problem-16-22106's shape: cameras on a
    ring looking at a point cloud, observations = true projections + pixel
    noise, initial state = ground truth perturbed (bal_problem.cc
    Perturb())."""
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((num_points, 3)) * np.array([4.0, 4.0, 1.0])
    # Keep the cloud inside a ball of radius 6 so every point stays well
    # in front of every camera (cameras sit at |pos| ~ 13.4).
    norms = np.linalg.norm(points, axis=1, keepdims=True)
    points *= np.minimum(1.0, 6.0 / np.maximum(norms, 1e-9))

    cameras = np.zeros((num_cameras, 9))
    for c in range(num_cameras):
        angle = 2 * np.pi * c / num_cameras
        pos = np.array([12.0 * np.cos(angle), 12.0 * np.sin(angle), 6.0])
        z_axis = pos / np.linalg.norm(pos)  # camera -z points to the origin
        x_axis = np.cross([0.0, 0.0, 1.0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])  # world -> camera
        cameras[c, :3] = _rotation_matrix_to_angle_axis_np(R)
        cameras[c, 3:6] = -R @ pos
        cameras[c, 6] = 500.0 + 10.0 * rng.standard_normal()
        cameras[c, 7] = 1e-7 * rng.standard_normal()
        cameras[c, 8] = 1e-13 * rng.standard_normal()

    # Per-point camera counts: base m, +1 for the first `extra` points so
    # the total matches num_observations exactly.
    m = min(max(2, num_observations // num_points), num_cameras)
    extra = min(
        max(0, num_observations - m * num_points), num_points
    ) if m < num_cameras else 0
    keys = rng.random((num_points, num_cameras))
    seen = np.argsort(keys, axis=1)  # (P, C) random permutations
    counts = np.full(num_points, m, dtype=np.int64)
    counts[:extra] += 1
    pt_idx = np.repeat(np.arange(num_points, dtype=np.int64), counts)
    ends = np.cumsum(counts)
    col = np.arange(ends[-1], dtype=np.int64) - np.repeat(ends - counts, counts)
    cam_idx = seen[pt_idx, col][:num_observations].astype(np.int64)
    pt_idx = pt_idx[:num_observations]

    obs = _project_np(cameras[cam_idx], points[pt_idx])
    obs += noise * rng.standard_normal(obs.shape)

    cameras_init = cameras.copy()
    points_init = points + perturb * rng.standard_normal(points.shape)
    cameras_init[:, 3:6] += perturb * 0.1 * rng.standard_normal((num_cameras, 3))
    return BALProblem(cameras_init, points_init, cam_idx, pt_idx, obs)


def _project_np(cams: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized numpy Snavely projection (the residual with observed = 0)."""
    aa = cams[:, :3]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    small = theta[:, 0] < 1e-12
    k = np.where(theta > 1e-12, aa / np.maximum(theta, 1e-300), 0.0)
    ct_, st = np.cos(theta), np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=1, keepdims=True)
    pr = pts * ct_ + kxp * st + k * kdp * (1.0 - ct_)
    pr[small] = pts[small]
    pc = pr + cams[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    f = cams[:, 6]
    return np.stack([f * distortion * xp, f * distortion * yp], axis=1)


def _rotation_matrix_to_angle_axis_np(R: np.ndarray) -> np.ndarray:
    """Rodrigues: theta from the trace, axis from the skew part."""
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    n = np.linalg.norm(axis)
    if n < 1e-12:
        # theta ~ pi: axis from the diagonal
        d = np.sqrt(np.clip((np.diag(R) + 1.0) / 2.0, 0.0, None))
        axis = d * np.sign(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
        n = np.linalg.norm(axis)
        if n < 1e-12:
            axis = d
            n = np.linalg.norm(axis)
    return theta * axis / n


def build_problem(bal: BALProblem, loss=None) -> Tuple[Problem, np.ndarray, np.ndarray]:
    """Build a Problem; returns (problem, camera_ids, point_ids). ``loss``
    (a ``ceres_tpu_torch.loss.LossFunction`` or None) robustifies every
    observation.

    Observations are ordered by point id (reorder_program.cc
    LexicographicallyOrderResidualBlocks): the point-side reductions then
    see sorted segment ids, which is what the sorted-segment-sum kernel
    takes."""
    p = Problem()
    cam_ids = p.add_parameter_blocks(bal.cameras)
    pt_ids = p.add_parameter_blocks(bal.points)
    order = np.argsort(bal.point_index, kind="stable")
    p.add_residual_blocks(
        snavely_reprojection_residual,
        loss,
        [cam_ids[bal.camera_index[order]], pt_ids[bal.point_index[order]]],
        data=bal.observations[order],
    )
    return p, cam_ids, pt_ids


def default_options(iterative: bool = True) -> SolverOptions:
    """bundle_adjuster.cc defaults: ITERATIVE_SCHUR + SCHUR_JACOBI."""
    return SolverOptions(
        linear_solver_type=(
            LinearSolverType.ITERATIVE_SCHUR
            if iterative
            else LinearSolverType.DENSE_SCHUR
        ),
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50,
        eta=0.1,
    )
