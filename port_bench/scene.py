"""The scenes and the starts the benchmark hands to the program and to the
reference alike.

A scene is ``synthesize_bal`` of ``ceres_tpu_torch/models/bal.py`` (cameras on
a ring looking at a point cloud, uniformly random visibility, observations =
true Snavely projections + pixel noise), made here from the configuration's
``scene_seed`` (one fixed problem, as a BAL file is) with a
``torch.Generator`` on the run's device, in a few large calls, so that a
Dubrovnik-356 scene (80 M visibility keys) costs milliseconds of set-up and
not seconds of host sorting. It is the yardstick's own copy: a change to the
program's generator does not change what the benchmark runs.

A start is the true state perturbed as ``bal_problem.cc`` Perturb() does:
points + sigma N(0, 1), camera translations + sigma_t N(0, 1), drawn from
(the run's seed, request index), so the same seed gives the same requests
and every seed the same work in another order, up to the starts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64


@dataclasses.dataclass
class Scene:
    """True cameras (C, 9) and points (P, 3), and the observations: camera
    and point of each (O,) and its observed pixel (O, 2). Host arrays, f64
    and int64, in the order they were drawn (not sorted by point)."""

    cameras: np.ndarray
    points: np.ndarray
    camera_index: np.ndarray
    point_index: np.ndarray
    observations: np.ndarray

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for the stream (seed, keys...): any whole
    seed, large ones included, each key a separate stream."""
    words = [int(seed) % 2**64, int(seed) // 2**64 % 2**64, *(int(k) for k in keys)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(device, seed: int, *keys: int) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, *keys))
    return gen


def project(cams: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Snavely projection (the residual with observed = 0), one row per
    (camera, point) pair: ``_project_np`` of the program's ``models/bal.py``
    in torch. Rodrigues' formula; an angle under 1e-12 rotates by nothing."""
    aa = cams[:, :3]
    theta = torch.linalg.norm(aa, dim=1, keepdim=True)
    small = theta < 1e-12
    k = torch.where(small, torch.zeros_like(aa), aa / torch.where(small, 1.0, theta))
    c, s = torch.cos(theta), torch.sin(theta)
    kxp = torch.linalg.cross(k, pts, dim=1)
    kdp = torch.sum(k * pts, dim=1, keepdim=True)
    pr = torch.where(small, pts, pts * c + kxp * s + k * kdp * (1.0 - c))
    pc = pr + cams[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    f = cams[:, 6]
    return torch.stack([f * distortion * xp, f * distortion * yp], dim=1)


def _angle_axis(R: np.ndarray) -> np.ndarray:
    """Rodrigues: the angle from the trace, the axis from the skew part, or
    near pi from the diagonal (``_rotation_matrix_to_angle_axis_np``)."""
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = math.acos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    axis, n = skew, np.linalg.norm(skew)
    if n < 1e-12:
        d = np.sqrt(np.clip((np.diag(R) + 1.0) / 2.0, 0.0, None))
        axis = d * np.sign(skew)
        n = np.linalg.norm(axis)
        if n < 1e-12:
            axis = d
            n = np.linalg.norm(axis)
    return theta * axis / n


def make_scene(num_cameras: int, num_points: int, num_observations: int, noise: float,
               seed: int, device) -> Scene:
    """``synthesize_bal``'s scene with these counts, drawn from ``seed`` on
    ``device``. Each point is seen by m = min(max(2, O // P), C) distinct
    cameras, the first O - m P points by one more, so the count of
    observations is exactly O."""
    C, P, O = int(num_cameras), int(num_points), int(num_observations)
    m = min(max(2, O // P), C)
    extra = min(max(0, O - m * P), P) if m < C else 0
    if m * P + extra < O:
        raise ValueError(f"{C} cameras and {P} points cannot give {O} observations")
    device = torch.device(device)
    gen = _generator(device, seed, 0)

    points = torch.randn((P, 3), generator=gen, dtype=F64, device=device)
    points *= torch.tensor([4.0, 4.0, 1.0], dtype=F64, device=device)
    # Inside a ball of radius 6: every point well in front of every camera.
    norms = torch.linalg.norm(points, dim=1, keepdim=True)
    points *= torch.clamp(6.0 / torch.clamp(norms, min=1e-9), max=1.0)

    cams = np.zeros((C, 9))
    for c in range(C):
        angle = 2 * math.pi * c / C
        pos = np.array([12.0 * math.cos(angle), 12.0 * math.sin(angle), 6.0])
        z_axis = pos / np.linalg.norm(pos)  # the camera's -z looks at the origin
        x_axis = np.cross([0.0, 0.0, 1.0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])  # world -> camera
        cams[c, :3] = _angle_axis(R)
        cams[c, 3:6] = -R @ pos
    cameras = torch.from_numpy(cams).to(device)
    intrinsics = torch.randn((C, 3), generator=gen, dtype=F64, device=device)
    cameras[:, 6] = 500.0 + 10.0 * intrinsics[:, 0]
    cameras[:, 7] = 1e-7 * intrinsics[:, 1]
    cameras[:, 8] = 1e-13 * intrinsics[:, 2]

    # Each point's cameras: the first m (or m + 1) of a random permutation.
    keys = torch.rand((P, C), generator=gen, device=device)
    seen = torch.argsort(keys, dim=1, stable=True)[:, : m + (1 if extra else 0)]
    del keys
    counts = torch.full((P,), m, dtype=torch.int64, device=device)
    counts[:extra] += 1
    pt_idx = torch.repeat_interleave(torch.arange(P, device=device), counts)
    ends = torch.cumsum(counts, 0)
    col = torch.arange(int(ends[-1]), device=device) - torch.repeat_interleave(ends - counts, counts)
    cam_idx = seen[pt_idx, col][:O]
    pt_idx = pt_idx[:O]

    obs = project(cameras[cam_idx], points[pt_idx])
    obs += noise * torch.randn(obs.shape, generator=gen, dtype=F64, device=device)
    return Scene(
        cameras=cameras.cpu().numpy(), points=points.cpu().numpy(),
        camera_index=cam_idx.cpu().numpy(), point_index=pt_idx.cpu().numpy(),
        observations=obs.cpu().numpy(),
    )


def _perturbed(scene: Scene, points_sigma: float, translation_sigma: float, count: int,
               seed: int, stream: int, index: int, device) -> np.ndarray:
    """``count`` perturbed states as rows of one host array (each laid out
    as the ``Problem``'s state: cameras, then points), drawn on ``device``
    from the stream (seed, stream, index) in two calls."""
    device = torch.device(device)
    gen = _generator(device, seed, stream, index)
    C, P = scene.num_cameras, scene.num_points
    dp = torch.randn((count, P, 3), generator=gen, dtype=F64, device=device) * points_sigma
    dt = torch.randn((count, C, 3), generator=gen, dtype=F64, device=device) * translation_sigma
    cams = torch.from_numpy(scene.cameras).to(device).expand(count, C, 9).clone()
    cams[:, :, 3:6] += dt
    pts = torch.from_numpy(scene.points).to(device) + dp
    return torch.cat([cams.reshape(count, -1), pts.reshape(count, -1)], dim=1).cpu().numpy()


class Starts:
    """Starts drawn from the stream (seed, stream): request k's is row k %
    batch of batch k // batch, a batch drawn in one go from (seed, stream,
    batch index) when first needed, so the window spends a fraction of a
    millisecond a request on them. The window draws from ``WINDOW``, the
    set-up's solves from ``SETUP``."""

    WINDOW, SETUP = 2, 3
    BATCH = 32

    def __init__(self, scene: Scene, points_sigma: float, translation_sigma: float, seed: int,
                 device, stream: int = WINDOW, batch: int = BATCH):
        self._args = (scene, points_sigma, translation_sigma)
        self.seed, self.device, self.stream, self.batch = seed, device, stream, batch
        self._index, self._rows = -1, None

    def __getitem__(self, request: int) -> np.ndarray:
        index, row = divmod(request, self.batch)
        if index != self._index:
            self._rows = None  # the last batch's memory goes first
            self._rows = _perturbed(*self._args, self.batch, self.seed, self.stream, index,
                                    self.device)
            self._index = index
        return self._rows[row]
