"""The port's libmv model against ceres_tpu's: the binary loader on files
written here (both byte orders), the OpenCV reprojection residual and its
Jacobians, the problem's structure, and solves with the intrinsics fixed
and refined.

Tolerances: residuals and Jacobians rtol 1e-12; records' costs rtol 1e-10
with fixed intrinsics. Refined, the problem keeps BA's 7-dof gauge
freedom and the shared intrinsics couple every camera, so the CG steps of
ITERATIVE_SCHUR drift apart from record 4 on (6e-8 measured at this size
with the same record count and CG iterations): records are held to 1e-6.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

jl = importlib.import_module("ceres_tpu.models.libmv")
tl = importlib.import_module("ceres_tpu_torch.models.libmv")
TINY = dict(frames=12, tracks=40, window=6)


@pytest.mark.parametrize("big_endian", [False, True])
def test_loader_matches_jax(tmp_path, big_endian):
    path = tmp_path / "shot.bin"
    chip_smoke.write_libmv_shot(path, **TINY)
    if big_endian:  # the same shot, written big-endian
        from ceres_tpu_torch.rotation import angle_axis_to_rotation_matrix

        lp = tl.load_libmv_file(path)

        Rs = [angle_axis_to_rotation_matrix(torch.tensor(r[:3])).numpy() for r in lp.cameras_Rt]
        tl.write_libmv_file(path, lp.intrinsics, lp.camera_image, Rs, lp.cameras_Rt[:, 3:],
                            lp.point_track, lp.points, lp.camera_image[lp.marker_cam],
                            lp.point_track[lp.marker_pt], lp.markers, big_endian=True)
        assert path.read_bytes()[:1] == b"V"
    j, t = jl.load_libmv_file(path), tl.load_libmv_file(path)
    for field in ("intrinsics", "cameras_Rt", "camera_image", "points", "point_track",
                  "marker_cam", "marker_pt", "markers"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field), err_msg=field)
    assert t.is_image_space and j.is_image_space
    assert t.markers.shape == (TINY["tracks"] * TINY["window"], 2)
    # markers in frame order: the point ids are not sorted
    assert np.all(np.diff(t.marker_cam) >= 0) and np.any(np.diff(t.marker_pt) < 0)


def test_bad_flags_raise(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"xP" + bytes(40))
    with pytest.raises(ValueError, match="endian"):
        tl.load_libmv_file(path)
    path.write_bytes(b"vQ" + bytes(40))
    with pytest.raises(ValueError, match="space"):
        tl.load_libmv_file(path)


def test_residual_and_jacobians_match_jax():
    rng = np.random.default_rng(0)
    intr = np.array([1500.0, 960.0, 540.0, -0.08, 0.02, -0.005, 0.0005, -0.0003])
    Rt = np.concatenate([0.1 * rng.standard_normal((8, 3)), rng.standard_normal((8, 3))], axis=1)
    X = np.concatenate([rng.standard_normal((8, 2)), rng.uniform(8, 12, (8, 1))], axis=1)
    obs = rng.uniform(0, 1000, (8, 2))
    args = (np.broadcast_to(intr, (8, 8)), Rt, X, obs)
    jr = jax.vmap(jl.reprojection_residual)(*map(jnp.asarray, args))
    tr = torch.func.vmap(tl.reprojection_residual)(*map(torch.tensor, args))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12)
    jJ = jax.vmap(jax.jacfwd(jl.reprojection_residual, argnums=(0, 1, 2)))(*map(jnp.asarray, args))
    tJ = torch.func.vmap(torch.func.jacfwd(tl.reprojection_residual, argnums=(0, 1, 2)))(
        *map(torch.tensor, args))
    for a, b in zip(jJ, tJ):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-9)
    f32 = torch.func.vmap(torch.func.jacfwd(tl.reprojection_residual, argnums=(0, 1, 2)))(
        *(torch.tensor(a, dtype=torch.float32) for a in args))
    assert all(J.dtype == torch.float32 for J in f32)


def test_structure(tmp_path):
    """Fixed intrinsics: one f size (the cameras' 6) and argument 0 all on
    the dummy row; refined: two f sizes, 6 and 8."""
    from ceres_tpu_torch.linear.schur import build_schur_structure

    chip_smoke.write_libmv_shot(tmp_path / "shot.bin", **TINY)
    lp = tl.load_libmv_file(tmp_path / "shot.bin")
    for refine, sizes in ((False, [6]), (True, [6, 8])):
        p, intr, cams, pts = tl.build_problem(lp, refine_intrinsics=refine)
        assert p.is_parameter_block_constant(intr) is not refine
        ss = build_schur_structure(p.program("cpu"))
        assert sorted(ss.f_groups) == sizes and ss.e_tangent_size == 3
        assert ss.num_points == TINY["tracks"]


def test_solves_match_jax(tmp_path):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import libmv_references

    j = libmv_references(ct, tmp_path, **TINY)
    t = libmv_references(ctt, tmp_path, **TINY)
    for refine, rtol in ((False, 1e-10), (True, 1e-6)):
        assert len(t[refine][0]) == len(j[refine][0]) > 3
        assert [r[1] for r in t[refine][0]] == [r[1] for r in j[refine][0]]
        assert t[refine][2] == j[refine][2]
        np.testing.assert_allclose([r[0] for r in t[refine][0]], [r[0] for r in j[refine][0]],
                                   rtol=rtol)
