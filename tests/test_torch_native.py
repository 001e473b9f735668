"""The port's loader of the native core (ceres_tpu_torch/utils/native.py)
against the JAX package's (ceres_tpu/utils/native.py) on the same inputs:
camera clusters, the linear forest, the orderings, the coloring, the sparse
factor's solve and a BAL file, each equal to the bit; and the build itself:
the library named by a hash of its source and flags under
ceres_tpu_torch/_build/, a failed compile raising with the compiler's
output.
"""

import ctypes

import numpy as np
import pytest
import scipy.sparse as sp

from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu.utils import native as jn
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg
from ceres_tpu_torch.utils import native as tn

BAL = dict(num_cameras=12, num_points=400, num_observations=1600, seed=5)


def _visibility(seed=5, cams=12, pts=400, obs=1600):
    inst = tbal.synthesize_bal(num_cameras=cams, num_points=pts, num_observations=obs, seed=seed)
    return inst.camera_index, inst.point_index


def test_library_is_built_into_the_package_build_dir_by_hash():
    lib = tn.get_lib()
    path = tn.library_path()
    assert path.parent == tn.BUILD_DIR and path.parent.name == "_build"
    assert path.exists() and path.name.startswith("libceres_tpu_core-")
    assert lib is tn.get_lib()  # loaded once per process
    assert tn.SOURCE == jn._SRC  # the same source the JAX package builds


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*broken.cpp"):
        tn._build(tn.library_path())
    assert not list((tmp_path / "_build").glob("*.so"))  # no half-written library
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tn._build(tn.library_path())


@pytest.mark.parametrize("seed", [5, 6])
def test_clusterings_equal_jax(seed):
    ci, pi = _visibility(seed)
    C, P = int(ci.max()) + 1, int(pi.max()) + 1
    for fn in ("canonical_views_clusters", "camera_clusters"):
        nj, cj = getattr(jn, fn)(C, P, ci, pi)
        nt, ct_ = getattr(tn, fn)(C, P, ci, pi)
        assert nt == nj and np.array_equal(ct_, cj), fn
    # the clusters' linear forest
    nc, cluster = tn.canonical_views_clusters(C, P, ci, pi)
    assert nc > 1
    ej = jn.cluster_linear_forest(nc, P, cluster[ci], pi)
    et = tn.cluster_linear_forest(nc, P, cluster[ci], pi)
    assert all(np.array_equal(a, b) for a, b in zip(et, ej)) and et[0].size


@pytest.mark.parametrize("case", ["bal", "bal_constant", "pose_graph"])
def test_orderings_and_coloring_equal_jax(case):
    if case == "pose_graph":
        jp = jpg.build_problem_3d(*jpg.synthesize_sphere(60, seed=1)[:3])[0]
        tp = tpg.build_problem_3d(*tpg.synthesize_sphere(60, seed=1)[:3])[0]
    else:
        jp, jc, _ = jbal.build_problem(jbal.synthesize_bal(**BAL))
        tp, tc, _ = tbal.build_problem(tbal.synthesize_bal(**BAL))
        if case == "bal_constant":
            jp.set_parameter_block_constant(jc[:3])
            tp.set_parameter_block_constant(tc[:3])
    jprog, tprog = jp.program(), tp.program("cpu")
    assert tn.schur_ordering(tprog) == jn.schur_ordering(jprog)
    assert tn.independent_sets(tprog) == jn.independent_sets(jprog)


def _upper(n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc").toarray()
    Hu = sp.triu(sp.csc_matrix(A @ A.T + n * np.eye(n)), format="csc")
    Hu.sort_indices()
    return Hu


def _factor_solve(lib, Hu, b, single=False):
    """Minimum-degree order, symbolic analysis, numeric factor and solve
    through ``lib``'s raw entries."""
    n = Hu.shape[0]
    Ap = np.ascontiguousarray(Hu.indptr, dtype=np.int64)
    Ai = np.ascontiguousarray(Hu.indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    assert lib.mindeg_order(n, i64(Ap), i32(Ai), i32(perm)) == 0
    parent = np.empty(n, dtype=np.int32)
    Lp = np.empty(n + 1, dtype=np.int64)
    h = lib.sparse_chol_symbolic_new(n, i64(Ap), i32(Ai), i32(perm), i32(parent), i64(Lp))
    try:
        nnz = lib.sparse_chol_symbolic_nnz(h)
        Li = np.empty(nnz, dtype=np.int32)
        dt, ct_ = (np.float32, ctypes.c_float) if single else (np.float64, ctypes.c_double)
        fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ct_))  # noqa: E731
        Lx = np.empty(nnz, dtype=dt)
        Ax = np.ascontiguousarray(Hu.data, dtype=dt)
        refac = lib.sparse_chol_refactorize_f32 if single else lib.sparse_chol_refactorize
        assert refac(h, fp(Ax), i32(Li), fp(Lx)) == 0
        B = np.ascontiguousarray(np.atleast_2d(b), dtype=dt)
        X = np.empty_like(B)
        solve = lib.sparse_chol_solve_f32 if single else lib.sparse_chol_solve
        solve(n, i64(Lp), i32(Li), fp(Lx), i32(perm), B.shape[0], fp(B), fp(X))
        return perm, parent, Lp, X
    finally:
        lib.sparse_chol_symbolic_free(h)


@pytest.mark.parametrize("single", [False, True])
def test_factor_and_solve_equal_jax(single):
    Hu = _upper(90, 0.05, 1)
    b = np.random.default_rng(2).standard_normal((2, 90))
    got = _factor_solve(tn.get_lib(), Hu, b, single)
    want = _factor_solve(jn.get_lib(), Hu, b, single)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    H = Hu + sp.triu(Hu, k=1).T
    np.testing.assert_allclose(got[3] @ H.T.toarray(), b, rtol=1e-4 if single else 1e-10,
                               atol=1e-4 if single else 1e-10)


def test_bal_load_equals_jax(tmp_path):
    inst = tbal.synthesize_bal(num_cameras=3, num_points=7, num_observations=14, seed=1)
    path = tmp_path / "problem.txt"
    lines = [f"{inst.num_cameras} {inst.num_points} {inst.num_observations}"]
    lines += [f"{c} {p} {float(x)!r} {float(y)!r}" for c, p, (x, y) in
              zip(inst.camera_index, inst.point_index, inst.observations)]
    lines += [repr(float(v)) for v in np.concatenate([inst.cameras.ravel(), inst.points.ravel()])]
    path.write_text("\n".join(lines) + "\n")
    got, want = tn.bal_load(str(path)), jn.bal_load(str(path))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    np.testing.assert_array_equal(got[4], inst.observations)
    (tmp_path / "short.txt").write_text("3 7 14\n0 0 1.0\n")
    with pytest.raises(ValueError, match="truncated"):
        tn.bal_load(str(tmp_path / "short.txt"))
