"""ctypes loader of the native host core (port of ``ceres_tpu/utils/native.py``).

The C++ core, ``native/ceres_tpu_core.cpp`` at the root of the repository,
holds host algorithms of the preprocessor and of the sparse direct solvers:
the Schur elimination ordering, the independent-set coloring, camera
clustering (single linkage and canonical views), the maximum-weight linear
forest of the cluster graph, the minimum-degree ordering, the simplicial
sparse Cholesky (analyze once, refactor many; f64 and f32 numeric phases)
and BAL file reading.

The library is compiled at first use with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``ceres_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, through a temporary file and an atomic
rename, so processes building at the same time never load a half-written
file. A failed build raises ``RuntimeError`` with the compiler's output:
no caller of this module has a fallback path. (The port's own numpy copies
of the Schur ordering and of the coloring, ``linear/schur.py`` and
``inner_iterations.py``, do not go through the core.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ceres_tpu_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_f64 = ctypes.c_double
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_f64 = ctypes.POINTER(ctypes.c_double)
_p_f32 = ctypes.POINTER(ctypes.c_float)
_vp = ctypes.c_void_p

# name: (argtypes, restype), as the JAX package's loader declares them
_SIGNATURES = {
    "bal_read_header": ([ctypes.c_char_p, _p_i64, _p_i64, _p_i64], ctypes.c_int),
    "bal_read_body": ([ctypes.c_char_p, _p_i64, _p_i64, _p_f64, _p_f64, _p_f64], ctypes.c_int),
    "schur_ordering": ([_i64, _p_i32, _i64, _i64, _p_i32, _p_i32], _i64),
    "independent_set_coloring": ([_i64, _p_i32, _i64, _i64, _p_i32, _p_i32], _i64),
    "single_linkage_cluster": ([_i64, _i64, _i64, _p_i32, _p_i32, _f64, _p_i32], _i64),
    "canonical_views_cluster": (
        [_i64, _i64, _i64, _p_i32, _p_i32, _i64, _f64, _f64, _p_i32], _i64),
    "max_weight_linear_forest": ([_i64, _i64, _i64, _p_i32, _p_i32, _p_i32, _p_i32], _i64),
    "mindeg_order": ([_i64, _p_i64, _p_i32, _p_i32], ctypes.c_int),
    "sparse_chol_analyze": ([_i64, _p_i64, _p_i32, _p_i32, _p_i32, _p_i64], _i64),
    "sparse_chol_factorize": ([_i64, _p_i64, _p_i32, _p_f64, _p_i32, _p_i64, _p_i32, _p_f64],
                              _i64),
    "sparse_chol_solve": ([_i64, _p_i64, _p_i32, _p_f64, _p_i32, _i64, _p_f64, _p_f64],
                          ctypes.c_int),
    "sparse_chol_symbolic_new": ([_i64, _p_i64, _p_i32, _p_i32, _p_i32, _p_i64], _vp),
    "sparse_chol_symbolic_nnz": ([_vp], _i64),
    "sparse_chol_symbolic_free": ([_vp], None),
    "sparse_chol_refactorize": ([_vp, _p_f64, _p_i32, _p_f64], _i64),
    "sparse_chol_refactorize_f32": ([_vp, _p_f32, _p_i32, _p_f32], _i64),
    "sparse_chol_solve_f32": ([_i64, _p_i64, _p_i32, _p_f32, _p_i32, _i64, _p_f32, _p_f32],
                              ctypes.c_int),
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libceres_tpu_core-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", *FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"g++ could not build the native core: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building the native core:\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> ctypes.CDLL:
    """The loaded core, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def i32p(a: np.ndarray):
    return a.ctypes.data_as(_p_i32)


def i64p(a: np.ndarray):
    return a.ctypes.data_as(_p_i64)


def f64p(a: np.ndarray):
    return a.ctypes.data_as(_p_f64)


def f32p(a: np.ndarray):
    return a.ctypes.data_as(_p_f32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def bal_load(path: str):
    """(cameras (C, 9), points (P, 3), camera index, point index, observations
    (O, 2)) of a BAL file, read by the core."""
    lib = get_lib()
    C, P, O = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.bal_read_header(str(path).encode(), ctypes.byref(C), ctypes.byref(P),
                             ctypes.byref(O))
    if rc != 0:
        raise ValueError(f"{path}: not a BAL file (native rc={rc})")
    C, P, O = C.value, P.value, O.value
    cam_idx = np.empty(O, dtype=np.int64)
    pt_idx = np.empty(O, dtype=np.int64)
    obs = np.empty((O, 2), dtype=np.float64)
    cameras = np.empty((C, 9), dtype=np.float64)
    points = np.empty((P, 3), dtype=np.float64)
    rc = lib.bal_read_body(str(path).encode(), i64p(cam_idx), i64p(pt_idx), f64p(obs),
                           f64p(cameras), f64p(points))
    if rc != 0:
        raise ValueError(f"{path}: truncated BAL file (native rc={rc})")
    return cameras, points, cam_idx, pt_idx, obs


def _block_table(program) -> Tuple[np.ndarray, np.ndarray]:
    """(tangent size per pid, -1 for constant blocks; every family's block
    ids padded with -1 to a common width, rows stacked)."""
    tsize = np.where(program.active, program.tangent_sizes, -1).astype(np.int32)
    k = max(f.block_ids.shape[1] for f in program.families)
    cols = np.concatenate([
        np.pad(np.asarray(f.block_ids, dtype=np.int32), ((0, 0), (0, k - f.block_ids.shape[1])),
               constant_values=-1)
        for f in program.families
    ])
    return tsize, np.ascontiguousarray(cols)


def schur_ordering(program) -> List[int]:
    """The core's greedy maximal-independent-set ordering: the e-block ids."""
    if not program.families:
        return []
    lib = get_lib()
    tsize, cols = _block_table(program)
    n = tsize.shape[0]
    out = np.empty(n, dtype=np.int32)
    cnt = lib.schur_ordering(n, i32p(tsize), cols.shape[0], cols.shape[1], i32p(cols), i32p(out))
    return out[:cnt].tolist()


def independent_sets(program) -> List[List[int]]:
    """The core's greedy coloring: independent sets of block ids, each
    ascending, the sets by size, largest first."""
    if not program.families:
        return []
    lib = get_lib()
    tsize, cols = _block_table(program)
    n = tsize.shape[0]
    color = np.empty(n, dtype=np.int32)
    nc = lib.independent_set_coloring(n, i32p(tsize), cols.shape[0], cols.shape[1], i32p(cols),
                                      i32p(color))
    sets = [[] for _ in range(nc)]
    for pid in np.nonzero((color >= 0) & (tsize >= 0))[0].tolist():
        sets[color[pid]].append(pid)
    sets.sort(key=len, reverse=True)
    return sets


def camera_clusters(num_cameras: int, num_points: int, camera_index, point_index,
                    threshold: float = 0.1) -> Tuple[int, np.ndarray]:
    """Single-linkage visibility clustering of the cameras
    (single_linkage_clustering.h:58): (number of clusters, cluster of each
    camera)."""
    lib = get_lib()
    ci, pi = _i32(camera_index), _i32(point_index)
    cluster = np.empty(num_cameras, dtype=np.int32)
    nc = lib.single_linkage_cluster(num_cameras, num_points, ci.shape[0], i32p(ci), i32p(pi),
                                    threshold, i32p(cluster))
    return int(nc), cluster


def canonical_views_clusters(num_cameras: int, num_points: int, camera_index, point_index,
                             min_views: int = 3, size_penalty_weight: float = 3.0,
                             similarity_penalty_weight: float = 0.0) -> Tuple[int, np.ndarray]:
    """Canonical-views clustering of the cameras (canonical_views_clustering.h:98,
    the weights of visibility_based_preconditioner.cc): (number of clusters,
    cluster of each camera)."""
    lib = get_lib()
    ci, pi = _i32(camera_index), _i32(point_index)
    cluster = np.empty(num_cameras, dtype=np.int32)
    nc = lib.canonical_views_cluster(num_cameras, num_points, ci.shape[0], i32p(ci), i32p(pi),
                                     int(min_views), size_penalty_weight,
                                     similarity_penalty_weight, i32p(cluster))
    return int(nc), cluster


def cluster_linear_forest(num_clusters: int, num_points: int, cluster_index, point_index):
    """Maximum-weight linear forest (paths: degree at most 2) over the cluster
    visibility graph, the edges of CLUSTER_TRIDIAGONAL
    (visibility_based_preconditioner.h:127): (edge ends a, edge ends b)."""
    lib = get_lib()
    ci, pi = _i32(cluster_index), _i32(point_index)
    cap = max(int(num_clusters) - 1, 1)
    ea = np.empty(cap, dtype=np.int32)
    eb = np.empty(cap, dtype=np.int32)
    ne = int(lib.max_weight_linear_forest(num_clusters, num_points, ci.shape[0], i32p(ci),
                                          i32p(pi), i32p(ea), i32p(eb)))
    return ea[:ne].copy(), eb[:ne].copy()
