"""Covariance of the port against ceres_tpu's on the same seeded problems:
the Schur-marginal path (forced by lowering DENSE_COVARIANCE_MAX_TANGENT in
both packages, and chosen after a Schur solve), the matrix-free CG path
(forced as tests/test_covariance_matrix_free.py forces it), DENSE_SVD with
and without null-space handling, the QR analog, the gauge-deficient
refusal, constant blocks, the quaternion lift to ambient space and the
errors for pairs a path does not hold.

Tolerances: blocks relative to the block's largest entry, 1e-8 for the
Schur and dense paths. The matrix-free path stops CG at a relative
residual of 1e-10, so its blocks are as exact as that stop (held to 1e-5
against JAX's and against the dense path's) and its iteration counts are
set by rounding: JAX's own batched and unbatched solves of one column
differ by up to 6 of about 455 iterations on a 60-pose graph, and the
port's counts differ from JAX's by up to 16 of about 300 on the 30-pose
graph here, so they are held to 10% of JAX's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg

jcov = importlib.import_module("ceres_tpu.covariance")
tcov = importlib.import_module("ceres_tpu_torch.covariance")
SMALL = dict(num_cameras=4, num_points=40, num_observations=160, seed=3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _kw(mod):
    return {} if mod is ct else dict(device="cpu")


def _ba(mod, gauge=True):
    bm = jbal if mod is ct else tbal
    p, cams, pts = bm.build_problem(bm.synthesize_bal(noise=2.0, perturb=0.7, **SMALL))
    if gauge:
        p.set_parameter_block_constant(int(cams[0]))
        p.set_parameter_block_constant(int(pts[-1]))
    return p, cams, pts


@pytest.fixture
def forced_schur(monkeypatch):
    for m in (jcov, tcov):
        monkeypatch.setattr(m, "DENSE_COVARIANCE_MAX_TANGENT", 1)


def test_schur_marginals_match_jax(forced_schur):
    out = {}
    for mod in (ct, ctt):
        p, cams, _ = _ba(mod)
        pairs = [(int(cams[1]), int(cams[1])), (int(cams[2]), int(cams[3])), (int(cams[0]), int(cams[2]))]
        cov = mod.Covariance()
        assert cov.compute(pairs, p, **_kw(mod))
        assert cov._schur_cov is not None
        out[mod] = [cov.get_covariance_block_in_tangent_space(*pr) for pr in pairs]
        with pytest.raises(RuntimeError, match="non-eliminated"):
            cov.get_covariance_block(int(cams[1]), int(_ba(mod)[2][0]))
    for a, b in zip(out[ctt], out[ct]):
        assert _rel(a, b) <= 1e-8
    assert np.all(out[ctt][2] == 0.0)  # camera 0 is constant


def test_schur_marginals_match_the_dense_path():
    """Camera blocks requested after a DENSE_SCHUR solve take the Schur
    path (the program keeps its structure), and agree with DENSE_SVD."""
    p, cams, _ = _ba(ctt)
    ctt.solve(ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=3), p, device="cpu")
    pairs = [(int(cams[1]), int(cams[1])), (int(cams[2]), int(cams[3]))]
    cov_s = ctt.Covariance()
    assert cov_s.compute(pairs, p, device="cpu") and cov_s._schur_cov is not None
    p._dirty()  # a fresh program without the structure: the dense path
    cov_d = ctt.Covariance(ctt.CovarianceOptions(algorithm_type="DENSE_SVD"))
    assert cov_d.compute(pairs, p, device="cpu") and cov_d._cov_tangent is not None
    for pr in pairs:
        assert _rel(cov_s.get_covariance_block_in_tangent_space(*pr),
                    cov_d.get_covariance_block_in_tangent_space(*pr)) <= 1e-8


def test_float32_schur_marginals_near_float64(forced_schur):
    p, cams, _ = _ba(ctt)
    pair = (int(cams[1]), int(cams[1]))
    blocks = []
    for dtype in ("float64", "float32"):
        cov = ctt.Covariance()
        assert cov.compute([pair], p, device="cpu", evaluation_dtype=dtype)
        blocks.append(cov.get_covariance_block_in_tangent_space(*pair))
    assert _rel(blocks[1], blocks[0]) <= 1e-2  # S assembled in f32, inverted in f64


def test_gauge_deficient_refused(forced_schur):
    for mod in (ct, ctt):
        p, cams, _ = _ba(mod, gauge=False)
        assert mod.Covariance().compute([(int(cams[1]), int(cams[1]))], p, **_kw(mod)) is False


@pytest.mark.parametrize("algorithm", ["DENSE_SVD", "SPARSE_QR"])
def test_dense_paths_match_jax(algorithm):
    out = {}
    for mod in (ct, ctt):
        p, cams, pts = _ba(mod)
        pairs = [(int(cams[1]), int(pts[3])), (int(pts[3]), int(pts[3])), (int(cams[0]), int(cams[0]))]
        cov = mod.Covariance(mod.CovarianceOptions(algorithm_type=algorithm))
        assert cov.compute(pairs, p, **_kw(mod))
        out[mod] = [cov.get_covariance_block(*pr) for pr in pairs]
    for a, b in zip(out[ctt][:2], out[ct][:2]):
        assert _rel(a, b) <= 1e-8
    assert out[ctt][2].shape == (9, 9) and np.all(out[ctt][2] == 0.0)


def _two_blocks(mod):
    """Only the difference of a and b is observed: J'J is singular."""
    p = mod.Problem()
    a = p.add_parameter_block(np.array([1.0]))
    b = p.add_parameter_block(np.array([2.0]))
    p.add_residual_block(lambda u, v: u - v - 1.0, None, [a, b])
    return p, a


@pytest.mark.parametrize("null_space_rank", [0, -1, 1])
def test_null_space_rank_matches_jax(null_space_rank):
    out = []
    for mod in (ct, ctt):
        p, a = _two_blocks(mod)
        cov = mod.Covariance(mod.CovarianceOptions(algorithm_type="DENSE_SVD",
                                                   null_space_rank=null_space_rank))
        ok = cov.compute([(a, a)], p, **_kw(mod))
        out.append((ok, cov.get_covariance_block(a, a) if ok else None))
    assert out[0][0] == out[1][0] == (null_space_rank != 0)
    if out[0][0]:
        assert _rel(out[1][1], out[0][1]) <= 1e-12
    # the QR analog refuses the wide Jacobian
    for mod in (ct, ctt):
        p, a = _two_blocks(mod)
        assert mod.Covariance().compute([(a, a)], p, **_kw(mod)) is False


def _quaternion_problem(mod):
    rng = np.random.default_rng(2)
    q0 = rng.standard_normal(4)
    q0 /= np.linalg.norm(q0)
    target = q0 + 0.01 * rng.standard_normal(4)
    p = mod.Problem()
    q = p.add_parameter_block(q0, mod.QuaternionManifold())
    if mod is ct:
        p.add_residual_block(lambda v: v - jnp.asarray(target), None, [q])
    else:
        p.add_residual_block(lambda v: v - torch.from_numpy(target).to(v), None, [q])
    return p, q


def test_quaternion_block_lifts_to_ambient_like_jax():
    out = {}
    for mod in (ct, ctt):
        p, q = _quaternion_problem(mod)
        cov = mod.Covariance()
        assert cov.compute([(q, q)], p, **_kw(mod))
        out[mod] = (cov.get_covariance_block_in_tangent_space(q, q), cov.get_covariance_block(q, q))
    assert out[ctt][0].shape == (3, 3) and out[ctt][1].shape == (4, 4)
    for a, b in zip(out[ctt], out[ct]):
        assert _rel(a, b) <= 1e-8


def _chain(mod, n_blocks=12, seed=0):
    """tests/test_covariance_matrix_free.py's chain: blocks of size 2, an
    anchor on each and a coupling between neighbours."""
    rng = np.random.default_rng(seed)
    p = mod.Problem()
    xs = [p.add_parameter_block(rng.normal(size=2)) for _ in range(n_blocks)]
    targets = rng.normal(size=(n_blocks, 2))
    for i in range(n_blocks):
        if mod is ct:
            p.add_residual_block(lambda x, t=jnp.asarray(targets[i]): 1.3 * (x - t), None, [xs[i]])
        else:
            t = torch.from_numpy(targets[i])
            p.add_residual_block(lambda x, t=t: 1.3 * (x - t.to(x)), None, [xs[i]])
    for i in range(n_blocks - 1):
        p.add_residual_block(lambda a, b: 0.7 * (a - 2.0 * b) + 0.1, None, [xs[i], xs[i + 1]])
    return p, xs


@pytest.fixture
def forced_matrix_free(monkeypatch):
    for m in (jcov, tcov):
        monkeypatch.setattr(m, "DENSE_COVARIANCE_MAX_TANGENT", 1)
        monkeypatch.setattr(m.Covariance, "_compute_schur_marginals", lambda self, *a: None)


def test_matrix_free_matches_jax_and_the_dense_path(forced_matrix_free, monkeypatch):
    out = {}
    for mod in (ct, ctt):
        p, xs = _chain(mod)
        pairs = [(xs[0], xs[0]), (xs[1], xs[3]), (xs[5], xs[5]), (xs[2], xs[9])]
        cov = mod.Covariance()
        assert cov.compute(pairs, p, **_kw(mod)) and cov._mf_Z is not None
        out[mod] = [cov.get_covariance_block(*pr) for pr in pairs]
        # the transposed pair comes from the same columns; an unrequested one raises
        np.testing.assert_array_equal(cov.get_covariance_block(xs[3], xs[1]), out[mod][1].T)
        with pytest.raises(RuntimeError, match="matrix-free"):
            cov.get_covariance_block(xs[4], xs[7])
    monkeypatch.setattr(tcov, "DENSE_COVARIANCE_MAX_TANGENT", 4096)
    p, xs = _chain(ctt)
    dense = ctt.Covariance()
    assert dense.compute([(xs[0], xs[0])], p, device="cpu") and dense._cov_tangent is not None
    for a, b in zip(out[ctt], out[ct]):
        assert _rel(a, b) <= 1e-5
    assert _rel(out[ctt][0], dense.get_covariance_block(xs[0], xs[0])) <= 1e-5


def test_matrix_free_pose_graph_matches_jax(forced_matrix_free):
    """The matrix-free phase's pose-graph case at 30 poses: the ambient
    quaternion blocks and each column's CG iterations."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import covariance_matrix_free_references

    jb, jpath, jit, _ = covariance_matrix_free_references(ct, poses=30, seed=1)
    tb, tpath, tit, _ = covariance_matrix_free_references(ctt, poses=30, seed=1)
    assert jpath == tpath == "matrix_free"
    assert len(tit) == len(jit) == 9
    assert all(abs(a - b) <= 0.1 * b for a, b in zip(tit, jit)), (tit, jit)
    for a, b in zip(tb, jb):
        assert _rel(a, b) <= 1e-5


def test_matrix_free_batched_cg_freezes_finished_columns():
    """conjugate_gradients_columns: each column takes its unbatched solve's
    iterations (to one: the dot products sum in another order) and iterate,
    a zero column is done before the first iteration, and a finished column
    does not move while the others go on."""
    from ceres_tpu_torch.linear.cg import conjugate_gradients, conjugate_gradients_columns

    rng = np.random.default_rng(4)
    A = rng.standard_normal((30, 30))
    A = torch.tensor(A @ A.T + np.diag(np.linspace(0.1, 30.0, 30)))
    B = torch.tensor(rng.standard_normal((30, 3)))
    B[:, 1] = 0.0
    B[:, 2] = A[:, 0]  # solved in one iteration by x = e_0
    kw = dict(r_tolerance=1e-10, residual_reset_period=7)
    res = conjugate_gradients_columns(lambda V: A @ V, B, max_num_iterations=200, **kw)
    one = conjugate_gradients(lambda v: A @ v, B[:, 0].clone(), max_num_iterations=200, **kw)
    assert abs(int(one.num_iterations) - int(res.num_iterations[0])) <= 1
    assert _rel(res.x[:, 0].numpy(), one.x.numpy()) <= 1e-8  # both stop at r <= 1e-10 |b|
    assert int(res.num_iterations[1]) == 0 and torch.all(res.x[:, 1] == 0)
    k = int(res.num_iterations[2])
    assert k < int(res.num_iterations[0])
    early = conjugate_gradients_columns(lambda V: A @ V, B, max_num_iterations=k, **kw)
    assert torch.equal(early.x[:, 2], res.x[:, 2]) and int(early.termination[2]) == 1


def test_compute_first_and_the_card_by_default():
    with pytest.raises(RuntimeError, match="compute"):
        ctt.Covariance().get_covariance_block(0, 0)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p, cams, _ = _ba(ctt)
    with pytest.raises((RuntimeError, AssertionError)):
        ctt.Covariance().compute([(int(cams[1]), int(cams[1]))], p)
