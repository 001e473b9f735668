"""K4 (fused pair-outer segment sum): the port's plain version against the
JAX package's Pallas kernel ``outer_segment_sum_blocked`` in interpret mode,
as tests/test_pallas_segment.py runs it, and against numpy in f64.

The port's function takes the slabs and the pair index arrays (it gathers
the rows itself); the Pallas kernel takes pre-gathered rows, so the test
gathers for it. f32 against the Pallas kernel: rtol 2e-5, atol 2e-4 (the
JAX package's own tolerance: f32 sums in another order). f64 against numpy:
1e-12 of the output scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.ops import pallas_segment as ps
from ceres_tpu.ops import reduce as jred
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops.segment_sum import build_row_ptr


def _inputs(rng, N, Pp, G, K, T1, T2, dtype):
    """Slabs with a zero pad row N, pair rows into them (some at the pad
    row), and sorted cell ids."""
    W = rng.standard_normal((N + 1, K * T1)).astype(dtype)
    Y = rng.standard_normal((N + 1, K * T2)).astype(dtype)
    W[N] = 0.0
    Y[N] = 0.0
    a = rng.integers(0, N + 1, Pp)
    b = rng.integers(0, N + 1, Pp)
    seg = np.sort(rng.integers(0, G, Pp))
    return W, Y, a, b, seg


def _numpy_reference(W, Y, a, b, seg, G, K, T1, T2):
    Pp = a.shape[0]
    contrib = np.einsum(
        "bki,bkj->bij",
        W[a].reshape(Pp, K, T1).astype(np.float64),
        Y[b].reshape(Pp, K, T2).astype(np.float64),
    ).reshape(Pp, T1 * T2)
    out = np.zeros((G + 1, T1 * T2))
    np.add.at(out, seg, contrib)
    return out


def _port(W, Y, a, b, seg, G, K, T1, T2):
    row_ptr = torch.from_numpy(build_row_ptr(seg, G))
    return osum.outer_segment_sum(
        torch.from_numpy(W), torch.from_numpy(Y), torch.from_numpy(a),
        torch.from_numpy(b), row_ptr, G, K, T1, T2,
    ).numpy()


def test_plain_matches_pallas_outer_blocked(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(23)
    K, T1, T2 = 3, 9, 9
    Pp, G, N = 30000, 12000, 7000
    W, Y, a, b, seg = _inputs(rng, N, Pp, G, K, T1, T2, np.float32)
    plan = jred.build_reduce_plan(seg, G)
    assert plan.kind == "sorted_blocked"
    ref = np.asarray(ps.outer_segment_sum_blocked(
        jnp.asarray(W[a]), jnp.asarray(Y[b]), plan, K, T1, T2, interpret=True,
    ))
    out = _port(W, Y, a, b, seg, G, K, T1, T2)
    assert out.shape == (G + 1, T1 * T2) and out.dtype == np.float32
    np.testing.assert_allclose(out[:G], ref[:G], rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize(
    "K,T1,T2", [(3, 9, 9), (3, 9, 6), (2, 4, 7), (1, 1, 1)],
    ids=["3x9x9", "3x9x6", "2x4x7", "1x1x1"],
)
def test_plain_matches_numpy_f64(K, T1, T2):
    rng = np.random.default_rng(K * 100 + T1 * 10 + T2)
    Pp, G, N = 9000, 2500, 3000
    W, Y, a, b, seg = _inputs(rng, N, Pp, G, K, T1, T2, np.float64)
    seg[:4000] = seg[0]  # one cell with thousands of pairs; others stay empty
    ref = _numpy_reference(W, Y, a, b, seg, G, K, T1, T2)
    out = _port(W, Y, a, b, seg, G, K, T1, T2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert not out[G].any()  # the dummy cell holds no pair


def test_flat_outer_layout():
    """out[p, i*T2+j] = sum_k A[p, k*T1+i] * B[p, k*T2+j], against loops."""
    rng = np.random.default_rng(1)
    K, T1, T2 = 3, 4, 5
    A, B = rng.standard_normal((6, K * T1)), rng.standard_normal((6, K * T2))
    out = osum.flat_outer(torch.from_numpy(A), torch.from_numpy(B), K, T1, T2).numpy()
    for i in range(T1):
        for j in range(T2):
            ref = sum(A[:, k * T1 + i] * B[:, k * T2 + j] for k in range(K))
            np.testing.assert_allclose(out[:, i * T2 + j], ref, rtol=1e-14, atol=1e-14)


def test_wrapper_rejects_bad_arguments():
    W, Y = torch.zeros(5, 27), torch.zeros(5, 27)
    idx = torch.zeros(4, dtype=torch.int64)
    row_ptr = torch.from_numpy(build_row_ptr(np.zeros(4, np.int64), 3))
    before = osum.launches
    out = osum.outer_segment_sum(W, Y, idx, idx, row_ptr, 3, 3, 9, 9)
    assert out.shape == (4, 81) and osum.launches == before  # CPU: no launch
    with pytest.raises(ValueError, match="slabs must be"):
        osum.outer_segment_sum(W, Y, idx, idx, row_ptr, 3, 3, 9, 6)
    with pytest.raises(ValueError, match="int64"):
        osum.outer_segment_sum(W, Y, idx.int(), idx, row_ptr, 3, 3, 9, 9)
    with pytest.raises(ValueError, match="row_ptr"):
        osum.outer_segment_sum(W, Y, idx, idx, row_ptr.long(), 3, 3, 9, 9)
    with pytest.raises(TypeError):
        osum.outer_segment_sum(W, Y.double(), idx, idx, row_ptr, 3, 3, 9, 9)
    with pytest.raises(ValueError, match="plan on"):
        osum.outer_segment_sum(W, Y, idx.to("meta"), idx, row_ptr, 3, 3, 9, 9)
