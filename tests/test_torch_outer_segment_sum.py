"""K4 (fused pair-outer segment sum): the port's plain version against the
JAX package's Pallas kernel ``outer_segment_sum_blocked`` in interpret mode,
as tests/test_pallas_segment.py runs it, and against numpy in f64.

The port's function takes the slabs and the pair index arrays (int32, made
by ``pair_rows_int32``; it gathers the rows itself); the Pallas kernel takes
pre-gathered rows, so the test gathers for it. f32 against the Pallas kernel: rtol 2e-5, atol 2e-4 (the
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
        torch.from_numpy(W), torch.from_numpy(Y),
        torch.from_numpy(osum.pair_rows_int32(a)),
        torch.from_numpy(osum.pair_rows_int32(b)), row_ptr, G, K, T1, T2,
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
    idx = torch.zeros(4, dtype=torch.int32)
    row_ptr = torch.from_numpy(build_row_ptr(np.zeros(4, np.int64), 3))
    before = osum.launches
    out = osum.outer_segment_sum(W, Y, idx, idx, row_ptr, 3, 3, 9, 9)
    assert out.shape == (4, 81) and osum.launches == before  # CPU: no launch
    with pytest.raises(ValueError, match="slabs must be"):
        osum.outer_segment_sum(W, Y, idx, idx, row_ptr, 3, 3, 9, 6)
    with pytest.raises(ValueError, match="int32"):
        osum.outer_segment_sum(W, Y, idx.long(), idx, row_ptr, 3, 3, 9, 9)
    with pytest.raises(ValueError, match="row_ptr"):
        osum.outer_segment_sum(W, Y, idx, idx, row_ptr.long(), 3, 3, 9, 9)
    with pytest.raises(TypeError):
        osum.outer_segment_sum(W, Y.double(), idx, idx, row_ptr, 3, 3, 9, 9)
    with pytest.raises(ValueError, match="plan on"):
        osum.outer_segment_sum(W, Y, idx.to("meta"), idx, row_ptr, 3, 3, 9, 9)


@pytest.mark.parametrize(
    "rows",
    [
        np.array([0, 5, 1_199_999, 1_200_000], dtype=np.int64),
        np.array([2**31 - 1, 0], dtype=np.int64),
        np.array([3, 1, 2], dtype=np.uint16),
        np.zeros(0, dtype=np.int64),
        np.arange(20, dtype=np.int64)[::3],  # not contiguous
    ],
    ids=["large_case_slots", "largest_int32", "uint16", "empty", "strided"],
)
def test_pair_rows_int32_keeps_the_rows(rows):
    out = osum.pair_rows_int32(rows)
    assert out.dtype == np.int32 and out.flags.c_contiguous
    assert out.shape == rows.shape
    np.testing.assert_array_equal(out.astype(np.int64), rows.astype(np.int64))


@pytest.mark.parametrize(
    "rows",
    [
        np.array([0, 2**31], dtype=np.int64),
        np.array([2**40], dtype=np.int64),
        np.array([2**31], dtype=np.uint32),
        np.array([-1, 4], dtype=np.int64),
        np.array([1.0, 2.0]),
        np.zeros((2, 2), dtype=np.int64),
    ],
    ids=["2^31", "2^40", "uint32_2^31", "negative", "floats", "matrix"],
)
def test_pair_rows_int32_refuses(rows):
    with pytest.raises(ValueError):
        osum.pair_rows_int32(rows)


def test_tiled_shapes_are_the_bundle_adjustment_shape():
    """The source compiles K = 3, T1 = T2 = 9 as constants; the wrapper sends
    that shape and no other to the compile-time form, and has a staging depth
    for both element sizes whose two buffers fit a block's shared memory."""
    assert osum.TILED_SHAPES == {(3, 9, 9)}
    assert osum.THREADS % 32 == 0 and 32 <= osum.THREADS <= 1024
    for element_size, stage in osum.STAGE_PAIRS.items():
        assert 1 <= stage <= 32
        shared = 2 * stage * 54 * element_size * (osum.THREADS // 32)
        assert shared <= 227 * 1024
    assert set(osum.STAGE_PAIRS) == {4, 8}


def test_explicit_plan_hands_the_fused_kernel_int32_pair_lists(monkeypatch):
    """With the card's plan kinds, the strict-lower pair group of a BAL
    problem carries int32 pair lists (the fused kernel's), the self-pair
    group none, and the int32 lists index the slabs as the int64 ones did."""
    from ceres_tpu_torch.linear import schur as tschur
    from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan
    from ceres_tpu_torch.models import bal as tbal
    from ceres_tpu_torch.ops import reduce as tred

    choose = tred.choose_plan_kind
    monkeypatch.setattr(tred, "choose_plan_kind", lambda seg, G, _dev: choose(seg, G, "cuda"))
    inst = tbal.synthesize_bal(num_cameras=30, num_points=1500, num_observations=7000,
                               noise=2.0, perturb=0.7, seed=2)
    program = tbal.build_problem(inst)[0].program(torch.device("cpu"))
    plan = build_explicit_plan(program, tschur.build_schur_structure(program))
    fused = [g for g in plan.corr if not g.self_pairs and g.plan.kind == "sorted"]
    assert fused
    for g in fused:
        assert g.a_idx.dtype == torch.int32 and g.b_idx.dtype == torch.int32
        n = program.families[0].batch
        assert 0 <= int(g.a_idx.min()) and int(g.a_idx.max()) <= n
        assert int(g.plan.row_ptr[-1]) == g.a_idx.shape[0]
    for g in plan.corr:
        if g.self_pairs:
            assert g.a_idx.dtype == torch.int64
