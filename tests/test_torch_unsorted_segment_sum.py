"""K3 (unsorted segment sum): the port's plain version, fed through the
host-built plan (rows of each segment, cut evenly into pieces), against the JAX
package's Pallas kernel ``segment_sum_onehot`` in interpret mode, on the
inputs of tests/test_pallas_segment.py, and against numpy in f64; and the
plan's arrays against numpy on hand-made ids.

The Pallas kernel accumulates in f32 in another order: rtol 2e-6, atol 1e-4
(the tolerance of the JAX package's own test), and within 1e-5 x the sum of
|contributions| of each segment. f64 against a numpy sum: 1e-12 of the
output scale. The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.ops import pallas_segment as ps
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.ops import unsorted_segment_sum as us


def _clamped(seg, G):
    return np.where((seg < 0) | (seg >= G), G, seg)


def _numpy_reference(contrib, seg, G):
    out = np.zeros((G + 1,) + contrib.shape[1:], np.float64)
    np.add.at(out, _clamped(seg, G), contrib.astype(np.float64))
    return out


def _plain(contrib, seg, G, max_pieces=None):
    plan = us.build_unsorted_plan(seg, G, "cpu", max_pieces)
    return us.segment_sum_unsorted(torch.from_numpy(contrib), plan).numpy()


@pytest.mark.parametrize("B,G,d", [(8192, 500, 81), (5000, 4000, 9)])
def test_plain_matches_pallas_onehot_tiled(B, G, d):
    rng = np.random.default_rng(B + G + d)
    seg = rng.integers(0, G, B)  # unsorted
    contrib = rng.standard_normal((B, d)).astype(np.float32)
    tiles, Bp = ps.build_tiled_plan(seg, G, tile_b=512)
    ref = np.asarray(ps.segment_sum_onehot(
        jnp.asarray(contrib), jnp.asarray(tiles), G, Bp, tile_b=512, interpret=True,
    ))
    out = _plain(contrib, seg, G)
    assert out.shape == (G + 1, d) and out.dtype == np.float32
    np.testing.assert_allclose(out[:G], ref[:G], rtol=2e-6, atol=1e-4)
    scale = _numpy_reference(np.abs(contrib), seg, G)
    assert np.all(np.abs(out[:G] - ref[:G]) <= 1e-5 * scale[:G])


@pytest.mark.parametrize(
    "B,G,tail",
    [(8192, 500, (81,)), (5000, 4000, (9,)), (3001, 464, (1,)), (2000, 300, (3, 3))],
)
def test_plain_matches_numpy_f64(B, G, tail):
    """f64, ids outside [0, G) (negative and >= G) land in the dummy row."""
    rng = np.random.default_rng(B + G)
    seg = rng.integers(-3, G + 5, B)
    contrib = rng.standard_normal((B,) + tail)
    ref = _numpy_reference(contrib, seg, G)
    np.testing.assert_allclose(
        _plain(contrib, seg, G), ref, rtol=0, atol=1e-12 * np.abs(ref).max()
    )


def test_unsorted_plan_on_cpu_tensors_takes_the_plain_version():
    """An 'unsorted' plan applied to CPU tensors reduces through K3's plain
    version and launches nothing; f64 against numpy at 1e-12."""
    rng = np.random.default_rng(5)
    B, G = 6000, 464
    seg = rng.integers(0, G, B)
    contrib = rng.standard_normal((B, 9))
    plan = tred.ReducePlan(
        kind="unsorted", num_groups=G, unsorted=us.build_unsorted_plan(seg, G, "cpu")
    )
    before = us.launches
    out = tred.apply_reduce(plan, torch.from_numpy(contrib)).numpy()
    assert us.launches == before
    ref = _numpy_reference(contrib, seg, G)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_wrapper_rejects_bad_plans():
    c = torch.zeros(10, 3)
    plan = us.build_unsorted_plan(np.zeros(10, np.int64), 5, "cpu")
    for index in (plan.perm, plan.piece_ptr, plan.seg_piece_ptr):
        assert index.dtype == torch.int32
    with pytest.raises(ValueError, match="rows"):
        us.segment_sum_unsorted(c, us.build_unsorted_plan(np.zeros(9, np.int64), 5, "cpu"))
    on_meta = torch.empty((10, 3), device="meta")
    with pytest.raises(ValueError, match="plan on"):
        us.segment_sum_unsorted(on_meta, plan)
    with pytest.raises(ValueError, match="int32"):
        us.UnsortedPlan(5, plan.perm.long(), plan.piece_ptr, plan.seg_piece_ptr)
    with pytest.raises(ValueError, match="G \\+ 2"):
        us.UnsortedPlan(6, plan.perm, plan.piece_ptr, plan.seg_piece_ptr)
    with pytest.raises(ValueError, match="max_pieces"):
        us.build_plan_arrays(np.zeros(10, np.int64), 5, 0)
    # no table in shared memory: the number of groups is not capped by one
    big = us.build_unsorted_plan(np.array([0, 70000, 3]), 10 * tred.UNSORTED_MAX_GROUPS, "cpu")
    out = us.segment_sum_unsorted(torch.ones(3, 2, dtype=torch.float64), big)
    assert out.shape == (10 * tred.UNSORTED_MAX_GROUPS + 1, 2) and float(out.sum()) == 6.0


HAND_MADE_IDS = {
    # name: (ids, G, max_pieces)
    "empty_segments": (np.array([5, 1, 5, 5, 9, 1, 5]), 12, 2),
    "all_rows_in_one_segment": (np.full(1100, 3), 6, 4),
    "ids_outside_the_range": (np.array([-1, 2, 7, 0, 99, 2, -5, 6]), 7, 3),
    "one_row": (np.array([2]), 4, 32),
    "no_rows": (np.zeros(0, np.int64), 4, 32),
    "more_segments_than_pieces_allowed": (np.arange(400) % 5, 5, 2),
    "1300_rows_in_three_segments": (np.arange(1300) % 3, 3, 30),
    "more_pieces_allowed_than_rows": (np.arange(400) % 7, 7, 100000),
    "all_rows_in_the_dummy_segment": (np.full(900, 50), 5, 4),
    "sorted_ids": (np.repeat(np.arange(6), [0, 300, 0, 700, 1, 200]), 6, 9),
    "one_long_segment_among_short_ones": (np.r_[np.arange(600) % 60, np.full(5000, 7)], 60, 80),
}


@pytest.mark.parametrize("name", sorted(HAND_MADE_IDS))
def test_plan_arrays_of_hand_made_ids(name):
    """``perm`` lists each segment's rows in ascending order, segment after
    segment; pieces tile it, none across two segments; a segment of n rows
    is cut evenly into ceil(n / L) pieces, L the least length (from 32 up)
    that keeps the number of pieces within ``max_pieces`` where one piece
    per segment does; the plan gives back the ids it was built from; and the
    sums through it are numpy's (f64, 1e-12)."""
    seg, G, max_pieces = HAND_MADE_IDS[name]
    B = seg.size
    perm, piece_ptr, seg_piece_ptr = us.build_plan_arrays(seg, G, max_pieces)
    assert perm.dtype == piece_ptr.dtype == seg_piece_ptr.dtype == np.int32
    ids = _clamped(seg, G)
    np.testing.assert_array_equal(perm, np.argsort(ids, kind="stable"))
    counts = np.bincount(ids, minlength=G + 1)
    L = us.piece_rows_for(counts, max_pieces)
    assert L >= us.MIN_PIECE_ROWS
    np.testing.assert_array_equal(np.diff(seg_piece_ptr), -(-counts // L))
    assert seg_piece_ptr.shape == (G + 2,) and seg_piece_ptr[0] == 0
    num_pieces = int(seg_piece_ptr[-1])
    assert num_pieces <= max(max_pieces, np.count_nonzero(counts))
    if L > us.MIN_PIECE_ROWS:  # one row shorter and the pieces would be too many
        assert int((-(-counts // (L - 1))).sum()) > max_pieces
    assert piece_ptr.shape == (num_pieces + 1,) and piece_ptr[-1] == B
    lengths = np.diff(piece_ptr)
    assert np.all(lengths >= 1) and np.all(lengths <= L)
    for g in range(G + 1):
        rows = perm[piece_ptr[seg_piece_ptr[g]]:piece_ptr[seg_piece_ptr[g + 1]]]
        np.testing.assert_array_equal(rows, np.flatnonzero(ids == g))
        mine = lengths[seg_piece_ptr[g]:seg_piece_ptr[g + 1]]
        assert mine.size == 0 or mine.max() - mine.min() <= 1  # an even cut
    plan = us.build_unsorted_plan(seg, G, "cpu", max_pieces)
    np.testing.assert_array_equal(plan.segment_ids().numpy(), ids)
    assert (plan.num_rows, plan.num_pieces) == (B, num_pieces)
    contrib = np.random.default_rng(B).standard_normal((B, 4))
    out = us.segment_sum_unsorted(torch.from_numpy(contrib), plan).numpy()
    ref = _numpy_reference(contrib, seg, G)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("max_pieces", [1, 7, 64, 280, 100000])
def test_sums_do_not_depend_on_the_number_of_pieces_f64(max_pieces):
    rng = np.random.default_rng(max_pieces)
    seg = rng.integers(-2, 470, 9001)
    seg[:3000] = 17  # one long segment
    contrib = rng.standard_normal((9001, 9))
    ref = _numpy_reference(contrib, seg, 464)
    out = _plain(contrib, seg, 464, max_pieces)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_piece_rows_for():
    """The large case: 465 segments of about 2586 rows within the 5280 warps
    that 132 SMs hold take 11 pieces each, of 236 rows at the most."""
    assert us.DEFAULT_SMS * us.WARPS_PER_SM == 5280
    assert us.piece_rows_for(np.full(465, 2586), 5280) == 236
    assert us.piece_rows_for(np.full(465, 2586), 465) == 2586
    assert us.piece_rows_for(np.full(465, 2586), 464) == 2586  # one piece each at the least
    assert us.piece_rows_for(np.full(465, 2586), 10**9) == us.MIN_PIECE_ROWS
    assert us.piece_rows_for(np.zeros(5, np.int64), 10) == us.MIN_PIECE_ROWS
    assert us.piece_rows_for(np.zeros(0, np.int64), 10) == us.MIN_PIECE_ROWS
    assert us.piece_rows_for(np.array([5, 1000, 3]), 4) == 500
    assert us.piece_rows_for(np.array([5, 1000, 3]), 3) == 1000
    plan = us.build_unsorted_plan(np.arange(1_200_000) % 464, 464, "cpu")
    assert 5280 - 464 <= plan.num_pieces <= 5280
    lengths = (plan.piece_ptr[1:] - plan.piece_ptr[:-1]).numpy()
    assert lengths.max() - lengths.min() <= 1
