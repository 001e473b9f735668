"""K1 (sorted segment sum) and the reduce plans: the port's plain version
against the JAX package's Pallas kernels in interpret mode, and the port's
apply_reduce against ceres_tpu.ops.reduce.apply_reduce.

The Pallas kernels accumulate in f32 (``preferred_element_type``), so they
are compared in f32 at rtol 1e-4 (absolute floor 1e-4 x the output scale);
their dummy row G "may under-collect" (pallas_segment.py), so rows [:G] are
compared. The CUDA kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models import bal as jbal
from ceres_tpu.ops import pallas_segment as ps
from ceres_tpu.ops import reduce as jred
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.ops import segment_sum as ss

TILE_B = 512


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _plain(contrib, seg, G):
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, G))
    return ss.segment_sum_sorted(torch.from_numpy(contrib), row_ptr, G).numpy()


def _numpy_reference(contrib, seg, G):
    out = np.zeros((G + 1,) + contrib.shape[1:], np.float64)
    np.add.at(out, np.where((seg < 0) | (seg >= G), G, seg), contrib.astype(np.float64))
    return out


CASES = {
    "d1": (3000, 700, (1,)),
    "d3": (4100, 1500, (3,)),
    "d9": (2500, 300, (9,)),
    "d81": (1200, 200, (81,)),
    "tail_3x3": (3000, 700, (3, 3)),
}


def _case(name):
    B, G, tail = CASES[name]
    rng = np.random.default_rng(B + G)
    seg = np.sort(rng.integers(0, G, B))
    contrib = rng.standard_normal((B,) + tail).astype(np.float32)
    return seg, G, contrib


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_sorted_blocked(name):
    seg, G, contrib = _case(name)
    tiles, src, bof, lstart, maxp, S, nblk, Bp = ps.build_blocked_plan(
        seg, G, tile_b=TILE_B, seg_block=256
    )
    ref = ps.segment_sum_sorted_blocked(
        jnp.asarray(contrib), jnp.asarray(tiles), jnp.asarray(src),
        jnp.asarray(bof), jnp.asarray(lstart), G, maxp, S, nblk, Bp,
        tile_b=TILE_B, interpret=True,
    )
    _close(_plain(contrib, seg, G)[:G], np.asarray(ref)[:G], 1e-4)


@pytest.mark.parametrize("name", ["d1", "d9", "tail_3x3"])
def test_plain_matches_pallas_sorted(name):
    seg, G, contrib = _case(name)
    local, starts, maxp, _ = ps.build_sorted_plan(seg, G, tile_b=TILE_B)
    ref = ps.segment_sum_sorted(
        jnp.asarray(contrib), jnp.asarray(local), jnp.asarray(starts), G, maxp,
        tile_b=TILE_B, interpret=True,
    )
    _close(_plain(contrib, seg, G)[:G], np.asarray(ref)[:G], 1e-4)


def test_long_segment_and_dummy_ids_f64():
    """A segment of 5000 rows, empty segments, and ids >= G / < 0 that land
    in the dummy row G; f64 against a numpy sum (rtol 1e-12)."""
    rng = np.random.default_rng(3)
    G = 900
    seg = np.concatenate([
        np.full(5000, 4), np.sort(rng.integers(10, 600, 2000)), np.full(40, G + 7),
    ])
    contrib = rng.standard_normal((seg.size, 9))
    _close(_plain(contrib, seg, G), _numpy_reference(contrib, seg, G), 1e-12)
    with pytest.raises(ValueError, match="sorted"):
        ss.build_row_ptr(np.array([-1, 0, 1]), G)  # -1 maps to G: not sorted


def test_long_segment_matches_pallas_blocked():
    rng = np.random.default_rng(8)
    G = 2000
    seg = np.concatenate([np.zeros(4600, np.int64), np.sort(rng.integers(1, G, 1500))])
    contrib = rng.standard_normal((seg.size, 3)).astype(np.float32)
    tiles, src, bof, lstart, maxp, S, nblk, Bp = ps.build_blocked_plan(
        seg, G, tile_b=TILE_B
    )
    ref = ps.segment_sum_sorted_blocked(
        jnp.asarray(contrib), jnp.asarray(tiles), jnp.asarray(src),
        jnp.asarray(bof), jnp.asarray(lstart), G, maxp, S, nblk, Bp,
        tile_b=TILE_B, interpret=True,
    )
    _close(_plain(contrib, seg, G)[:G], np.asarray(ref)[:G], 1e-4)


@pytest.mark.parametrize(
    "jax_kind,B,G,sorted_ids",
    [
        ("onehot", 3000, 40, False),
        ("ell", 3000, 900, False),
        ("scatter", 6000, 500, True),  # one group of 5000 rows: fan-in > ELL cap
    ],
)
def test_apply_reduce_matches_jax_kinds(jax_kind, B, G, sorted_ids):
    rng = np.random.default_rng(B + G)
    seg = rng.integers(0, G, B)
    if jax_kind == "scatter":
        seg[:5000] = 3
    if sorted_ids:
        seg = np.sort(seg)
    contrib = rng.standard_normal((B, 3, 3))
    jplan = jred.build_reduce_plan(seg, G, allow_pallas=False)
    assert jplan.kind == jax_kind
    tplan = tred.build_reduce_plan(seg, G, "cpu")
    assert tplan.kind == ("onehot" if jax_kind == "onehot" else "scatter")
    out_t = tred.apply_reduce(tplan, torch.from_numpy(contrib)).numpy()
    out_j = np.asarray(jred.apply_reduce(jplan, jnp.asarray(contrib)))
    _close(out_t[:G], out_j[:G], 1e-10)


def test_apply_reduce_sorted_plan_on_cpu_tensors():
    """A 'sorted' plan applied to CPU tensors takes K1's plain version."""
    seg, G, contrib = _case("d3")
    plan = tred.ReducePlan(
        kind="sorted", num_groups=G, row_ptr=torch.from_numpy(ss.build_row_ptr(seg, G))
    )
    launches = ss.launches
    out = tred.apply_reduce(plan, torch.from_numpy(contrib.astype(np.float64)))
    assert ss.launches == launches  # no kernel launch for CPU tensors
    _close(out.numpy(), _numpy_reference(contrib, seg, G), 1e-12)


def test_choose_plan_kind_flagship_point_ids():
    inst = jbal.synthesize_bal(num_cameras=16, num_points=22106,
                               num_observations=83718, noise=2.0, perturb=0.7, seed=16)
    point_ids = np.sort(inst.point_index)  # build_problem orders observations by point
    assert tred.choose_plan_kind(point_ids, 22106, "cuda") == "sorted"
    assert tred.choose_plan_kind(point_ids, 22106, "cpu") == "scatter"
    cam_ids = inst.camera_index[np.argsort(inst.point_index, kind="stable")]
    assert tred.choose_plan_kind(cam_ids, 16, "cuda") == "onehot"


def test_choose_plan_kind_never_onehot_tiled():
    """The JAX package's ``onehot_tiled`` kind is called ``unsorted`` in the
    port (kernel K3): chosen on "cuda" for unsorted ids with
    288 < G+1 <= UNSORTED_MAX_GROUPS and B >= SORTED_MIN_ROWS, never on
    "cpu", and no kind carries the JAX name."""
    rng = np.random.default_rng(0)
    cap = tred.UNSORTED_MAX_GROUPS
    kinds = {"cpu": set(), "cuda": set()}
    for G in (10, 287, 288, 289, 1000, cap - 1, cap, 10 * cap):
        for B in (100, 4096, 20000):
            ids = rng.integers(0, G, B)
            for s in (ids, np.sort(ids)):
                for dev in ("cpu", "cuda"):
                    kinds[dev].add(tred.choose_plan_kind(s, G, dev))
            in_range = 288 < G + 1 <= cap and B >= tred.SORTED_MIN_ROWS
            assert (tred.choose_plan_kind(ids, G, "cuda") == "unsorted") == in_range
    assert kinds["cpu"] == {"onehot", "scatter"}
    assert kinds["cuda"] == {"onehot", "sorted", "unsorted", "scatter"}
    # G + 1 just above the one-hot cap, sorted, large B: the sorted kernel
    assert tred.choose_plan_kind(np.sort(rng.integers(0, 288, 9000)), 288, "cuda") == "sorted"
    # the same ids unsorted: the unsorted kernel; at G + 1 = cap + 1: index_add_
    assert tred.choose_plan_kind(rng.integers(0, 288, 9000), 288, "cuda") == "unsorted"
    assert tred.choose_plan_kind(rng.integers(0, cap, 9000), cap, "cuda") == "scatter"
    with pytest.raises(ValueError):
        tred.choose_plan_kind(np.arange(10), 5, "tpu")


def test_choose_plan_kind_large_case_ids():
    """The 464-camera / 200k-point / 1.2M-observation case: camera ids ->
    the unsorted kernel (K3), point ids -> the sorted kernel (K1)."""
    inst = jbal.synthesize_bal(num_cameras=464, num_points=200_000,
                               num_observations=1_200_000, noise=2.0, perturb=0.7, seed=7)
    order = np.argsort(inst.point_index, kind="stable")
    assert tred.choose_plan_kind(inst.point_index[order], 200_000, "cuda") == "sorted"
    assert tred.choose_plan_kind(inst.camera_index[order], 464, "cuda") == "unsorted"
    assert tred.choose_plan_kind(inst.camera_index[order], 464, "cpu") == "scatter"


def test_plan_and_tensor_on_different_devices_raise():
    seg, G, contrib = _case("d3")
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, G))
    on_meta = torch.empty(contrib.shape, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="plan on"):
        ss.segment_sum_sorted(on_meta, row_ptr, G)
    plan = tred.build_reduce_plan(seg, G, "cpu")
    with pytest.raises(ValueError, match="plan on"):
        tred.apply_reduce(plan, on_meta)


def _row_ptr_of(counts):
    return np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))]).astype(np.int32)


ROW_POINTER_CASES = {
    # the large case: every one of 200 000 points seen 6 times (+ empty dummy)
    "uniform_6_rows": np.r_[np.full(200_000, 6), 0],
    # the flagship: 3 or 4 rows a point
    "3_or_4_rows": np.r_[np.tile([3, 4, 4, 4], 5000), 0],
    "one_5000_row_segment": np.r_[5000, 0],
    "5000_rows_among_short_ones": np.r_[np.full(900, 4), 5000, np.full(900, 3), 0],
    "all_empty": np.zeros(50, np.int64),
    "mostly_empty": np.r_[np.zeros(4000, np.int64), 2, np.zeros(3000, np.int64), 7, 0],
    "mixed_short_and_medium": np.r_[np.full(3000, 3), np.full(10, 900)],
    "long_among_empty": np.r_[np.zeros(5000, np.int64), np.full(10, 1000)],
    "single_row": np.r_[1, 0],
    "rows_in_the_dummy_segment": np.r_[np.full(100, 5), 40],
}


@pytest.mark.parametrize("name", sorted(ROW_POINTER_CASES))
def test_row_pointer_and_sums_of_hand_made_segments(name):
    """Segment lengths of every kind the kernel meets (short and uniform,
    one long, empty, mixed): the row pointer built from the ids is the
    running sum of the lengths, and the sums over it are numpy's (f64,
    rtol 1e-12)."""
    counts = ROW_POINTER_CASES[name]
    G = counts.size - 1
    seg = np.repeat(np.arange(counts.size), counts)
    row_ptr = ss.build_row_ptr(seg, G)
    assert row_ptr.dtype == np.int32
    np.testing.assert_array_equal(row_ptr, _row_ptr_of(counts))
    contrib = np.random.default_rng(counts.size).standard_normal((seg.size, 3))
    out = ss.segment_sum_sorted(torch.from_numpy(contrib), torch.from_numpy(row_ptr), G)
    _close(out.numpy(), _numpy_reference(contrib, seg, G), 1e-12)


@pytest.mark.parametrize("case", ["flagship", "large"])
def test_bundle_adjustment_point_plans_hold_short_segments(case):
    """Both cases' point-side row pointers hold 3 to 6 rows a segment: the
    traffic the kernel's one thread per output element is built for."""
    sizes = {"flagship": (16, 22106, 83718, 16), "large": (464, 200_000, 1_200_000, 7)}
    cams, pts, obs, seed = sizes[case]
    inst = jbal.synthesize_bal(num_cameras=cams, num_points=pts,
                               num_observations=obs, noise=2.0, perturb=0.7, seed=seed)
    row_ptr = ss.build_row_ptr(np.sort(inst.point_index), pts)
    counts = np.diff(row_ptr)[:pts]
    assert counts.max() <= 6 and counts.min() >= 3
    assert row_ptr[-1] == obs and row_ptr[pts] == obs  # nothing in the dummy segment


def test_sorted_plans_of_short_and_long_segments(monkeypatch):
    """A 'sorted' plan is its row pointer, whatever the segments' lengths."""
    monkeypatch.setattr(tred, "choose_plan_kind", lambda seg, G, dev: "sorted")
    short = tred.build_reduce_plan(np.repeat(np.arange(2000), 4), 2000, "cpu")
    long = tred.build_reduce_plan(np.repeat(np.arange(3), 6000), 3, "cpu")
    assert short.kind == long.kind == "sorted"
    assert short.row_ptr.tolist()[-3:] == [7996, 8000, 8000]
    assert long.row_ptr.tolist() == [0, 6000, 12000, 18000, 18000]
    c = torch.ones(8000, 3, dtype=torch.float64)
    out = tred.apply_reduce(short, c)
    assert out.shape == (2001, 3) and float(out[:2000].min()) == 4.0
    out = tred.apply_reduce(long, torch.ones(18000, 2, dtype=torch.float64))
    assert out.tolist() == [[6000.0, 6000.0]] * 3 + [[0.0, 0.0]]


def test_block_size_is_a_launchable_one():
    assert 32 <= ss.THREADS <= 1024 and ss.THREADS % 32 == 0
