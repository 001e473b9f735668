"""Tests that need an NVIDIA GPU: the CUDA kernels (sorted segment sum K1,
unsorted segment sum K3, fused pair-outer segment sum K4) against their
plain versions on the card, the plan choice on a CUDA device, and a
DENSE_SCHUR solve whose plans reach all three kernels. Skipped without a
card.

This file imports neither jax nor ceres_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.ops import segment_sum as ss
from ceres_tpu_torch.ops import unsorted_segment_sum as us

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


# Summation-order tolerance relative to the sum of |contributions| per
# segment: the kernel and index_add_ add the same terms in other orders.
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "B,G,tail",
    [(83718, 22106, (3,)), (83718, 22106, (9,)), (5001, 40000, (24,)),
     (9000, 288, (1,)), (7000, 600, (81,)), (3000, 700, (3, 3)), (0, 10, (3,))],
)
def test_kernel_matches_plain(device, dtype, B, G, tail):
    rng = np.random.default_rng(B + G)
    seg = np.sort(rng.integers(0, G + 5, B))  # ids >= G go to the dummy row
    if B > 6000:
        seg[:5000] = 0  # one segment longer than 4096 rows
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, G)).to(device)
    contrib = torch.tensor(rng.standard_normal((B,) + tail), dtype=dtype, device=device)
    before = ss.launches
    out = ss.segment_sum_sorted(contrib, row_ptr, G)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    ref = ss.segment_sum_sorted_plain(contrib, row_ptr, G)
    bound = RTOL[dtype] * ss.segment_sum_sorted_plain(contrib.abs(), row_ptr, G)
    assert out.shape == (G + 1,) + tail and out.dtype == dtype
    assert bool(((out - ref).abs() <= bound).all())


def test_kernel_is_deterministic(device):
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 5000, 60000))
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, 5000)).to(device)
    c = torch.tensor(rng.standard_normal((60000, 9)), dtype=torch.float32, device=device)
    a = ss.segment_sum_sorted(c, row_ptr, 5000)
    b = ss.segment_sum_sorted(c, row_ptr, 5000)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", [3, 9, 5])
def test_each_sorted_kernel_is_deterministic(device, dtype, d):
    """The compile-time widths (3, 9) and a run-time one: the same bits on
    every launch, and a sum is its rows added one after another in their
    stored order."""
    rng = np.random.default_rng(d)
    seg = np.sort(rng.integers(0, 30000, 150000))
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, 30000)).to(device)
    c = torch.tensor(rng.standard_normal((150000, d)), dtype=dtype, device=device)
    a = ss.segment_sum_sorted(c, row_ptr, 30000)
    b = ss.segment_sum_sorted(c, row_ptr, 30000)
    assert torch.equal(a, b)
    for g in (17, 4242, 29999):
        lo, hi = int(row_ptr[g]), int(row_ptr[g + 1])
        acc = torch.zeros(d, dtype=dtype, device=device)
        for r in range(lo, hi):
            acc = acc + c[r]
        assert torch.equal(a[g], acc)


@pytest.mark.parametrize(
    "counts",
    [np.full(50000, 6), np.r_[np.full(20000, 4), 9000], np.r_[np.full(5, 7000), np.zeros(300, np.int64)],
     np.r_[np.full(20000, 3), np.full(5, 800), np.zeros(300, np.int64)]],
    ids=["short", "one_long", "all_long", "mixed"],
)
def test_short_long_and_mixed_segments_match_plain(device, counts):
    """Short segments, long ones and a mix: the launch through the reduce
    plan agrees with the plain version."""
    seg = np.repeat(np.arange(counts.size), counts)
    G = counts.size
    plan = tred.build_reduce_plan(seg, G, device)
    assert plan.kind == "sorted"
    rng = np.random.default_rng(counts.size)
    for dtype in (torch.float32, torch.float64):
        c = torch.tensor(rng.standard_normal((seg.size, 3)), dtype=dtype, device=device)
        out = tred.apply_reduce(plan, c)
        ref = ss.segment_sum_sorted_plain(c, plan.row_ptr, G)
        bound = RTOL[dtype] * ss.segment_sum_sorted_plain(c.abs(), plan.row_ptr, G)
        assert bool(((out - ref).abs() <= bound).all())


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    row_ptr = torch.from_numpy(ss.build_row_ptr(np.arange(10), 10)).to(device)
    with pytest.raises(TypeError):
        ss.segment_sum_sorted(torch.ones(10, 2, dtype=torch.float16, device=device), row_ptr, 10)
    with pytest.raises(ValueError, match="plan on"):
        ss.segment_sum_sorted(torch.ones(10, 2, device=device), row_ptr.cpu(), 10)
    with pytest.raises(ValueError, match="int32"):
        ss.segment_sum_sorted(torch.ones(10, 2, device=device), row_ptr.long(), 10)


def test_sorted_plan_on_cuda_launches_the_kernel(device):
    seg = np.sort(np.random.default_rng(1).integers(0, 20000, 50000))
    plan = tred.build_reduce_plan(seg, 20000, device)
    assert plan.kind == "sorted" and plan.row_ptr.device.type == "cuda"
    before = ss.launches
    tred.apply_reduce(plan, torch.ones(50000, 3, device=device))
    assert ss.launches == before + 1


# ---- K3 ---------------------------------------------------------------------


def _unsorted_case(device, dtype, B, G, tail, seed=None):
    rng = np.random.default_rng(B + G if seed is None else seed)
    seg = rng.integers(-2, G + 5, B)  # ids outside [0, G) go to the dummy row
    if B > 6000:
        seg[:5000] = 1  # one group far larger than the others
    plan = us.build_unsorted_plan(seg, G, device)
    contrib = torch.tensor(rng.standard_normal((B,) + tail), dtype=dtype, device=device)
    return plan, contrib


def _assert_unsorted_matches_plain(plan, contrib):
    out = us.segment_sum_unsorted(contrib, plan)
    torch.cuda.synchronize()
    ref = us.segment_sum_unsorted_plain(contrib, plan)
    bound = RTOL[contrib.dtype] * us.segment_sum_unsorted_plain(contrib.abs(), plan)
    assert out.shape == (plan.num_groups + 1,) + tuple(contrib.shape[1:])
    assert out.dtype == contrib.dtype
    assert bool(((out - ref).abs() <= bound).all())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "B,G,tail",
    [(200000, 464, (81,)), (200000, 464, (9,)), (50001, 4095, (81,)), (9000, 288, (1,)),
     (30000, 1000, (3, 3)), (7, 500, (40,)), (0, 300, (3,)), (70001, 464, (100,)),
     (60000, 65535, (3,)), (100003, 464, (1,))],
)
def test_unsorted_kernel_matches_plain(device, dtype, B, G, tail):
    """The compile-time widths (9 and 81, also as a (3, 3) tail) and
    run-time ones (1, 3, 40, 100: one and several column groups)."""
    plan, contrib = _unsorted_case(device, dtype, B, G, tail)
    before = us.launches
    _assert_unsorted_matches_plain(plan, contrib)
    assert us.launches == before + (1 if B else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", [9, 81])
@pytest.mark.parametrize("form", ["compile_time", "run_time"])
def test_unsorted_kernel_both_forms_match_plain(device, dtype, d, form, monkeypatch):
    """d = 9 and 81 through the compile-time form and, with the list of
    compiled widths emptied, through the run-time form."""
    if form == "run_time":
        monkeypatch.setattr(us, "COMPILED_WIDTHS", frozenset())
    plan, contrib = _unsorted_case(device, dtype, 120000, 464, (d,))
    _assert_unsorted_matches_plain(plan, contrib)


UNSORTED_EDGE_CASES = {
    "all_rows_in_one_group": (np.full(50000, 3), 464, 9),
    "dummy_row": (np.random.default_rng(3).integers(-5, 700, 30000), 600, 9),
    "G_plus_1_is_289": (np.random.default_rng(4).integers(0, 288, 20000), 288, 81),
    "sorted_ids": (np.sort(np.random.default_rng(5).integers(0, 900, 40000)), 900, 81),
    "empty_groups": (np.random.default_rng(6).integers(0, 4000, 5000) // 7 * 7, 4000, 9),
}


@pytest.mark.parametrize("name", sorted(UNSORTED_EDGE_CASES))
def test_unsorted_kernel_edge_cases(device, name):
    seg, G, d = UNSORTED_EDGE_CASES[name]
    plan = us.build_unsorted_plan(seg, G, device)
    rng = np.random.default_rng(len(name))
    for dtype in (torch.float32, torch.float64):
        c = torch.tensor(rng.standard_normal((seg.size, d)), dtype=dtype, device=device)
        _assert_unsorted_matches_plain(plan, c)


@pytest.mark.parametrize("max_pieces", [1, 300, 450, 1249, 1251, 5280, 100000])
def test_unsorted_kernel_any_number_of_pieces(device, max_pieces):
    """From one piece per segment (thousands of rows in one warp) down to
    the shortest pieces the plan cuts (a batch of 32 rows, more or less a
    row), and the card's own number."""
    rng = np.random.default_rng(max_pieces)
    seg = rng.integers(0, 300, 40000)
    seg[:9000] = 5
    plan = us.build_unsorted_plan(seg, 300, device, max_pieces)
    for d in (9, 81, 5):
        for dtype in (torch.float32, torch.float64):
            c = torch.tensor(rng.standard_normal((40000, d)), dtype=dtype, device=device)
            _assert_unsorted_matches_plain(plan, c)


def test_unsorted_kernel_many_tiny_segments(device):
    """More segments than the card holds warps: pieces of one or two rows."""
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 30000, 50000)
    plan = us.build_unsorted_plan(seg, 30000, device)
    for d in (9, 81, 3):
        c = torch.tensor(rng.standard_normal((50000, d)), dtype=torch.float64, device=device)
        _assert_unsorted_matches_plain(plan, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", [9, 81, 5, 40])
def test_unsorted_kernel_is_deterministic(device, dtype, d):
    """No atomics: twice on the same input, the same bits."""
    plan, contrib = _unsorted_case(device, dtype, 150000, 464, (d,), seed=d)
    first = us.segment_sum_unsorted(contrib, plan)
    second = us.segment_sum_unsorted(contrib, plan)
    assert torch.equal(first, second)


def test_unsorted_wrapper_rejects_what_the_kernel_does_not_take(device):
    plan = us.build_unsorted_plan(np.zeros(10, np.int64), 10, device)
    with pytest.raises(TypeError):
        us.segment_sum_unsorted(torch.ones(10, 2, dtype=torch.float16, device=device), plan)
    with pytest.raises(ValueError, match="plan on"):
        us.segment_sum_unsorted(
            torch.ones(10, 2, device=device), us.build_unsorted_plan(np.zeros(10, np.int64), 10, "cpu")
        )
    with pytest.raises(ValueError, match="rows"):
        us.segment_sum_unsorted(torch.ones(9, 2, device=device), plan)


def test_unsorted_plan_on_cuda_launches_the_kernel(device):
    seg = np.random.default_rng(2).integers(0, 464, 50000)
    plan = tred.build_reduce_plan(seg, 464, device)
    assert plan.kind == "unsorted" and plan.unsorted.perm.dtype == torch.int32
    assert plan.unsorted.device.type == "cuda"
    before, by_width = us.launches, dict(us.launches_by_width)
    tred.apply_reduce(plan, torch.ones(50000, 9, device=device))
    tred.apply_reduce(plan, torch.ones(50000, 3, 3, device=device))
    tred.apply_reduce(plan, torch.ones(50000, 81, device=device))
    assert us.launches == before + 3
    assert us.launches_by_width[9] == by_width.get(9, 0) + 2
    assert us.launches_by_width[81] == by_width.get(81, 0) + 1


# ---- K4 ---------------------------------------------------------------------


def _outer_inputs(rng, device, dtype, Pp, N, K, T1, T2):
    """Slabs with a zero pad row N and int32 pair rows into them."""
    a = torch.from_numpy(osum.pair_rows_int32(rng.integers(0, N + 1, Pp))).to(device)
    b = torch.from_numpy(osum.pair_rows_int32(rng.integers(0, N + 1, Pp))).to(device)
    W = torch.tensor(rng.standard_normal((N + 1, K * T1)), dtype=dtype, device=device)
    Y = torch.tensor(rng.standard_normal((N + 1, K * T2)), dtype=dtype, device=device)
    W[N] = 0.0
    Y[N] = 0.0
    return W, Y, a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "Pp,G,N,K,T1,T2",
    [(300000, 20000, 60000, 3, 9, 9), (20000, 700, 5000, 3, 9, 6), (4000, 300, 800, 2, 12, 12),
     (3000, 4000, 900, 1, 1, 1), (0, 10, 20, 3, 9, 9)],
)
def test_outer_kernel_matches_plain(device, dtype, Pp, G, N, K, T1, T2):
    rng = np.random.default_rng(Pp + G)
    cells = np.sort(rng.integers(0, G, Pp))
    if Pp > 6000:
        cells[:5000] = cells[0]  # one cell with thousands of pairs
    row_ptr = torch.from_numpy(ss.build_row_ptr(cells, G)).to(device)
    W, Y, a, b = _outer_inputs(rng, device, dtype, Pp, N, K, T1, T2)
    before = osum.launches
    out = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2)
    torch.cuda.synchronize()
    assert osum.launches == before + 1
    ref = osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, K, T1, T2)
    bound = RTOL[dtype] * osum.outer_segment_sum_plain(
        W.abs(), Y.abs(), a, b, row_ptr, G, K, T1, T2
    )
    assert out.shape == (G + 1, T1 * T2) and out.dtype == dtype
    assert bool(((out - ref).abs() <= bound).all())
    again = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, K, T1, T2)
    assert torch.equal(out, again)  # fixed order: the same bits on every run


def _outer_case(device, dtype, seed=11):
    """K = 3, 9 x 9 at cells of 0 to ~60 pairs, one of 5000."""
    rng = np.random.default_rng(seed)
    Pp, G, N = 120000, 4000, 30000
    cells = np.sort(rng.integers(0, G, Pp))
    cells[:5000] = cells[0]
    row_ptr = torch.from_numpy(ss.build_row_ptr(cells, G)).to(device)
    return _outer_inputs(rng, device, dtype, Pp, N, 3, 9, 9) + (row_ptr, G)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("form", ["compile_time", "run_time"])
def test_outer_kernel_both_forms_match_plain(device, dtype, form, monkeypatch):
    """K = 3, 9 x 9 through the compile-time form and, with that form's
    shape list emptied, through the run-time form: both against the plain
    version."""
    if form == "run_time":
        monkeypatch.setattr(osum, "TILED_SHAPES", frozenset())
    W, Y, a, b, row_ptr, G = _outer_case(device, dtype)
    out = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, 3, 9, 9)
    torch.cuda.synchronize()
    ref = osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, 3, 9, 9)
    bound = RTOL[dtype] * osum.outer_segment_sum_plain(
        W.abs(), Y.abs(), a, b, row_ptr, G, 3, 9, 9
    )
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("stage", [1, 2, 3, 7, 9, 16, 32])
def test_outer_kernel_any_staging_depth(device, dtype, stage, monkeypatch):
    """The compile-time form is right at every staging depth it accepts."""
    monkeypatch.setattr(osum, "STAGE_PAIRS", {4: stage, 8: stage})
    monkeypatch.setattr(osum, "THREADS", 128)
    W, Y, a, b, row_ptr, G = _outer_case(device, dtype, seed=stage)
    out = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, 3, 9, 9)
    torch.cuda.synchronize()
    ref = osum.outer_segment_sum_plain(W, Y, a, b, row_ptr, G, 3, 9, 9)
    bound = RTOL[dtype] * osum.outer_segment_sum_plain(
        W.abs(), Y.abs(), a, b, row_ptr, G, 3, 9, 9
    )
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("form", ["compile_time", "run_time"])
def test_outer_kernel_is_deterministic(device, dtype, form, monkeypatch):
    """Twice on the same inputs: the same bits (a warp adds its cell's pairs
    in a fixed order; no atomics)."""
    if form == "run_time":
        monkeypatch.setattr(osum, "TILED_SHAPES", frozenset())
    W, Y, a, b, row_ptr, G = _outer_case(device, dtype, seed=5)
    first = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, 3, 9, 9)
    second = osum.outer_segment_sum(W, Y, a, b, row_ptr, G, 3, 9, 9)
    assert torch.equal(first, second)


def test_outer_wrapper_rejects_int64_pair_lists(device):
    W = torch.zeros(5, 27, device=device)
    idx = torch.zeros(4, dtype=torch.int64, device=device)
    row_ptr = torch.from_numpy(ss.build_row_ptr(np.zeros(4, np.int64), 3)).to(device)
    with pytest.raises(ValueError, match="int32"):
        osum.outer_segment_sum(W, W, idx, idx, row_ptr, 3, 3, 9, 9)


# ---- the DENSE_SCHUR path ---------------------------------------------------


def test_dense_schur_solve_reaches_all_three_kernels(device):
    """300 cameras / 8000 points / 48000 observations: point-side plans are
    'sorted' (K1), camera-side ones 'unsorted' (K3), the strict-lower pair
    group goes through K4; f64 final cost equals the CPU solve's (plain
    versions) to 1e-9 relative."""
    inst = bal.synthesize_bal(num_cameras=300, num_points=8000, num_observations=48000,
                              noise=2.0, perturb=0.7, seed=5)
    opts = bal.default_options(iterative=False)
    opts.max_num_iterations = 6
    on_cpu = ctt.fused_solve(opts, bal.build_problem(inst)[0], device="cpu")
    problem = bal.build_problem(inst)[0]
    before = (ss.launches, us.launches, osum.launches)
    on_card = ctt.fused_solve(opts, problem)  # the default device is the card
    after = (ss.launches, us.launches, osum.launches)
    assert all(x > y for x, y in zip(after, before))
    assert on_card.num_iterations == on_cpu.num_iterations
    assert on_card.num_successful_steps == on_cpu.num_successful_steps
    assert on_card.final_cost < 1e-2 * on_card.initial_cost
    np.testing.assert_allclose(on_card.final_cost, on_cpu.final_cost, rtol=1e-9)
    assert np.all(np.isfinite(problem.state()))
