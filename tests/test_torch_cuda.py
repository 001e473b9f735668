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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "B,G,tail",
    [(200000, 464, (81,)), (200000, 464, (9,)), (50001, 4095, (81,)), (9000, 288, (1,)),
     (30000, 1000, (3, 3)), (7, 500, (40,)), (0, 300, (3,))],
)
def test_unsorted_kernel_matches_plain(device, dtype, B, G, tail):
    rng = np.random.default_rng(B + G)
    seg = rng.integers(-2, G + 5, B)  # ids outside [0, G) go to the dummy row
    if B > 6000:
        seg[:5000] = 1  # one group far larger than the others
    ids = torch.from_numpy(seg.astype(np.int32)).to(device)
    contrib = torch.tensor(rng.standard_normal((B,) + tail), dtype=dtype, device=device)
    before = us.launches
    out = us.segment_sum_unsorted(contrib, ids, G)
    torch.cuda.synchronize()
    assert us.launches == before + (1 if B else 0)
    ref = us.segment_sum_unsorted_plain(contrib, ids, G)
    bound = RTOL[dtype] * us.segment_sum_unsorted_plain(contrib.abs(), ids, G)
    assert out.shape == (G + 1,) + tail and out.dtype == dtype
    assert bool(((out - ref).abs() <= bound).all())


def test_unsorted_wrapper_rejects_what_the_kernel_does_not_take(device):
    ids = torch.zeros(10, dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        us.segment_sum_unsorted(torch.ones(10, 2, dtype=torch.float16, device=device), ids, 10)
    with pytest.raises(ValueError, match="plan on"):
        us.segment_sum_unsorted(torch.ones(10, 2, device=device), ids.cpu(), 10)
    with pytest.raises(ValueError, match="int32"):
        us.segment_sum_unsorted(torch.ones(10, 2, device=device), ids.long(), 10)
    with pytest.raises(ValueError, match="groups"):
        us.segment_sum_unsorted(
            torch.ones(10, 2, device=device), ids, us.max_num_groups(torch.float32) + 1
        )


def test_unsorted_plan_on_cuda_launches_the_kernel(device):
    seg = np.random.default_rng(2).integers(0, 464, 50000)
    plan = tred.build_reduce_plan(seg, 464, device)
    assert plan.kind == "unsorted" and plan.seg.dtype == torch.int32
    assert plan.seg.device.type == "cuda"
    before = us.launches
    tred.apply_reduce(plan, torch.ones(50000, 9, device=device))
    assert us.launches == before + 1


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
