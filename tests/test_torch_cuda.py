"""Tests that need an NVIDIA GPU: the CUDA kernels (sorted segment sum K1,
unsorted segment sum K3, fused pair-outer segment sum K4) against their
plain versions on the card, the plan choice on a CUDA device, a
DENSE_SCHUR solve whose plans reach all three kernels, an implicit-S
ITERATIVE_SCHUR step that reaches K1 and K3 and not K4, and the modeling API
on the card against the CPU (robust BAL with a constant camera, a pose
graph, the dense solvers and CGNR, ``Problem.evaluate``), a bounded solve
through the host-loop minimizer, and the sparse solvers and cluster
preconditioners on the card against the CPU; the fused loop captured as
CUDA graphs under every option set it takes (the cluster preconditioners
and SUBSET among them), the matrix-free covariance's batched CG and
TinySolver captured, each against the same loop run eagerly, to the bit;
the host loop's device work captured (``host_loop_graphs``: progress
output, bounds, an evaluation callback with non-monotonic steps, DOGLEG,
inner iterations) against its regions run eagerly, to the bit, and the
Evaluator's three entry points from their graphs. Skipped without a card.

This file imports neither jax nor ceres_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import schur
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.ops import segment_sum as ss
from ceres_tpu_torch.ops import unsorted_segment_sum as us
from ceres_tpu_torch.trust_region import _config_from_options, _lm_damping

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


def test_implicit_schur_solve_reaches_k1_and_k3_not_k4(device):
    """ITERATIVE_SCHUR above nf = 2048 (300 cameras: nf = 2700) on a CUDA
    tensor: no S is assembled, so every S x runs K1 (point side) and K3
    (camera side) and K4 never launches; the step, its CG count and its
    termination equal the CPU's (plain versions; f64, steps to 1e-9)."""
    inst = bal.synthesize_bal(num_cameras=300, num_points=8000, num_observations=48000,
                              noise=2.0, perturb=0.7, seed=5)
    cfg = _config_from_options(bal.default_options(iterative=True))
    steps = []
    for dev in ("cpu", device):
        prog = bal.build_problem(inst)[0].program(dev)
        x = torch.from_numpy(prog.initial_ambient()).to(dev)
        _, _, ctx = _full_impl(x, prog.families, prog.num_tangent, prog.groups)
        D = _lm_damping(torch.clamp(ctx.squared_column_norms(), 1e-6, 1e32),
                        torch.tensor(1e4, dtype=torch.float64, device=dev))
        ss_ = schur.build_schur_structure(prog)
        assert ss_.explicit is None and ss_.f_idx.shape[0] == 2700
        before = (ss.launches, us.launches, osum.launches)
        steps.append(schur.solve_schur(ctx, D, cfg, ss_))
        torch.cuda.synchronize()
        k1, k3, k4 = (a - b for a, b in zip((ss.launches, us.launches, osum.launches), before))
    assert ss_.e_plan[0].kind == "sorted" and ss_.f_plan[0][0].kind == "unsorted"
    assert k1 > 0 and k3 > 0 and k4 == 0
    (y_cpu, it_cpu, t_cpu), (y_card, it_card, t_card) = steps
    assert int(it_card) == int(it_cpu) > 1 and int(t_card) == int(t_cpu)
    scale = float(y_cpu.abs().max())
    assert float((y_card.cpu() - y_cpu).abs().max()) <= 1e-9 * scale


def test_host_loop_bounded_solve_on_the_card(device):
    """A bounded DENSE_SCHUR solve through ``ctt.solve`` (the host loop: LM
    step, projected line search, clamp) on a CUDA tensor: K1 launches, every
    point's z stays in [-1, 1] with some bounds active, and the records
    equal the CPU's (plain versions; f64, costs to 1e-9 relative)."""
    inst = bal.synthesize_bal(num_cameras=300, num_points=8000, num_observations=48000,
                              noise=2.0, perturb=0.7, seed=5)
    inst.points[:, 2] = np.clip(inst.points[:, 2], -1.0, 1.0)
    summaries = []
    for dev in ("cpu", device):
        problem, _, pts = bal.build_problem(inst)
        for pid in pts:
            problem.set_parameter_lower_bound(int(pid), 2, -1.0)
            problem.set_parameter_upper_bound(int(pid), 2, 1.0)
        opts = bal.default_options(iterative=False)
        opts.max_num_iterations = 5
        before = ss.launches
        summaries.append(ctt.solve(opts, problem, device=dev))
        z = problem.state()[-3 * len(pts) + 2::3]
        assert np.all(np.abs(z) <= 1.0) and np.sum(np.abs(z) == 1.0) > 0
    assert ss.launches > before
    on_cpu, on_card = summaries
    assert on_card.is_solution_usable() and on_card.final_cost < 0.1 * on_card.initial_cost
    assert len(on_card.iterations) == len(on_cpu.iterations)
    for a, b in zip(on_card.iterations, on_cpu.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-9)
        assert a.step_is_successful == b.step_is_successful


# ---- the modeling API on the card ---------------------------------------------


@pytest.mark.parametrize("iterative", [True, False], ids=["iterative_schur", "dense_schur"])
def test_robust_bal_on_the_card_matches_the_cpu(device, iterative):
    """The canonical drive (8 / 500 / 2000, seed 42, HuberLoss(1.0), f64)
    with one constant camera: the card's records equal the CPU's (costs to
    1e-9 relative)."""
    inst = bal.synthesize_bal(num_cameras=8, num_points=500, num_observations=2000, seed=42)
    summaries = []
    for dev in ("cpu", device):
        problem, cams, _ = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))
        problem.set_parameter_block_constant(int(cams[0]))
        summaries.append(ctt.solve(bal.default_options(iterative=iterative), problem, device=dev))
        assert np.all(np.isfinite(problem.state()))
    on_cpu, on_card = summaries
    assert on_card.device.startswith("cuda") and on_card.termination_type.name == "CONVERGENCE"
    assert len(on_card.iterations) == len(on_cpu.iterations)
    for a, b in zip(on_card.iterations, on_cpu.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-9)
        assert a.step_is_successful == b.step_is_successful


def test_pose_graph_on_the_card_matches_the_cpu(device):
    """A 120-pose sphere with CGNR + block Jacobi (manifold plus, constant
    first pose, index_add_ reductions): the card converges where the CPU
    does, to the same cost within CG's rounding (1e-6 relative)."""
    from ceres_tpu_torch.models import pose_graph

    graph = pose_graph.synthesize_sphere(120, seed=3)[:3]
    on_cpu = ctt.solve(pose_graph.default_options(),
                       pose_graph.build_problem_3d(*graph)[0], device="cpu")
    problem = pose_graph.build_problem_3d(*graph)[0]
    on_card = ctt.solve(pose_graph.default_options(), problem)
    assert on_card.termination_type.name == on_cpu.termination_type.name == "CONVERGENCE"
    assert len(on_card.iterations) == len(on_cpu.iterations)
    np.testing.assert_allclose(on_card.final_cost, on_cpu.final_cost, rtol=1e-6)
    quats = np.stack([problem.parameter_block_value(i) for i in problem.parameter_block_ids()[1::2]])
    np.testing.assert_allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("solver", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "CGNR"])
def test_dense_and_cgnr_solvers_on_the_card(device, solver):
    inst = bal.synthesize_bal(num_cameras=5, num_points=60, num_observations=240,
                              noise=2.0, perturb=0.5, seed=9)
    costs = []
    for dev in ("cpu", device):
        problem, cams, _ = bal.build_problem(inst, loss=ctt.CauchyLoss(2.0))
        problem.set_parameter_block_constant(cams[:2])
        opts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType[solver],
                                 max_num_iterations=30)
        s = ctt.solve(opts, problem, device=dev)
        assert s.is_solution_usable()
        costs.append(s.final_cost)
    np.testing.assert_allclose(costs[1], costs[0], rtol=1e-6)


@pytest.mark.parametrize("changes", [
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"),
    dict(linear_solver_type="SPARSE_SCHUR"),
    dict(linear_solver_type="SPARSE_SCHUR", use_mixed_precision_solves=True,
         max_num_refinement_iterations=3),
    dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="CLUSTER_JACOBI"),
    dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="CLUSTER_TRIDIAGONAL"),
], ids=["sparse_normal_cholesky", "sparse_schur", "sparse_schur_mixed", "cluster_jacobi",
        "cluster_tridiagonal"])
def test_sparse_solvers_and_clusters_on_the_card(device, changes):
    """The host-factored sparse solvers (cells reduced on the card, factored
    by the native core) and the cluster preconditioners take the CPU's
    records on the card (f64, costs to 1e-9 relative)."""
    inst = bal.synthesize_bal(num_cameras=12, num_points=400, num_observations=1600,
                              noise=2.0, perturb=0.7, seed=5)
    summaries = []
    for dev in ("cpu", device):
        opts = bal.default_options(iterative=True)
        for k, v in changes.items():
            enum = {"linear_solver_type": ctt.LinearSolverType,
                    "preconditioner_type": ctt.PreconditionerType}.get(k)
            setattr(opts, k, enum[v] if enum else v)
        summaries.append(ctt.solve(opts, bal.build_problem(inst)[0], device=dev))
    on_cpu, on_card = summaries
    assert on_card.device.startswith("cuda") and on_card.is_solution_usable()
    assert len(on_card.iterations) == len(on_cpu.iterations) > 2
    for a, b in zip(on_card.iterations, on_cpu.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-9)


def test_evaluate_on_the_card_matches_the_cpu(device):
    inst = bal.synthesize_bal(num_cameras=4, num_points=50, num_observations=200, seed=1)
    problem, cams, _ = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))
    problem.set_parameter_block_constant(int(cams[1]))
    on_card = problem.evaluate(residuals=True, gradient=True, jacobian=True)
    on_cpu = problem.evaluate(residuals=True, gradient=True, jacobian=True, device="cpu")
    np.testing.assert_allclose(on_card["cost"], on_cpu["cost"], rtol=1e-12)
    for key in ("residuals", "gradient", "jacobian"):
        np.testing.assert_allclose(on_card[key], on_cpu[key], rtol=1e-9, atol=1e-9)
    block = problem.evaluate_residual_block(3)
    np.testing.assert_allclose(block["cost"], problem.evaluate_residual_block(3, device="cpu")["cost"],
                               rtol=1e-12)


def test_run_if_nests_inside_a_captured_graph(device):
    """Nested IF nodes: each body runs only where its predicate is true at
    that point of the replay, with the launches counted per run."""
    from ceres_tpu_torch.utils import cuda_graph

    x = torch.zeros(8, device=device)
    a = torch.zeros((), dtype=torch.bool, device=device)
    b = torch.zeros((), dtype=torch.bool, device=device)

    def fn():
        with cuda_graph.run_if(a):
            y = x + 1.0
            with cuda_graph.run_if(b):
                y.copy_(y * 10.0)
            x.copy_(2.0 * y)

    fn()
    graph = cuda_graph.CapturedGraph(fn, device)
    for av, bv, want in ((0, 0, 0.0), (1, 0, 2.0), (1, 1, 20.0), (0, 1, 0.0)):
        x.zero_()
        a.fill_(bool(av))
        b.fill_(bool(bv))
        graph.replay()
        assert float(x[0]) == want


def test_captured_launches_count_per_replay_that_ran_them(device):
    from ceres_tpu_torch.utils import cuda_graph

    G = 5000
    seg = np.sort(np.random.default_rng(0).integers(0, G, 20000))
    row_ptr = torch.from_numpy(ss.build_row_ptr(seg, G)).to(device)
    contrib = torch.ones((20000, 3), dtype=torch.float32, device=device)
    out = torch.zeros((G + 1, 3), device=device)
    go = torch.zeros((), dtype=torch.bool, device=device)

    def fn():
        with cuda_graph.run_if(go):
            out.copy_(ss.segment_sum_sorted(contrib, row_ptr, G))

    fn()
    graph = cuda_graph.CapturedGraph(fn, device)
    before = ss.launches
    for run in (True, False, True, True):
        go.fill_(run)
        graph.replay()
    graph.credit(graph.launch_counts().cpu().tolist())
    assert ss.launches == before + 3 and graph.launches == 3
    assert float(out.sum()) == 20000 * 3


# every option set the captured loop takes (fused_lm.captured_loop_eligible)
CAPTURED_OPTIONS = {
    "iterative_schur_jacobi": dict(),
    "iterative_identity": dict(preconditioner_type="IDENTITY"),
    "iterative_jacobi": dict(preconditioner_type="JACOBI"),
    "iterative_power_series": dict(preconditioner_type="SCHUR_POWER_SERIES_EXPANSION"),
    "iterative_explicit": dict(use_explicit_schur_complement=True),
    "iterative_spse_initialization": dict(use_spse_initialization=True),
    "iterative_mixed_precision": dict(use_mixed_precision_solves=True,
                                      max_num_refinement_iterations=3),
    "dense_schur": dict(linear_solver_type="DENSE_SCHUR"),
    "dense_schur_mixed_precision": dict(linear_solver_type="DENSE_SCHUR",
                                        use_mixed_precision_solves=True),
    "dense_qr": dict(linear_solver_type="DENSE_QR"),
    "dense_normal_cholesky": dict(linear_solver_type="DENSE_NORMAL_CHOLESKY"),
    "cgnr_jacobi": dict(linear_solver_type="CGNR", preconditioner_type="JACOBI"),
    "cgnr_identity": dict(linear_solver_type="CGNR", preconditioner_type="IDENTITY"),
    "iterative_cluster_jacobi": dict(preconditioner_type="CLUSTER_JACOBI"),
    "iterative_cluster_tridiagonal": dict(preconditioner_type="CLUSTER_TRIDIAGONAL"),
    # no S assembled: the cluster blocks from the implicit S's probes
    "iterative_cluster_jacobi_implicit": dict(preconditioner_type="CLUSTER_JACOBI",
                                              implicit_s=True),
    "iterative_cluster_tridiagonal_implicit": dict(preconditioner_type="CLUSTER_TRIDIAGONAL",
                                                   implicit_s=True),
    "cgnr_subset": dict(linear_solver_type="CGNR", preconditioner_type="SUBSET",
                        residual_blocks_for_subset_preconditioner=list(range(0, 4400, 3))),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CAPTURED_OPTIONS))
def test_captured_solve_matches_the_eager_loop(device, dtype, name, monkeypatch):
    """ctt.solve runs these as CUDA graphs: its records and final cost equal
    the same loop run eagerly, to the bit, and a repeat solve of the same
    program reads the host at most 3 times. 4400 observations: the point
    sums go to K1 and the camera sums to a one-hot matmul, both in a fixed
    order (below 4096 rows they are index_add_'s atomics, whose order
    changes from run to run, captured or not); SUBSET's J'J cells go to K1."""
    from ceres_tpu_torch import trust_region
    from ceres_tpu_torch.tools.profile_solve import _host_reads, eager_loop

    inst = bal.synthesize_bal(num_cameras=4, num_points=1100, num_observations=4400, seed=42)
    problem = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))[0]
    opts = bal.default_options(iterative=True)
    changes = dict(CAPTURED_OPTIONS[name])
    if changes.pop("implicit_s", False):
        monkeypatch.setattr(schur, "EXPLICIT_S_AUTO_MAX_NF", 0)
        monkeypatch.setattr(trust_region, "EXPLICIT_S_AUTO_MAX_NF", 0)
    for field, value in changes.items():
        enum = {"linear_solver_type": ctt.LinearSolverType,
                "preconditioner_type": ctt.PreconditionerType}.get(field)
        setattr(opts, field, enum[value] if enum else value)
    opts.evaluation_dtype = dtype
    start = problem.state().copy()
    eager, _ = eager_loop(problem, opts, device)
    problem.write_back(start)
    first = ctt.solve(opts, problem, device=device)
    problem.write_back(start)
    repeat, reads = _host_reads(lambda: ctt.solve(opts, problem, device=device))
    assert first.captured_loop and repeat.captured_loop
    assert first.graph_capture_time_in_seconds > 0.0 == repeat.graph_capture_time_in_seconds
    assert sum(reads.values()) <= 3, dict(reads)
    for s in (first, repeat):
        assert s.final_cost == eager.final_cost
        assert [repr(r) for r in s.iterations] == [repr(r) for r in eager.iterations]
    ss_ = problem.program(device).schur_structure
    if "implicit" in name:
        assert ss_.explicit is None and ss_.cluster_groups is not None


def _sphere_covariance(device, captured: bool, monkeypatch):
    """The matrix-free covariance of a 120-pose sphere (720 tangent
    coordinates; the path forced as tests/test_torch_covariance.py forces
    it), with its CG captured or eager: (Z, CG iterations, host reads)."""
    from ceres_tpu_torch import covariance
    from ceres_tpu_torch.models import pose_graph
    from ceres_tpu_torch.tools.profile_solve import _host_reads

    monkeypatch.setattr(covariance, "DENSE_COVARIANCE_MAX_TANGENT", 1)
    monkeypatch.setattr(covariance.Covariance, "_compute_schur_marginals", lambda self, *a: None)
    monkeypatch.setattr(covariance, "_captured", lambda dev: captured)
    problem, _, quat_id = pose_graph.build_problem_3d(
        *pose_graph.synthesize_sphere(120, seed=1)[:3])
    pairs = [(quat_id[v], quat_id[v]) for v in range(1, 120, 7)]
    cov = ctt.Covariance()
    ok, reads = _host_reads(lambda: cov.compute(pairs, problem, device=device))
    assert ok and cov._mf_Z is not None
    return cov._mf_Z, cov.statistics["cg_iterations"], reads


def test_captured_matrix_free_covariance_matches_the_eager_one(device, monkeypatch):
    """The 8-column CG captured once per compute() and replayed per chunk
    gives the eager loop's columns and counts to the bit. Its reads are the
    eager computation's but for the CG's: the same set-up and one read per
    chunk, and of the CG only the warm-up's one predicate, whatever the
    iteration counts (eagerly one a CG iteration)."""
    def loop_reads(reads):
        return sum(v for site, v in reads.items() if site.startswith("cuda_graph.py"))

    def other_reads(reads):
        return {site: v for site, v in reads.items() if not site.startswith("cuda_graph.py")}

    eager_z, eager_it, eager_reads = _sphere_covariance(device, False, monkeypatch)
    z, it, reads = _sphere_covariance(device, True, monkeypatch)
    again, it2, reads2 = _sphere_covariance(device, True, monkeypatch)
    assert it == it2 == eager_it and np.array_equal(z, eager_z) and np.array_equal(again, z)
    assert reads == reads2 and other_reads(reads) == other_reads(eager_reads), (reads, eager_reads)
    assert loop_reads(reads) == 1 and loop_reads(eager_reads) > max(it), (reads, eager_reads)


def test_captured_tiny_solve_matches_the_eager_one(device):
    """TinySolver on the card: captured at the first call with a given fn,
    shape, dtype and options, replayed after; every call the eager loop's
    results to the bit, and a repeat from a card tensor reads the host
    nothing, whatever its iteration count."""
    from ceres_tpu_torch import tiny_solver
    from ceres_tpu_torch.tools.profile_solve import _host_reads

    def rosenbrock(x):
        return torch.cat([10.0 * (x[1:2] - x[0:1] ** 2), 1.0 - x[0:1]])

    x0 = torch.from_numpy(np.array([-1.2, 1.0]) + 0.8 * np.random.default_rng(0)
                          .standard_normal((4096, 2))).to(device)
    options = (50, 1e-10, 1e-8, float(np.finfo(np.float64).eps))
    eager = tiny_solver._TinyLoop(rosenbrock, x0, *options, captured=False).run(x0)
    first = ctt.tiny_solve(rosenbrock, x0, device=device)
    repeat, reads = _host_reads(lambda: ctt.tiny_solve(rosenbrock, x0, device=device))
    assert tiny_solver.tiny_loop(rosenbrock, x0, *options).graph is not None
    assert sum(reads.values()) == 0, dict(reads)
    assert int(eager.iterations.max()) > 10 and len(set(eager.iterations.tolist())) > 5
    for out in (first, repeat):
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


def test_a_captured_solve_follows_a_loss_swapped_between_solves(device):
    """Solve, ``LossFunctionWrapper.reset(TrivialLoss())``, solve again:
    the second solve is captured anew and equals a fresh problem's solve
    under the new loss, records included (a graph captured with the old
    loss would replay its arithmetic). The check is ``chip_smoke.py``'s."""
    import chip_smoke

    chip_smoke.captured_loss_swap(device)


def _host_loop_case(name: str):
    """(problem, options) of a host-loop case on CAPTURED_OPTIONS's 4400-
    observation BAL (deterministic reductions): ITERATIVE_SCHUR with
    progress output (the fused iteration), else DENSE_SCHUR."""
    inst = bal.synthesize_bal(num_cameras=4, num_points=1100, num_observations=4400, seed=42)
    if name == "bounds":
        inst.points[:, 2] = np.clip(inst.points[:, 2], -1.0, 1.0)
    problem, _, pts = bal.build_problem(inst, loss=ctt.HuberLoss(1.0))
    opts = bal.default_options(iterative=name.startswith("progress"))
    opts.evaluation_dtype = "float32" if name.endswith("float32") else "float64"
    if name.startswith("progress"):
        opts.minimizer_progress_to_stdout = True
    elif name == "bounds":
        for pid in pts:
            problem.set_parameter_lower_bound(int(pid), 2, -1.0)
            problem.set_parameter_upper_bound(int(pid), 2, 1.0)
    elif name == "evaluation_callback_nonmonotonic":
        opts.use_nonmonotonic_steps = True
        opts.evaluation_callback = _CountingCallback()
    elif name.startswith("dogleg"):
        opts.trust_region_strategy_type = ctt.TrustRegionStrategyType.DOGLEG
        opts.dogleg_type = ctt.DoglegType[name.split("_", 1)[1].upper() + "_DOGLEG"]
    else:
        opts.use_inner_iterations = True
    return problem, opts


class _CountingCallback(ctt.EvaluationCallback):
    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        self.calls += 1


HOST_LOOP_CASES = ["progress_float32", "progress_float64", "bounds",
                   "evaluation_callback_nonmonotonic", "dogleg_traditional", "dogleg_subspace",
                   "inner_iterations"]


@pytest.mark.parametrize("name", HOST_LOOP_CASES)
def test_captured_host_loop_matches_the_eager_one(device, name, capsys):
    """ctt.solve's host loop runs its device work from CUDA graphs
    (``host_loop_graphs``): the first solve captures them, a repeat replays
    them, and both equal the same regions run eagerly
    (``profile_solve.eager_host_loop``) to the bit (records less their
    times, final cost, x, the evaluation callback's calls) with the eager
    run's K1 / K3 / K4 launches. The repeat reads the host nowhere inside a
    region (no CG predicate), fewer times than the eager run, and on the
    fused iteration (progress output) at most once per LM iteration plus
    ``chip_smoke.HOST_LOOP_SETUP_READS``."""
    import chip_smoke
    from ceres_tpu_torch.tools.profile_solve import _host_reads, eager_host_loop

    problem, opts = _host_loop_case(name)
    start = problem.state().copy()
    runs = []
    for kind in ("eager", "captured", "captured"):
        problem.write_back(start)
        if opts.evaluation_callback is not None:
            opts.evaluation_callback.calls = 0
        before = (ss.launches, us.launches, osum.launches)
        if kind == "eager":
            summary, reads = _host_reads(lambda: eager_host_loop(problem, opts, device)[0])
        else:
            summary, reads = _host_reads(lambda: ctt.solve(opts, problem, device=device))
        launches = tuple(a - b for a, b in zip((ss.launches, us.launches, osum.launches), before))
        calls = getattr(opts.evaluation_callback, "calls", None)
        runs.append((summary, reads, launches, problem.state().copy(), calls))
    capsys.readouterr()
    eager, first, repeat = runs
    assert not eager[0].captured_loop and first[0].captured_loop and repeat[0].captured_loop
    assert first[0].graph_capture_time_in_seconds > 0.0 == repeat[0].graph_capture_time_in_seconds
    assert eager[0].is_solution_usable() and sum(eager[2]) > 0
    for run in (first, repeat):
        assert chip_smoke._host_loop_records_key(run[0]) == chip_smoke._host_loop_records_key(
            eager[0])
        assert run[0].final_cost == eager[0].final_cost
        assert np.array_equal(run[3], eager[3]) and run[2] == eager[2] and run[4] == eager[4]
    reads, eager_reads = repeat[1], eager[1]
    assert not any(site.startswith("cuda_graph.py") for site in reads), dict(reads)
    assert sum(reads.values()) < sum(eager_reads.values()), (dict(reads), dict(eager_reads))
    if name.startswith("progress"):
        lm = repeat[0].num_iterations  # loop trips: a stop may add no record
        assert sum(reads.values()) <= lm + chip_smoke.HOST_LOOP_SETUP_READS, dict(reads)


def test_captured_evaluator_entry_points_match_the_eager_ones(device):
    """The host loop's Evaluator with its regions captured: cost,
    cost_and_gradient (reverse mode through the graph) and
    cost_gradient_jacobian at two points equal the eager regions' to the
    bit (the reverse-mode gradient, whose gather's backward accumulates, to
    1e-12), and a result kept from the first point is not overwritten by
    the second."""
    from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
    from ceres_tpu_torch.trust_region import TrustRegionMinimizer

    problem, opts = _host_loop_case("bounds")
    out = {}
    for captured in (False, True):
        program, resolved = preprocess(opts, problem, device, SolverSummary())
        ev = TrustRegionMinimizer(program, resolved, SolverSummary(), captured=captured).evaluator
        x0 = initial_state(program)
        got = []
        for x in (x0, x0 * 1.01):
            cost = ev.cost(x)
            cg = ev.cost_and_gradient(x)
            full = ev.cost_gradient_jacobian(x)
            got.append([cost, *cg, full.cost, full.gradient.clone(),
                        *[J.clone() for js in full.jacobian_context.jacs for J in js]])
        kept_cost, kept_grad = got[0][0], got[0][2]
        assert float(kept_cost) != float(got[1][0]) and not torch.equal(kept_grad, got[1][2])
        out[captured] = got
        assert bool(ev.graphs.graphs) == captured
    for a, b in zip(out[False], out[True]):
        for i, (u, v) in enumerate(zip(a, b)):
            if i == 2:
                torch.testing.assert_close(v, u, rtol=1e-12, atol=0.0)
            else:
                assert torch.equal(u, v), i
