"""Reduce plans that add in one fixed order on the card
(``ceres_tpu_torch/ops/reduce.py``, ``reduce_plan_kind``): where
``choose_plan_kind`` takes ``scatter`` (``index_add_``, whose atomics add
in no fixed order) for a group of more than two rows on a CUDA device, the
plan is a gather plan (K1 through a stable row list with the dummy rows
left out, or K3), so the card's sums have the same bits on every run.

The choice is pure, so these CPU tests ask it what a card gets; the plans
themselves run here through their kernels' plain versions, built as the
card builds them (``reduce_plan_kind`` answered as for "cuda"):

- the small robust BAL of ``chip_smoke.py``'s ``small_robust_dense``
  (8 / 500 / 2000, up to 4 rows a point) no longer takes ``scatter``;
- a point-sorted BAL with a random tenth of its points constant (6 / 4600 /
  13800: the dummy ids interleaved, 4141 groups) takes no ``scatter`` plan
  above two rows a group at any site (families, Schur, explicit S, J'J
  cells), and solved with those plans on the CPU it gives the JAX
  package's records (f64, rtol 1e-10): every consumer drops the dummy row,
  which a gather plan leaves at zero where ``scatter`` summed the constant
  points' rows into it;
- a gather plan's ``sorted`` kind leaves the dummy rows out;
- each new plan's plain version equals the JAX package's ``apply_reduce``
  on the same ids in f64 (rtol 1e-12 of the output's scale).

About 10 s alone, most of it the two solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu.ops import reduce as jred
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.solver import SolverSummary, preprocess

SMALL_ROBUST = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)
INTERLEAVED = dict(num_cameras=6, num_points=4600, num_observations=13800, noise=1.0,
                   perturb=0.3, seed=3)


@pytest.fixture
def card_plans(monkeypatch):
    """Every reduce plan built as a card builds it, on the CPU; returns the
    log of (kind, gather, largest group, what choose_plan_kind took)."""
    log = []
    real = tred.reduce_plan_kind

    def as_on_the_card(seg, G, _device_type):
        kind, gather = real(seg, G, "cuda")
        log.append((kind, gather, tred.max_group_rows(seg, G),
                    tred.choose_plan_kind(seg, G, "cuda")))
        return kind, gather

    monkeypatch.setattr(tred, "reduce_plan_kind", as_on_the_card)
    return log


def _interleaved(mod):
    """The INTERLEAVED BAL, its points sorted, a random tenth constant."""
    bm = jbal if mod is ct else tbal
    problem, _, pts = bm.build_problem(bm.synthesize_bal(**INTERLEAVED))
    rng = np.random.default_rng(0)
    constant = rng.choice(len(pts), len(pts) // 10, replace=False)
    problem.set_parameter_block_constant(np.asarray(pts)[np.sort(constant)])
    return problem


def test_the_small_robust_point_plan_is_not_scatter():
    problem = tbal.build_problem(tbal.synthesize_bal(**SMALL_ROBUST))[0]
    fam = problem.program("cpu").families[0]
    seg, G = fam.bd_pos[1].numpy(), fam.reduce_plans[1].num_groups
    assert tred.choose_plan_kind(seg, G, "cuda") == "scatter"
    assert tred.max_group_rows(seg, G) == 4
    assert tred.reduce_plan_kind(seg, G, "cuda") == ("sorted", True)
    # the CPU keeps index_add_, which adds in row order there
    assert tred.reduce_plan_kind(seg, G, "cpu") == ("scatter", False)


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR"])
def test_interleaved_constant_points_take_no_scatter_above_two_rows(card_plans, solver):
    opts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType[solver])
    program, resolved = preprocess(opts, _interleaved(ctt), "cpu", SolverSummary())
    from ceres_tpu_torch.trust_region import TrustRegionMinimizer

    TrustRegionMinimizer(program, resolved, SolverSummary())  # the solver's plans too
    assert len(card_plans) > 3
    assert not [e for e in card_plans if e[0] == "scatter" and e[2] > 2]
    # the point plan: choose_plan_kind took index_add_ over 3 rows a point
    assert any(chose == "scatter" and gather and rows > 2
               for _, gather, rows, chose in card_plans)


def test_card_plans_on_the_cpu_give_the_jax_records(card_plans):
    """The interleaved BAL solved under DENSE_SCHUR with the card's plans:
    the gradient, J'J's diagonal and the Schur sums drop each plan's dummy
    row, so the JAX package's records come out (f64, rtol 1e-10)."""
    opts = {m: m.SolverOptions(linear_solver_type=m.LinearSolverType.DENSE_SCHUR,
                               max_num_iterations=4) for m in (ct, ctt)}
    j = ct.solve(opts[ct], _interleaved(ct))
    t = ctt.solve(opts[ctt], _interleaved(ctt), device="cpu")
    assert any(gather for _, gather, _, _ in card_plans)
    assert len(t.iterations) == len(j.iterations) > 3
    for a, b in zip(t.iterations, j.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_a_gather_plans_sorted_kind_leaves_the_dummy_rows_out(card_plans):
    rng = np.random.default_rng(1)
    G = 5000
    seg = np.sort(rng.integers(0, G, 9000))
    seg[rng.choice(9000, 900, replace=False)] = G  # constant rows between sorted ids
    plan = tred.build_reduce_plan(seg, G, "cpu")
    assert card_plans[-1][:2] == ("sorted", True) and card_plans[-1][3] == "scatter"
    kept = np.nonzero(seg < G)[0]
    assert np.array_equal(plan.rows.numpy(), kept[np.argsort(seg[kept], kind="stable")])
    row_ptr = plan.row_ptr.numpy()
    assert row_ptr[G] == row_ptr[G + 1] == kept.size
    out = tred.apply_reduce(plan, torch.from_numpy(rng.standard_normal((9000, 3))))
    assert torch.count_nonzero(out[G]) == 0


def _ids(case, rng):
    """(ids, G) that choose_plan_kind sends to index_add_ on the card with
    more than two rows a group."""
    if case == "sorted_rows":  # unsorted, over 4096 groups: K1 through a row list
        G = 4500
        return rng.integers(-3, G + 3, 20000), G
    if case == "sorted":  # sorted, fewer than 4096 rows: K1 with no row list
        G = 1200
        return np.sort(rng.integers(0, G, 3000)), G
    G = 700  # unsorted, fewer than 4096 rows: K3
    return rng.integers(0, G + 1, 3000), G


@pytest.mark.parametrize("case,kind", [("sorted_rows", "sorted"), ("sorted", "sorted"),
                                       ("unsorted", "unsorted")])
@pytest.mark.parametrize("width", [1, 9])
def test_new_plans_plain_versions_match_jax_apply_reduce(card_plans, case, kind, width):
    rng = np.random.default_rng(width + len(case))
    seg, G = _ids(case, rng)
    plan = tred.build_reduce_plan(seg, G, "cpu")
    assert plan.kind == kind and card_plans[-1][1] and card_plans[-1][3] == "scatter"
    assert (plan.rows is not None) == (case == "sorted_rows")
    contrib = rng.standard_normal((seg.shape[0], width))
    got = tred.apply_reduce(plan, torch.from_numpy(contrib)).numpy()
    jplan = jred.build_reduce_plan(seg, G, allow_pallas=False)
    want = np.asarray(jred.apply_reduce(jplan, jnp.asarray(contrib)))
    scale = float(np.abs(want[:G]).max())
    np.testing.assert_allclose(got[:G], want[:G], rtol=1e-12, atol=1e-12 * scale)
