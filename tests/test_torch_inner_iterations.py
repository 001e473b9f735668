"""Inner iterations in the port against ceres_tpu's: the independent sets
(equal to ``ceres_tpu.inner_iterations.compute_independent_sets``, which
takes the native core's coloring), a user ordering validated and rejected
as tests/test_ordered_groups.py:97 does, solves with inner iterations record
by record (f64 costs rtol 1e-10, as tests/test_torch_host_loop.py), the f32
dtypes, and the plan kinds (gather plans, the same on every device).
"""

import functools

import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import Evaluator as JaxEvaluator
from ceres_tpu.inner_iterations import CoordinateDescentMinimizer as JaxCD
from ceres_tpu.inner_iterations import compute_independent_sets as jax_sets
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch import inner_iterations as tii
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.ops.reduce import apply_reduce
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg

TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
SMALL = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)
_EXACT = ("iteration", "step_is_valid", "step_is_successful", "linear_solver_iterations")


def _bal(mod, sizes, constant_cameras=0, loss=True):
    bm = jbal if mod is ct else tbal
    p, cams, pts = bm.build_problem(bm.synthesize_bal(**sizes),
                                    loss=mod.loss.HuberLoss(1.0) if loss else None)
    if constant_cameras:
        p.set_parameter_block_constant(cams[:constant_cameras])
    return p, cams, pts


def _program(mod, problem):
    return problem.program() if mod is ct else problem.program("cpu")


def _pose_graph(mod, n=40):
    pg = jpg if mod is ct else tpg
    return pg.build_problem_3d(*pg.synthesize_sphere(n, seed=1)[:3])[0]


@pytest.mark.parametrize("case", ["bal", "bal_constant_cameras", "pose_graph"])
def test_independent_sets_equal_jax(case):
    """The native core's greedy coloring, block for block: in a BAL problem
    the cameras form one set and the points another; in a 3-D pose graph the
    degrees tie and the visiting order decides the sets."""
    sets = []
    for mod in (ct, ctt):
        if case == "pose_graph":
            problem = _pose_graph(mod)
        else:
            problem = _bal(mod, SMALL, constant_cameras=2 if "constant" in case else 0)[0]
        sets.append(jax_sets(_program(mod, problem)) if mod is ct
                    else tii.compute_independent_sets(_program(mod, problem)))
    assert sets[1] == sets[0]
    assert len(sets[0]) >= 2
    if case == "pose_graph":
        assert len(sets[0]) > 2 and len({len(s) for s in sets[0]}) > 1


def test_user_ordering_validated_and_rejected():
    problem, cams, pts = _bal(ctt, TINY)
    program = problem.program("cpu")
    groups = [[int(c) for c in cams], [int(p) for p in pts]]
    opts = ctt.SolverOptions(inner_iteration_ordering=groups)
    cd = tii.CoordinateDescentMinimizer(program, opts, Evaluator(program))
    assert cd.sets == groups
    x0 = torch.from_numpy(program.initial_ambient())
    _, cost1 = cd.minimize(x0)
    assert cost1 < float(Evaluator(program).cost(x0))  # a pass lowers the cost
    ids = program.families[0].block_ids
    bad = ctt.SolverOptions(inner_iteration_ordering=[[int(ids[0, 0]), int(ids[0, 1])]])
    with pytest.raises(ValueError, match="independent"):
        tii.CoordinateDescentMinimizer(program, bad, Evaluator(program))
    with pytest.raises(ValueError, match="independent"):
        ctt.solve(ctt.SolverOptions(use_inner_iterations=True,
                                    inner_iteration_ordering=bad.inner_iteration_ordering),
                  problem, device="cpu")


def test_one_pass_matches_jax():
    """One coordinate-descent pass from the same start: the same point and
    cost (the sets of each package, which are equal)."""
    out = []
    for mod in (ct, ctt):
        program = _program(mod, _bal(mod, TINY, constant_cameras=2)[0])
        opts = mod.SolverOptions()
        if mod is ct:
            cd = JaxCD(program, opts, JaxEvaluator(program))
            x, cost = cd.minimize(program.initial_ambient())
            out.append((np.asarray(x), cost))
        else:
            cd = tii.CoordinateDescentMinimizer(program, opts, Evaluator(program))
            x, cost = cd.minimize(torch.from_numpy(program.initial_ambient()))
            out.append((x.numpy(), cost))
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-12)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-12)


def _solve(mod, user_ordering=False, dtype="float64"):
    bm = jbal if mod is ct else tbal
    p, cams, pts = _bal(mod, TINY, constant_cameras=2)
    opts = bm.default_options(iterative=False)  # DENSE_SCHUR
    opts.use_inner_iterations = True
    opts.evaluation_dtype = dtype
    if user_ordering:
        opts.inner_iteration_ordering = [[int(p) for p in pts], [int(c) for c in cams]]
    return mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)


@functools.lru_cache(maxsize=None)
def _both(user_ordering):
    return _solve(ct, user_ordering), _solve(ctt, user_ordering)


@pytest.mark.parametrize("user_ordering", [False, True])
def test_solve_matches_jax_record_by_record(user_ordering):
    sj, st = _both(user_ordering)
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    assert st.num_inner_iteration_steps == sj.num_inner_iteration_steps > 0
    assert st.inner_iteration_time_in_seconds > 0
    assert len(st.iterations) == len(sj.iterations) > 5
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    floor = 1e-16 * sj.iterations[0].cost
    for a, b in zip(st.iterations, sj.iterations):
        for f in _EXACT:
            assert getattr(a, f) == getattr(b, f), (f, b.iteration)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10, atol=floor)
        np.testing.assert_allclose(a.relative_decrease, b.relative_decrease, rtol=1e-6)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10)


def test_float32_keeps_the_evaluation_dtype(monkeypatch):
    """Under evaluation_dtype "float32" the inner pass keeps the reference's
    dtypes (ceres_tpu/inner_iterations.py builds the step in f64): x is f32
    in and out, the per-block radii and the delta handed to plus are f64,
    the JAX package's pass returns an f32 x too, and the solve ends within
    1e-4 of f64."""
    seen = []
    real = tii.CoordinateDescentMinimizer._set_step

    def spy(self, groups, x, radii):
        deltas = []
        plus = self.program.plus
        self.program.plus = lambda x_, d: (deltas.append(d.dtype), plus(x_, d))[1]
        try:
            new_x, new_radii, cost = real(self, groups, x, radii)
        finally:
            del self.program.plus
        seen.append((x.dtype, new_x.dtype, {r.dtype for r in new_radii.values()},
                     set(deltas), cost.dtype))
        return new_x, new_radii, cost

    monkeypatch.setattr(tii.CoordinateDescentMinimizer, "_set_step", spy)
    s32 = _solve(ctt, dtype="float32")
    f32, f64 = torch.float32, torch.float64
    assert seen and all(s == (f32, f32, {f64}, {f64}, f64) for s in seen), seen[:2]
    assert s32.num_inner_iteration_steps > 0
    np.testing.assert_allclose(s32.final_cost, _both(False)[1].final_cost, rtol=1e-4)

    # the reference's dtype after its pass
    program = _program(ct, _bal(ct, TINY, constant_cameras=2)[0])
    from ceres_tpu.problem import cast_program

    cast_program(program, "float32")
    cd = JaxCD(program, ct.SolverOptions(), JaxEvaluator(program))
    x, _ = cd.minimize(program.initial_ambient().astype(np.float32))
    assert np.asarray(x).dtype == np.float32


def test_plan_kinds_for_a_cuda_device():
    """The inner plans are gather plans, the same kind on every device: a
    point set takes the sorted kernel (K1) and a camera set of 288 to 4095
    blocks the unsorted one (K3); below 288 blocks a one-hot matmul; never
    ``scatter`` (choose_gather_plan_kind is pure). A user ordering whose
    point set leaves points out drops their rows from K1's row list."""
    problem, cams, pts = _bal(ctt, dict(num_cameras=300, num_points=1500, num_observations=6000,
                                        seed=5), loss=False)
    program = problem.program("cpu")
    cd = tii.CoordinateDescentMinimizer(program, ctt.SolverOptions(), Evaluator(program))
    assert [len(s) for s in cd.sets] == [1500, 300]
    assert cd.plan_kinds("cuda") == [(0, 3, 1500, "sorted"), (1, 9, 300, "unsorted")]
    assert cd.plan_kinds() == cd.plan_kinds("cpu") == cd.plan_kinds("cuda")
    small = tii.CoordinateDescentMinimizer(
        _program(ctt, _bal(ctt, SMALL)[0]), ctt.SolverOptions(), None)
    assert [k for *_, k in small.plan_kinds("cuda")] == ["sorted", "onehot"]
    # half the points: ids with the dummy between them, 751 rows (K3); each
    # kept point sums its own observations, the others' rows add nowhere
    half = [int(p) for p in pts[::2]]
    part = ctt.SolverOptions(inner_iteration_ordering=[half])
    (_, plans), = tii.CoordinateDescentMinimizer(program, part, None)._set_structs[0].values()
    (plan,) = [p for fp in plans for p in fp if p is not None]
    assert plan.kind == "unsorted"
    ids = program.families[0].block_ids[:, 1]
    counts = apply_reduce(plan, torch.ones(ids.shape[0], dtype=torch.float64))
    assert counts[:-1].tolist() == [float(np.sum(ids == p)) for p in half]


def test_inner_iteration_tolerance_is_checked():
    messages = []
    for mod in (ct, ctt):
        p = _bal(mod, TINY)[0]
        opts = mod.SolverOptions(use_inner_iterations=True, inner_iteration_tolerance=-1.0)
        s = mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)
        messages.append(s.message)
    assert messages[1] == messages[0] == "Invalid options: inner_iteration_tolerance must be >= 0"
