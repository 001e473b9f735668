"""The Snavely residual's fused form (``ops/snavely.py``, the kernel
``csrc/snavely_evaluate.cu``) and the evaluator's choice of it.

On the CPU: the op's plain version against vmap(jacfwd) of
``models/bal.snavely_reprojection_residual`` on random cameras, among them
angle-axes with theta^2 below 1e-24 (the first-order branch), exactly 0
and near pi; float64 to 1e-13 and float32 to 1e-5 of each output column's
largest magnitude (the dual arithmetic adds the chain rule's terms in
jacfwd's order, with reciprocals in place of some divisions, so entries
that cancel carry their terms' rounding). The evaluator on CPU tensors
keeps vmap(jacfwd)'s bits; with the fused route opened to the CPU
(``evaluator.FUSED_DEVICE_TYPES``, the route then runs the plain version),
a BAL family takes it and a family with a manifold, a grad-recording
evaluation and a non-BAL family keep vmap, each counted by route
(``observability.evaluations``, a solve's share on its ``SolveTrace``).

On the card (marked ``cuda``): the kernel against the plain version, both
entries, f64 1e-13 and f32 1e-5; the same bits on two eager launches and
from a CUDA graph; a flagship f64 solve with the kernel against the same
solve on vmap(jacfwd) (LM iterations, steps and CG iterations equal, final
cost within 1e-12); the launch counter credited once per replay.

This file imports neither jax nor ceres_tpu, so its card tests also run
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_snavely_kernel.py
"""

import math

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import ceres_tpu_torch as ctt
from ceres_tpu_torch import evaluator as ev
from ceres_tpu_torch.models import bal, pose_graph
from ceres_tpu_torch.ops import snavely
from ceres_tpu_torch.utils import observability

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# Angle-axes of the edge cases: theta^2 below 1e-24 (the first-order
# branch), exactly 0, near pi, pi.
ANGLE_AXES = {
    "random": None,
    "theta_sq_below_1e-24": [[3e-13, 0.0, 0.0], [7e-13, 6e-13, 0.0], [0.0, 1e-14, -5e-13]],
    "theta_zero": [[0.0, 0.0, 0.0]],
    "near_pi": [[math.pi - 1e-7, 0.0, 0.0], [0.0, 0.0, math.pi],
                [1.8, -1.8, 1.8 * (1 - 1e-9)]],
}


def _inputs(case: str, dtype, C=40, P=300, B=2000, seed=3):
    """Tables, rows and observations: random cameras about 20 units from
    random points, every camera observed; the case's angle-axes on the first
    cameras."""
    rng = np.random.default_rng(seed)
    cams = np.zeros((C, 9))
    cams[:, :3] = rng.standard_normal((C, 3)) * 0.5
    if ANGLE_AXES[case] is not None:
        fixed = np.asarray(ANGLE_AXES[case])
        cams[: C // 2, :3] = fixed[np.arange(C // 2) % len(fixed)]
    cams[:, 3:6] = rng.standard_normal((C, 3))
    cams[:, 5] -= 20.0
    cams[:, 6] = 500.0 + 10.0 * rng.standard_normal(C)
    cams[:, 7] = 1e-3 * rng.standard_normal(C)
    cams[:, 8] = 1e-5 * rng.standard_normal(C)
    pts = rng.standard_normal((P, 3)) * 3.0
    ci = rng.integers(0, C, B)
    ci[:C] = np.arange(C)
    pi = np.sort(rng.integers(0, P, B))
    obs = rng.standard_normal((B, 2)) * 100.0
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return t(cams), t(pts), torch.from_numpy(ci), torch.from_numpy(pi), t(obs)


def _vmap_jacfwd(cams, pts, ci, pi, obs):
    f = bal.snavely_reprojection_residual
    c, p = cams[ci], pts[pi]
    r = vmap(f)(c, p, obs)
    J_cam, J_pt = vmap(jacfwd(f, argnums=(0, 1)))(c, p, obs)
    return r, J_cam, J_pt


def _held(got, ref, rtol, label):
    """Every entry within rtol of its output column's largest magnitude."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, label
    scale = ref.abs().amax(dim=0, keepdim=True)
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all()), label
    assert bool((err <= rtol * scale).all()), (label, float((err / scale).nan_to_num().max()))


# ---- the plain version ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(ANGLE_AXES))
def test_plain_matches_vmap_jacfwd(case, dtype):
    args = _inputs(case, dtype)
    got = snavely.evaluate_plain(*args)
    ref = _vmap_jacfwd(*args)
    for g, r, label in zip(got, ref, ("r", "J_cam", "J_pt")):
        _held(g, r, RTOL[dtype], f"{case} {label}")
    if case == "theta_sq_below_1e-24":  # the first-order branch is taken
        assert float((args[0][:, :3] ** 2).sum(1).max()) > 1e-24
        assert float((args[0][0, :3] ** 2).sum()) < 1e-24


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_residual_only_entry_is_the_full_entrys_residual(dtype):
    args = _inputs("random", dtype)
    r = snavely.evaluate(*args, jacobians=False)
    r_full, _, _ = snavely.evaluate(*args)
    assert torch.equal(r, r_full)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cams, pts, ci, pi, obs = _inputs("random", torch.float64, B=50)
    with pytest.raises(ValueError, match="tables"):
        snavely.evaluate(cams[:, :8], pts, ci, pi, obs)
    with pytest.raises(ValueError, match="int64"):
        snavely.evaluate(cams, pts, ci.to(torch.int32), pi, obs)
    with pytest.raises(ValueError, match="int64"):
        snavely.evaluate(cams, pts, ci, pi, obs[:, :1])
    with pytest.raises(TypeError, match="dtypes"):
        snavely.evaluate(cams, pts.float(), ci, pi, obs)


# ---- the evaluator's choice -------------------------------------------------

SMALL = dict(num_cameras=6, num_points=300, num_observations=1200, noise=2.0, perturb=0.5)


def _bal_family(dtype=torch.float64, manifold=None):
    """(program, its one family, x) of a small BAL problem on the CPU in
    ``dtype``; ``manifold`` on every camera."""
    problem, cam_ids, _ = bal.build_problem(bal.synthesize_bal(**SMALL, seed=11))
    if manifold is not None:
        for cid in cam_ids:
            problem.set_manifold(int(cid), manifold)
    program = problem.program("cpu")
    x = torch.from_numpy(program.initial_ambient()).to(dtype)
    fam = program.families[0]
    fam.data = fam.data.to(dtype)
    return program, fam, x


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The fused route opened to CPU tensors (where it runs the plain
    version); the evaluation counts and kernel launches zeroed."""
    monkeypatch.setattr(ev, "FUSED_DEVICE_TYPES", ("cpu", "cuda"))
    monkeypatch.setattr(observability, "evaluations", {"kernel": 0, "vmap": 0})
    monkeypatch.setattr(snavely, "launches", 0)


def _counts():
    return dict(observability.evaluations)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_evaluator_on_cpu_tensors_keeps_vmap_bits(dtype, monkeypatch):
    monkeypatch.setattr(observability, "evaluations", {"kernel": 0, "vmap": 0})
    _, fam, x = _bal_family(dtype)
    r, (J_cam, J_pt) = ev.family_residuals_and_jacobians(fam, x)
    tables = ev._fused_args(fam, x)[0]
    ref = _vmap_jacfwd(tables[0], tables[1], fam.amb_pos[0], fam.amb_pos[1], fam.data)
    for got, want in zip((r, J_cam, J_pt), ref):
        assert torch.equal(got, want)
    assert torch.equal(ev.family_residuals(fam, x), ref[0])
    assert _counts() == {"kernel": 0, "vmap": 2}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_bal_family_takes_the_fused_form_where_it_may(dtype, fused_on_cpu):
    _, fam, x = _bal_family(dtype)
    r, (J_cam, J_pt) = ev.family_residuals_and_jacobians(fam, x)
    r_only = ev.family_residuals(fam, x)
    assert _counts() == {"kernel": 2, "vmap": 0}
    tables = ev._fused_args(fam, x)[0]
    ref = _vmap_jacfwd(tables[0], tables[1], fam.amb_pos[0], fam.amb_pos[1], fam.data)
    for got, want, label in zip((r, J_cam, J_pt), ref, ("r", "J_cam", "J_pt")):
        _held(got, want, RTOL[dtype], label)
    assert torch.equal(r_only, r)
    assert snavely.launches == 0  # the plain version on the CPU: no kernel


def _vmap_bits(fn, *args):
    """``fn(*args)`` with the fused route closed (vmap(jacfwd))."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ev, "FUSED_DEVICE_TYPES", ())
        return fn(*args)


def _same(got, want):
    """Residuals and Jacobians, or cost and gradient, equal to the bit."""
    flat = lambda t: [t[0], *t[1]] if isinstance(t[1], tuple) else list(t)  # noqa: E731
    return all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


@pytest.mark.parametrize("case", ["manifold", "grad_recorded", "non_bal"])
def test_other_evaluations_keep_vmap(case, fused_on_cpu):
    """A family with a manifold, an evaluation that records a gradient (the
    reverse mode of L-BFGS and the line search) and a family of another
    residual keep vmap(jacfwd), bit for bit, and the kernel route counts 0."""
    if case == "manifold":
        _, fam, x = _bal_family(manifold=ctt.SubsetManifold(9, [6, 7, 8]))
        assert fam.structure.manifolds[0] is not None
        calls = [(ev.family_residuals_and_jacobians, fam, x)]
    elif case == "grad_recorded":
        program, fam, x = _bal_family()
        calls = [(ev._cost_grad_impl, x, [fam], program.plus_struct, True, program.num_tangent)]
    else:
        positions, quats, constraints = pose_graph.synthesize_sphere(20, seed=1)[:3]
        program = pose_graph.build_problem_3d(positions, quats, constraints)[0].program("cpu")
        x = torch.from_numpy(program.initial_ambient())
        calls = [(ev.family_residuals_and_jacobians, fam, x) for fam in program.families]
    for fn, *args in calls:
        assert _same(fn(*args), _vmap_bits(fn, *args))
    counts = _counts()
    assert counts["kernel"] == 0 and counts["vmap"] >= 1
    assert snavely.launches == 0


def test_solve_trace_counts_evaluations_by_route(fused_on_cpu):
    """A CPU solve through the fused route: its trace counts every
    evaluation under ``kernel``; the same solve on vmap(jacfwd) reaches the
    same iterations and a final cost within 1e-12."""
    inst = bal.synthesize_bal(num_cameras=4, num_points=120, num_observations=480, seed=2)
    opts = bal.default_options(iterative=False)
    opts.max_num_iterations = 8
    with observability.tracing():
        fused = ctt.solve(opts, bal.build_problem(inst)[0], device="cpu")
        with pytest.MonkeyPatch.context() as m:
            m.setattr(ev, "FUSED_DEVICE_TYPES", ())
            plain = ctt.solve(opts, bal.build_problem(inst)[0], device="cpu")
    assert fused.spans.evaluations["vmap"] == 0
    assert fused.spans.evaluations["kernel"] >= fused.num_iterations > 2
    assert plain.spans.evaluations == {"kernel": 0,
                                       "vmap": fused.spans.evaluations["kernel"]}
    assert fused.num_iterations == plain.num_iterations
    assert fused.num_successful_steps == plain.num_successful_steps
    assert abs(fused.final_cost - plain.final_cost) <= 1e-12 * plain.final_cost


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(ANGLE_AXES))
def test_kernel_matches_plain(device, case, dtype):
    args = [a.to(device) for a in _inputs(case, dtype, B=20011)]
    before = snavely.launches
    got = snavely.evaluate(*args)
    r_only = snavely.evaluate(*args, jacobians=False)
    torch.cuda.synchronize()
    assert snavely.launches == before + 2
    ref = snavely.evaluate_plain(*args)
    for g, r, label in zip(got, ref, ("r", "J_cam", "J_pt")):
        _held(g, r, RTOL[dtype], f"{case} {label}")
    _held(r_only, ref[0], RTOL[dtype], f"{case} r alone")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 127, 128, 129])
def test_kernel_takes_any_batch(device, B):
    args = [a.to(device) for a in _inputs("random", torch.float64, B=max(B, 40))]
    cams, pts, ci, pi, obs = args
    got = snavely.evaluate(cams, pts, ci[:B], pi[:B], obs[:B])
    ref = snavely.evaluate_plain(cams, pts, ci[:B], pi[:B], obs[:B])
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if B:
            _held(g, r, RTOL[torch.float64], f"B={B}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_same_bits_eager_and_captured(device, dtype):
    args = [a.to(device) for a in _inputs("random", dtype, B=50000)]
    first = snavely.evaluate(*args)
    second = snavely.evaluate(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = snavely.evaluate(*args)
        captured_r = snavely.evaluate(*args, jacobians=False)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, captured):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(captured_r, first[0])


@pytest.mark.cuda
def test_flagship_solve_with_the_kernel_matches_vmap(device, monkeypatch):
    """The flagship (16 / 22 106 / 83 718), f64, ITERATIVE_SCHUR +
    SCHUR_JACOBI: the same LM iterations, steps and CG iterations as the
    solve on vmap(jacfwd), the final cost within 1e-12."""
    inst = bal.synthesize_bal(num_cameras=16, num_points=22106, num_observations=83718,
                              noise=2.0, perturb=0.7, seed=16)
    opts = bal.default_options(iterative=True)
    monkeypatch.setattr(observability, "evaluations", {"kernel": 0, "vmap": 0})
    before = snavely.launches
    kernel = ctt.solve(opts, bal.build_problem(inst)[0])
    assert snavely.launches > before
    assert observability.evaluations["vmap"] == 0
    monkeypatch.setattr(ev, "FUSED_DEVICE_TYPES", ())
    plain = ctt.solve(opts, bal.build_problem(inst)[0])
    assert observability.evaluations["vmap"] > 0
    assert kernel.num_iterations == plain.num_iterations
    assert kernel.num_successful_steps == plain.num_successful_steps
    assert kernel.num_linear_solver_iterations == plain.num_linear_solver_iterations
    assert abs(kernel.final_cost - plain.final_cost) <= 1e-12 * plain.final_cost


@pytest.mark.cuda
def test_launches_credited_once_per_replay(device, monkeypatch):
    """A captured solve (its repeat replays the graphs the first captured)
    credits one launch per kernel evaluation the replays ran, as many as the
    same loop run eagerly launches; every evaluation takes the kernel."""
    from ceres_tpu_torch.tools.profile_solve import eager_loop

    inst = bal.synthesize_bal(num_cameras=8, num_points=2000, num_observations=8000,
                              noise=2.0, perturb=0.7, seed=4)
    opts = bal.default_options(iterative=False)
    problem = bal.build_problem(inst)[0]
    start = problem.state().copy()
    monkeypatch.setattr(observability, "evaluations", {"kernel": 0, "vmap": 0})
    before = snavely.launches
    eager, _ = eager_loop(problem, opts)
    eager_launches = snavely.launches - before
    eager_counts = dict(observability.evaluations)
    ctt.solve(opts, problem)  # captures
    problem.write_back(start)
    monkeypatch.setattr(observability, "evaluations", {"kernel": 0, "vmap": 0})
    before = snavely.launches
    repeat = ctt.solve(opts, problem)
    assert repeat.captured_loop
    assert repeat.num_iterations == eager.num_iterations
    assert snavely.launches - before == eager_launches == eager_counts["kernel"] > 0
    assert observability.evaluations == eager_counts
    assert eager_counts["vmap"] == 0
