"""Pose graphs: ceres_tpu_torch.models.pose_graph against
ceres_tpu.models.pose_graph: the generator, both residuals and their
Jacobians, the g2o readers, the programs, and whole solves (float64, CPU).

The solves run CGNR, whose rounding differs between the packages (the same
iterations on Jacobians equal to 1e-12; CG amplifies that, and the LM loop
carries it on). So the records are held as far as that allows: equal LM
iteration counts, per-iteration costs to 1e-4 relative over the first
iterations, the final cost to 1e-6. The tighter record-by-record test of the
port's loop is test_torch_solve.py's, with direct solvers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu_torch.models import pose_graph as tpg

RNG = np.random.default_rng(17)


def _close(t, j, tol=1e-12):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def _unit(q):
    return q / np.linalg.norm(q)


def test_synthesize_sphere_is_the_same_instance():
    a, b = jpg.synthesize_sphere(80, seed=3), tpg.synthesize_sphere(80, seed=3)
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k]) and np.array_equal(a[1][k], b[1][k])
    assert len(a[2]) == len(b[2]) == 79 + 3
    for ca, cb in zip(a[2], b[2]):
        assert (ca.id_begin, ca.id_end) == (cb.id_begin, cb.id_end)
        assert np.array_equal(ca.p, cb.p) and np.array_equal(ca.q, cb.q)
    assert np.array_equal(a[3][0], b[3][0]) and np.array_equal(a[3][1], b[3][1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residual_3d_and_jacobians_match_jax(dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    B = 6
    args = [RNG.standard_normal((B, 3)), np.stack([_unit(RNG.standard_normal(4)) for _ in range(B)]),
            RNG.standard_normal((B, 3)), np.stack([_unit(RNG.standard_normal(4)) for _ in range(B)])]
    data = (RNG.standard_normal((B, 3)), np.stack([_unit(RNG.standard_normal(4)) for _ in range(B)]),
            RNG.standard_normal((B, 6, 6)))
    args = [a.astype(dtype) for a in args]
    data = tuple(d.astype(dtype) for d in data)
    ta, td = [torch.from_numpy(a) for a in args], tuple(torch.from_numpy(d) for d in data)
    ja, jd = [jnp.asarray(a) for a in args], tuple(jnp.asarray(d) for d in data)
    rt = vmap(tpg.pose_graph_3d_residual)(*ta, td)
    rj = jax.vmap(jpg.pose_graph_3d_residual)(*ja, jd)
    assert rt.dtype == getattr(torch, dtype)
    _close(rt, rj, tol)
    Jt = vmap(jacfwd(tpg.pose_graph_3d_residual, argnums=(0, 1, 2, 3)))(*ta, td)
    Jj = jax.vmap(jax.jacfwd(jpg.pose_graph_3d_residual, argnums=(0, 1, 2, 3)))(*ja, jd)
    for t, j in zip(Jt, Jj):
        assert t.dtype == getattr(torch, dtype)  # no float64 tangents in float32
        _close(t, j, tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residual_2d_and_jacobians_match_jax(dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    B = 7
    a, b = RNG.standard_normal((B, 3)).astype(dtype), RNG.standard_normal((B, 3)).astype(dtype)
    a[0, 2], b[0, 2] = 3.0, -3.0  # the wrap of normalize_angle
    data = (RNG.standard_normal((B, 2)).astype(dtype), RNG.standard_normal(B).astype(dtype),
            RNG.standard_normal((B, 3, 3)).astype(dtype))
    td, jd = tuple(torch.from_numpy(d) for d in data), tuple(jnp.asarray(d) for d in data)
    rt = vmap(tpg.pose_graph_2d_residual)(torch.from_numpy(a), torch.from_numpy(b), td)
    rj = jax.vmap(jpg.pose_graph_2d_residual)(jnp.asarray(a), jnp.asarray(b), jd)
    _close(rt, rj, tol)
    Jt = vmap(jacfwd(tpg.pose_graph_2d_residual, argnums=(0, 1)))(
        torch.from_numpy(a), torch.from_numpy(b), td)
    Jj = jax.vmap(jax.jacfwd(jpg.pose_graph_2d_residual, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b), jd)
    for t, j in zip(Jt, Jj):
        assert t.dtype == getattr(torch, dtype)
        _close(t, j, tol)
    x = np.linspace(-10, 10, 41)
    _close(tpg.normalize_angle(torch.from_numpy(x)), jpg.normalize_angle(jnp.asarray(x)))


def _graph_2d(n=50, seed=4):
    """A noisy ring of n poses with chords, as the constraints of both."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([4 * np.cos(th), 4 * np.sin(th), th + np.pi / 2], axis=1)
    poses = {i: gt[i] + np.array([0.3, 0.3, 0.1]) * rng.standard_normal(3) for i in range(n)}
    edges = [(i, (i + 1) % n) for i in range(n)] + [(i, (i + 7) % n) for i in range(0, n, 5)]
    raw = []
    for a, b in edges:
        c, s = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        d = gt[b, :2] - gt[a, :2]
        rel = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]]) + 0.02 * rng.standard_normal(2)
        yaw = float(np.asarray(jpg.normalize_angle(gt[b, 2] - gt[a, 2] + 0.01 * rng.standard_normal())))
        A = rng.standard_normal((3, 3))
        raw.append((a, b, rel[0], rel[1], yaw, A @ A.T + 3 * np.eye(3)))
    return poses, raw


def _both_2d():
    poses, raw = _graph_2d()
    jp = jpg.build_problem_2d(poses, [jpg.Constraint2d(*r) for r in raw])[0]
    tp = tpg.build_problem_2d(poses, [tpg.Constraint2d(*r) for r in raw])[0]
    return jp, tp


def _both_3d(n=60, seed=1):
    inst = jpg.synthesize_sphere(n, seed=seed)
    jp = jpg.build_problem_3d(*inst[:3])[0]
    tp = tpg.build_problem_3d(*tpg.synthesize_sphere(n, seed=seed)[:3])[0]
    return jp, tp


@pytest.mark.parametrize("build", [_both_2d, _both_3d], ids=["2d", "3d"])
def test_program_and_evaluation_match_jax(build):
    jp, tp = build()
    jprog, tprog = jp.program(), tp.program("cpu")
    assert (tprog.num_ambient, tprog.num_tangent) == (jprog.num_ambient, jprog.num_tangent)
    assert tprog.ambient_offset == jprog.ambient_offset
    for T, tab in jprog.bd_groups.items():
        assert np.array_equal(tprog.bd_groups[T], tab)
    # few groups: one-hot matmuls on the CPU (the card takes the same kinds
    # at these sizes)
    assert {p.kind for p in tprog.families[0].reduce_plans} == {"onehot"}
    ej = jp.evaluate(residuals=True, gradient=True, jacobian=True)
    et = tp.evaluate(residuals=True, gradient=True, jacobian=True, device="cpu")
    np.testing.assert_allclose(et["cost"], ej["cost"], rtol=1e-12)
    for key in ("residuals", "gradient", "jacobian"):
        np.testing.assert_allclose(et[key], ej[key], rtol=1e-10, atol=1e-10)


def _state(p):
    return np.concatenate([p.parameter_block_value(i) for i in p.parameter_block_ids()])


@pytest.mark.parametrize("build", [_both_2d, _both_3d], ids=["2d", "3d"])
def test_solve_matches_jax(build):
    jp, tp = build()
    sj = ct.solve(jpg.default_options(), jp)
    st = ctt.solve(tpg.default_options(), tp, device="cpu")
    assert st.termination_type.name == sj.termination_type.name == "CONVERGENCE"
    assert st.linear_solver_type_used.name == "CGNR"
    assert len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(st.initial_cost, sj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-6)
    for a, b in zip(st.iterations[:4], sj.iterations[:4]):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-4)
        assert a.step_is_successful == b.step_is_successful
    assert st.final_cost < 0.05 * st.initial_cost
    # the first pose stayed where it was, and quaternions stayed unit
    x = _state(tp)
    first = tp.parameter_block_ids()[0]
    assert tp.is_parameter_block_constant(first)
    assert np.array_equal(tp.parameter_block_value(first), jp.parameter_block_value(first))
    np.testing.assert_allclose(x, _state(jp), rtol=0, atol=2e-3 * np.abs(x).max())


def test_solve_3d_with_direct_solver_matches_jax_record_by_record():
    """The same graph with DENSE_QR (no CG rounding): equal iteration
    counts, per-iteration costs to 1e-9, final state to 1e-8."""
    jp, tp = _both_3d(n=40, seed=2)
    oj, ot = jpg.default_options(), tpg.default_options()
    oj.linear_solver_type = ct.LinearSolverType.DENSE_QR
    ot.linear_solver_type = ctt.LinearSolverType.DENSE_QR
    sj, st = ct.solve(oj, jp), ctt.solve(ot, tp, device="cpu")
    assert len(st.iterations) == len(sj.iterations) > 3
    assert st.termination_type.name == sj.termination_type.name
    for a, b in zip(st.iterations, sj.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-9)
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
    xj = _state(jp)
    np.testing.assert_allclose(_state(tp), xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    q = np.stack([tp.parameter_block_value(i) for i in tp.parameter_block_ids()[1::2]])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-12)


def test_solve_3d_float32_close_to_float64():
    _, t64 = _both_3d()
    _, t32 = _both_3d()
    o32 = tpg.default_options()
    o32.evaluation_dtype = "float32"
    s64 = ctt.solve(tpg.default_options(), t64, device="cpu")
    s32 = ctt.solve(o32, t32, device="cpu")
    assert s32.is_solution_usable()
    np.testing.assert_allclose(s32.final_cost, s64.final_cost, rtol=1e-4)


def test_g2o_readers_match_jax(tmp_path):
    poses, raw = _graph_2d(n=8)
    def fmt(values):
        return " ".join(repr(float(v)) for v in values)

    lines = [f"VERTEX_SE2 {i} {fmt(p)}" for i, p in poses.items()]
    for a, b, x, y, yaw, info in raw:
        u = [info[0, 0], info[0, 1], info[0, 2], info[1, 1], info[1, 2], info[2, 2]]
        lines.append(f"EDGE_SE2 {a} {b} {fmt([x, y, yaw])} {fmt(u)}")
    f2 = tmp_path / "g.g2o"
    f2.write_text("\n".join(lines) + "\n\n")
    (pj, cj), (pt, ct_) = jpg.read_g2o_2d(f2), tpg.read_g2o_2d(f2)
    assert list(pj) == list(pt) and all(np.array_equal(pj[k], pt[k]) for k in pj)
    assert len(cj) == len(ct_) == len(raw)
    for a, b in zip(cj, ct_):
        assert (a.id_begin, a.id_end, a.x, a.y, a.yaw) == (b.id_begin, b.id_end, b.x, b.y, b.yaw)
        assert np.array_equal(a.information, b.information)

    positions, quats, cons, _ = tpg.synthesize_sphere(6, seed=5)
    lines = [f"VERTEX_SE3:QUAT {i} {fmt((*positions[i], *quats[i]))}" for i in positions]
    for c in cons:
        upper = [c.information[i, j] for i in range(6) for j in range(i, 6)]
        lines.append(f"EDGE_SE3:QUAT {c.id_begin} {c.id_end} {fmt((*c.p, *c.q, *upper))}")
    f3 = tmp_path / "s.g2o"
    f3.write_text("\n".join(lines) + "\n")
    rj, rt = jpg.read_g2o_3d(f3), tpg.read_g2o_3d(f3)
    for k in rj[0]:
        assert np.array_equal(rj[0][k], rt[0][k]) and np.array_equal(rj[1][k], rt[1][k])
    for a, b in zip(rj[2], rt[2]):
        assert np.array_equal(a.p, b.p) and np.array_equal(a.q, b.q)
        assert np.array_equal(a.information, b.information)
    # and a graph read from a file solves
    problem = tpg.build_problem_3d(*rt)[0]
    assert ctt.solve(tpg.default_options(), problem, device="cpu").is_solution_usable()


def test_default_options_match_jax():
    oj, ot = jpg.default_options(), tpg.default_options()
    assert ot.linear_solver_type.name == oj.linear_solver_type.name == "CGNR"
    assert ot.preconditioner_type.name == oj.preconditioner_type.name == "JACOBI"
    assert ot.max_num_iterations == oj.max_num_iterations == 200
