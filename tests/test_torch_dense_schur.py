"""The large-case path on the CPU: DENSE_SCHUR and the explicit-S call sites
of the unsorted (K3) and fused pair-outer (K4) kernels, through their plain
versions, against the JAX package.

- explicit S with the plan kinds a CUDA device gets (``choose_plan_kind``
  patched to answer as for "cuda"): f64, 1e-10 relative to max|S|;
- DENSE_SCHUR ``solve_schur`` step: f64, 1e-10;
- DENSE_SCHUR ``fused_solve``: f64 with equal iteration and step counts and
  final cost to 1e-12 relative; f32 against f32 to 1e-4 (near the optimum
  f32 rounding decides single accept/reject outcomes);
- the vectorized e-block ordering against a block-by-block greedy loop.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.linear import schur as jschur
from ceres_tpu.linear.schur_explicit import assemble_reduced_system as jax_assemble
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_SUCCESS
from ceres_tpu_torch.linear.schur_explicit import assemble_reduced_system, build_explicit_plan
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import outer_segment_sum as osum
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.trust_region import _config_from_options
from ceres_tpu_torch.types import LinearSolverType


def _close(a, b, rtol):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()))


def _contexts(inst):
    jprog = jbal.build_problem(inst)[0].program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    x0 = np.asarray(jprog.initial_ambient())
    _, _, ctx_j = jax_full(jnp.asarray(x0), jprog.families, True,
                           jprog.num_tangent, jprog.jnp_bd_groups())
    _, _, ctx_t = _full_impl(torch.tensor(x0), tprog.families, tprog.num_tangent,
                             tprog.groups)
    return jprog, tprog, ctx_j, ctx_t


def test_explicit_s_with_cuda_plan_kinds(monkeypatch):
    """300 cameras: with the plan kinds of a CUDA device the F'F site and
    the self-pair group reduce in natural order through K3's plain version
    and the strict-lower pair group through K4's; S equals the JAX one."""
    choose = tred.choose_plan_kind
    monkeypatch.setattr(tred, "choose_plan_kind", lambda seg, G, _dev: choose(seg, G, "cuda"))
    monkeypatch.setattr(tred, "SORTED_MIN_ROWS", 256)
    inst = jbal.synthesize_bal(num_cameras=300, num_points=1500, num_observations=9000,
                               noise=2.0, perturb=0.7, seed=11)
    jprog, tprog, ctx_j, ctx_t = _contexts(inst)
    fam = tprog.families[0]
    assert [p.kind for p in fam.reduce_plans] == ["unsorted", "sorted"]
    ss_j = jschur.build_schur_structure(jprog, with_explicit=True)
    ss_t = tschur.build_schur_structure(tprog)
    ss_t.explicit = build_explicit_plan(tprog, ss_t)
    plan = ss_t.explicit
    assert any(s.perm is None and s.plan.kind == "unsorted" for s in plan.ftf)
    assert any(g.natural and g.plan.kind == "unsorted" for g in plan.corr)
    fused = [g for g in plan.corr if not g.self_pairs and g.plan.kind == "sorted"]
    assert fused and fused[0].a_idx.dtype == torch.int32

    calls = []
    plain = osum.outer_segment_sum_plain
    monkeypatch.setattr(
        osum, "outer_segment_sum_plain", lambda *a: calls.append(1) or plain(*a)
    )
    D = np.random.default_rng(1).uniform(0.5, 3.0, tprog.num_tangent)
    op_j = jschur.SchurOperator(ctx_j, jnp.asarray(D), ss_j)
    op_t = tschur.SchurOperator(ctx_t, torch.tensor(D), ss_t)
    S_t = assemble_reduced_system(op_t, plan)
    assert len(calls) == len(fused)  # the K4 wrapper served the pair group
    _close(S_t, jax_assemble(op_j, ss_j.explicit), 1e-10)
    # camera-side gradient through the unsorted plan
    _close(ctx_t.gradient(), ctx_j.gradient(), 1e-10)


def test_dense_schur_step_matches_jax():
    inst = jbal.synthesize_bal(num_cameras=6, num_points=900, num_observations=3300,
                               noise=2.0, perturb=0.7, seed=9)
    jprog, tprog, ctx_j, ctx_t = _contexts(inst)
    ss_j = jschur.build_schur_structure(jprog, with_explicit=True)
    ss_t = tschur.build_schur_structure(tprog)
    ss_t.explicit = build_explicit_plan(tprog, ss_t)
    D = np.random.default_rng(2).uniform(0.5, 3.0, tprog.num_tangent)
    cfg_j = jax_config(jbal.default_options(iterative=False), jprog)
    cfg_t = _config_from_options(tbal.default_options(iterative=False))
    assert cfg_t.linear_solver_type == LinearSolverType.DENSE_SCHUR
    y_t, it_t, term_t = tschur.solve_schur(ctx_t, torch.tensor(D), cfg_t, ss_t)
    y_j, it_j, term_j = jschur.solve_schur(ctx_j, jnp.asarray(D), jprog, cfg_j, ss=ss_j)
    assert int(it_t) == int(it_j) == 1
    assert int(term_t) == int(term_j) == CG_SUCCESS
    _close(y_t, y_j, 1e-10)


def test_dense_schur_indefinite_system_is_a_failure():
    """No damping on a gauge-free problem with a wrecked Jacobian: the
    Cholesky of S fails, the step is non-finite and the code is FAILURE
    (the JAX package returns NaN and FAILURE as well)."""
    inst = jbal.synthesize_bal(num_cameras=4, num_points=60, num_observations=200,
                               noise=2.0, perturb=0.7, seed=1)
    _, tprog, _, ctx_t = _contexts(inst)
    ss_t = tschur.build_schur_structure(tprog)
    ss_t.explicit = build_explicit_plan(tprog, ss_t)
    cfg_t = _config_from_options(tbal.default_options(iterative=False))
    # Zero camera Jacobians and zero damping on the cameras: S = 0.
    jacs = tuple((torch.zeros_like(j[0]), j[1]) for j in ctx_t.jacs)
    ctx0 = dataclasses.replace(ctx_t, jacs=jacs)
    D = torch.ones(tprog.num_tangent, dtype=torch.float64)
    D[ss_t.f_idx] = 0.0
    y, it, term = tschur.solve_schur(ctx0, D, cfg_t, ss_t)
    assert int(term) == CG_FAILURE and int(it) == 1
    assert not bool(torch.isfinite(y).all())


SIZES = dict(num_cameras=40, num_points=2000, num_observations=9000, noise=2.0, perturb=0.7)


def _options(module, dtype):
    opts = module.default_options(iterative=False)
    opts.max_num_iterations = 8
    opts.evaluation_dtype = dtype
    return opts


def test_dense_schur_fused_solve_f64_matches_jax():
    inst = jbal.synthesize_bal(**SIZES, seed=7)
    jp = jbal.build_problem(inst)[0]
    tp = tbal.build_problem(inst)[0]
    sj = jax_fused_solve(_options(jbal, None), jp)
    st = ctt.fused_solve(_options(tbal, None), tp, device="cpu")
    assert st.linear_solver_type_used == LinearSolverType.DENSE_SCHUR
    assert st.num_iterations == len(sj.iterations) >= 3
    assert st.num_successful_steps == sj.num_successful_steps
    assert st.num_linear_solver_iterations == sj.num_linear_solver_iterations
    assert st.termination_type.name == sj.termination_type.name
    np.testing.assert_allclose(st.initial_cost, sj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-12)
    assert st.final_cost < 1e-2 * st.initial_cost


def test_dense_schur_fused_solve_f32_matches_jax():
    inst = jbal.synthesize_bal(**SIZES, seed=7)
    sj = jax_fused_solve(_options(jbal, "float32"), jbal.build_problem(inst)[0])
    st = ctt.fused_solve(_options(tbal, "float32"), tbal.build_problem(inst)[0], device="cpu")
    assert st.final_cost < 1e-2 * st.initial_cost
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-4)


def test_solve_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    tp = tbal.build_problem(tbal.synthesize_bal(
        num_cameras=3, num_points=30, num_observations=90, seed=1))[0]
    for entry in (ctt.fused_solve, ctt.solve):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            entry(tbal.default_options(iterative=False), tp)


# ---- e-block ordering ------------------------------------------------------


def _greedy_ordering(block_sizes, families):
    """Block-by-block greedy maximal independent set in (size, -degree,
    id) order: the definition the vectorized ordering must reproduce."""
    occ = {}
    for fi, ids in enumerate(families):
        for j in range(ids.shape[1]):
            for i, pid in enumerate(ids[:, j].tolist()):
                occ.setdefault(pid, []).append((fi, i))
    n = len(block_sizes)
    order = sorted(range(n), key=lambda p: (block_sizes[p], -len(occ.get(p, []))))
    blocked, out = set(), []
    for pid in order:
        if any(o in blocked for o in occ.get(pid, [])):
            continue
        out.append(pid)
        blocked.update(occ.get(pid, []))
    return out


def _fake_program(block_sizes, families):
    sizes = np.asarray(block_sizes, dtype=np.int64)
    return types.SimpleNamespace(
        block_sizes=sizes,
        tangent_sizes=sizes,
        active=np.ones(sizes.shape[0], dtype=bool),
        num_pids=sizes.shape[0],
        families=[types.SimpleNamespace(block_ids=ids) for ids in families],
        num_parameter_blocks=lambda: sizes.shape[0],
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ordering_matches_greedy_loop_on_random_graphs(seed):
    """Equal-size blocks tied together at random (pose-graph-like chains
    and triples): the greedy set needs many rounds, not one."""
    rng = np.random.default_rng(seed)
    n = 300
    sizes = rng.choice([3, 3, 3, 6], n)
    pairs = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)  # a chain
    extra = rng.integers(0, n, (200, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    triples = np.stack([rng.permutation(n)[:3] for _ in range(60)])
    families = [pairs, extra, triples]
    got = tschur.compute_schur_ordering(_fake_program(sizes, families))
    assert got == _greedy_ordering(sizes.tolist(), families)
    assert 0 < len(got) < n


@pytest.mark.parametrize(
    "cams,pts,obs,seed", [(6, 900, 3300, 9), (16, 500, 2100, 4), (40, 2000, 9000, 7)]
)
def test_ordering_matches_jax_on_bal(cams, pts, obs, seed):
    inst = jbal.synthesize_bal(num_cameras=cams, num_points=pts, num_observations=obs,
                               noise=2.0, perturb=0.7, seed=seed)
    jprog = jbal.build_problem(inst)[0].program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    got = tschur.compute_schur_ordering(tprog)
    assert got == jschur.compute_schur_ordering(jprog)
    assert got == _greedy_ordering(tprog.block_sizes.tolist(), [f.block_ids for f in tprog.families])


# -- Schur elimination on programs with a loss, constant and manifold blocks --


def _modeled_bal():
    """Robust BAL with a constant camera, two constant points and a camera
    on a Subset manifold (focal length and distortion held): tangent size 6
    beside 9, dummy rows on both sides, corrected Jacobians."""
    import ceres_tpu as ct

    inst = jbal.synthesize_bal(num_cameras=7, num_points=300, num_observations=1300,
                               noise=2.0, perturb=0.6, seed=4)
    out = []
    for mod, module in ((ct, jbal), (ctt, tbal)):
        p, cams, pts = module.build_problem(inst, loss=mod.loss.HuberLoss(1.0))
        p.set_parameter_block_constant(int(cams[2]))
        p.set_parameter_block_constant(pts[[5, 17]])
        out.append(p)
    return out


def _pose_graph():
    from ceres_tpu.models import pose_graph as jpg
    from ceres_tpu_torch.models import pose_graph as tpg

    inst = jpg.synthesize_sphere(40, seed=2)
    return (jpg.build_problem_3d(*inst[:3])[0],
            tpg.build_problem_3d(*tpg.synthesize_sphere(40, seed=2)[:3])[0])


@pytest.mark.parametrize("build", [_modeled_bal, _pose_graph], ids=["robust_bal", "pose_graph"])
def test_schur_ordering_and_structure_match_jax_on_modeled_programs(build):
    jp, tp = build()
    jprog, tprog = jp.program(), tp.program("cpu")
    e_j = jschur.compute_schur_ordering(jprog)
    e_t = tschur.compute_schur_ordering(tprog)
    assert e_t == [int(p) for p in e_j]
    assert not any(tprog.constant[p] for p in e_t)
    if build is _pose_graph:
        # positions and quaternions of one pose share residual blocks, so
        # the independent set mixes e and f blocks in one argument: both
        # packages refuse to eliminate (pose graphs run CGNR)
        for mod, prog in ((jschur, jprog), (tschur, tprog)):
            with pytest.raises(ValueError, match="mixed e/f"):
                mod.build_schur_structure(prog)
        return
    ss_j = jschur.build_schur_structure(jprog, with_explicit=True)
    ss_t = tschur.build_schur_structure(tprog)
    assert (ss_t.num_points, ss_t.e_tangent_size, ss_t.e_arg) == (
        ss_j.num_points, ss_j.e_tangent_size, ss_j.e_arg)
    assert np.array_equal(ss_t.e_group.numpy(), np.asarray(ss_j.e_group))
    assert np.array_equal(ss_t.f_idx.numpy(), np.asarray(ss_j.f_idx))
    assert np.array_equal(ss_t.f_mask.numpy(), np.asarray(ss_j.f_mask))
    assert list(ss_t.f_groups) == list(ss_j.f_groups)
    for T in ss_j.f_groups:
        assert np.array_equal(ss_t.f_groups[T].numpy(), np.asarray(ss_j.f_groups[T]))
    for fi in range(len(jprog.families)):
        ej, et = ss_j._host_e_pos[fi], ss_t.host_e_pos[fi]
        assert (ej is None) == (et is None)
        if ej is not None:
            assert np.array_equal(et, ej)
        for a, b in zip(ss_t.host_f_pos[fi], ss_j._host_f_pos[fi]):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b)


@pytest.mark.parametrize("iterative", [False, True], ids=["dense_schur", "iterative_schur"])
def test_schur_step_on_robust_program_with_constant_blocks_matches_jax(iterative):
    """solve_schur on corrected Jacobians with dummy rows on both sides:
    the step equals JAX's (1e-9, f64) and solves the full damped normal
    equations of the corrected system."""
    jp, tp = _modeled_bal()
    jprog, tprog = jp.program(), tp.program("cpu")
    x0 = np.asarray(jprog.initial_ambient())
    _, _, ctx_j = jax_full(jnp.asarray(x0), jprog.families, True, jprog.num_tangent,
                           jprog.jnp_bd_groups())
    _, _, ctx_t = _full_impl(torch.tensor(x0), tprog.families, tprog.num_tangent, tprog.groups)
    ss_j = jschur.build_schur_structure(jprog, with_explicit=True)
    ss_t = tschur.build_schur_structure(tprog)
    ss_t.explicit = build_explicit_plan(tprog, ss_t)
    D = np.random.default_rng(3).uniform(0.5, 3.0, tprog.num_tangent)
    oj, ot = jbal.default_options(iterative=iterative), tbal.default_options(iterative=iterative)
    oj.eta = ot.eta = 1e-10
    y_t, it_t, term_t = tschur.solve_schur(ctx_t, torch.tensor(D), _config_from_options(ot), ss_t)
    y_j, it_j, term_j = jschur.solve_schur(ctx_j, jnp.asarray(D), jprog,
                                           jax_config(oj, jprog), ss=ss_j)
    assert int(term_t) == int(term_j) == CG_SUCCESS and int(it_t) == int(it_j)
    _close(y_t, y_j, 1e-9)
    Dt = torch.tensor(D)
    res = ctx_t.normal_matvec(y_t) + Dt * Dt * y_t - ctx_t.gradient()
    # (CG on S stops by its Q test, not at the factorization's accuracy)
    assert float(res.norm() / ctx_t.gradient().norm()) < (1e-6 if iterative else 1e-9)


def test_constant_camera_keeps_the_point_side_sorted():
    """A constant block sends its rows to the dummy group G. With a constant
    camera that lands in the middle of the camera list, which was in no
    order anyway; the point side stays sorted, so a CUDA device still gives
    it the sorted kernel (``choose_plan_kind`` is pure: asked as for
    "cuda"). A constant point does break the point side's order: its plan
    falls to the unsorted kind (or to index_add_ above its cap)."""
    inst = tbal.synthesize_bal(num_cameras=20, num_points=3000, num_observations=12000, seed=6)
    p, cams, pts = tbal.build_problem(inst, loss=ctt.HuberLoss(1.0))
    p.set_parameter_block_constant(int(cams[3]))
    fam = p.program("cpu").families[0]
    cam_ids, pt_ids = fam.bd_pos[0].numpy(), fam.bd_pos[1].numpy()
    assert (cam_ids == 19).sum() == (fam.block_ids[:, 0] == cams[3]).sum() > 0
    assert tred.choose_plan_kind(pt_ids, 3000, "cuda") == "sorted"
    assert tred.choose_plan_kind(cam_ids, 19, "cuda") == "onehot"
    ss = tschur.build_schur_structure(p.program("cpu"))
    assert tred.choose_plan_kind(ss.host_e_pos[0], ss.num_points, "cuda") == "sorted"
    p.set_parameter_block_constant(int(pts[100]))
    pt_ids = p.program("cpu").families[0].bd_pos[1].numpy()
    assert (pt_ids == 2999).sum() > 0 and not np.all(pt_ids[1:] >= pt_ids[:-1])
    assert tred.choose_plan_kind(pt_ids, 2999, "cuda") == "unsorted"
