"""BAL model parity: ceres_tpu_torch.models.bal against ceres_tpu.models.bal.

Same seed -> bit-identical synthetic arrays; the Snavely residuals and
both Jacobian blocks at x0 agree in f64 (rtol 1e-10) and in f32 (rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.evaluator import family_residuals_and_jacobians as jax_res_jac
from ceres_tpu.models import bal as jbal
from ceres_tpu.problem import cast_program as jax_cast
from ceres_tpu_torch.evaluator import family_residuals_and_jacobians
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.problem import cast_program

SIZES = dict(num_cameras=5, num_points=400, num_observations=1500, noise=2.0, perturb=0.7)


@pytest.mark.parametrize("seed", [0, 16])
def test_synthesize_bal_bit_identical(seed):
    a = jbal.synthesize_bal(**SIZES, seed=seed)
    b = tbal.synthesize_bal(**SIZES, seed=seed)
    for name in ("cameras", "points", "camera_index", "point_index", "observations"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_build_problem_layout_matches():
    inst = jbal.synthesize_bal(**SIZES, seed=4)
    jp, jc, jpt = jbal.build_problem(inst)
    tp, tc, tpt = tbal.build_problem(inst)
    assert np.array_equal(jc, tc) and np.array_equal(jpt, tpt)
    jprog, tprog = jp.program(), tp.program("cpu")
    assert jprog.ambient_offset == tprog.ambient_offset
    assert np.array_equal(np.asarray(jprog.initial_ambient()), tprog.initial_ambient())
    assert np.array_equal(
        np.asarray(jprog.families[0].block_ids), tprog.families[0].block_ids
    )


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10), ("float32", 1e-4)])
def test_residuals_and_jacobians_at_x0(dtype, rtol):
    inst = jbal.synthesize_bal(**SIZES, seed=7)
    jprog = jbal.build_problem(inst)[0].program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    jax_cast(jprog, dtype)
    cast_program(tprog, dtype)
    x0 = np.asarray(jprog.initial_ambient())
    rj, Jj = jax_res_jac(jprog.families[0], jnp.asarray(x0, dtype))
    rt, Jt = family_residuals_and_jacobians(
        tprog.families[0], torch.tensor(x0, dtype=getattr(torch, dtype))
    )
    assert rt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=rtol, atol=rtol * 1e-2)
    assert len(Jt) == len(Jj) == 2
    for a, b in zip(Jt, Jj):
        assert a.dtype == rt.dtype and a.shape == b.shape
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=rtol * scale)


def test_loss_and_constant_blocks_are_roadmap_items():
    """A loss, constant blocks and parameter bounds are in the port: a
    bounded solve (the host loop) converges with the focal-length bound
    respected, with inner iterations too, and with SPARSE_SCHUR. A mesh
    that is no DeviceMesh (the sharded evaluation, item 19, is in the port
    too) and an object that is no loss are refused, naming what they must
    be."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.problem import Problem

    inst = tbal.synthesize_bal(**SIZES, seed=1)
    problem, cams, _ = tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))
    assert problem.program("cpu").families[0].loss is not None
    ids = Problem().add_parameter_blocks(inst.cameras, constant=True)
    assert ids.shape == (inst.cameras.shape[0],)
    # the second camera's focal length (index 6) may not rise above its
    # start, and the solve would take it higher: the bound ends active
    focal = float(problem.parameter_block_value(int(cams[1]))[6])
    problem.set_parameter_upper_bound(int(cams[1]), 6, focal)
    opts = tbal.default_options(iterative=False)
    opts.max_num_iterations = 50
    s = ctt.solve(opts, problem, device="cpu")
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert s.final_cost < 0.1 * s.initial_cost
    assert problem.parameter_block_value(int(cams[1]))[6] == focal
    opts.use_inner_iterations = True
    s = ctt.solve(opts, problem, device="cpu")
    assert s.is_solution_usable() and s.num_inner_iteration_steps > 0
    assert problem.parameter_block_value(int(cams[1]))[6] <= focal
    opts.linear_solver_type = ctt.LinearSolverType.SPARSE_SCHUR
    s = ctt.solve(opts, problem, device="cpu")
    assert s.is_solution_usable() and s.linear_solver_type_used == opts.linear_solver_type
    assert problem.parameter_block_value(int(cams[1]))[6] <= focal
    opts.mesh = object()
    with pytest.raises(TypeError, match="DeviceMesh"):
        ctt.solve(opts, problem, device="cpu")
    with pytest.raises(TypeError, match="LossFunction"):
        tbal.build_problem(inst, loss=object())
