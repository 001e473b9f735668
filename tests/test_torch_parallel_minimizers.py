"""More sharded solves of the port on gloo ranks on the CPU (see
tests/test_torch_parallel.py, whose rank function runs these cases too):
a robust loss, the line-search minimizer and DOGLEG, held to the port's
one-process solve and to the JAX package's; a point whose rows lie in three
families; a 2 x 2 mesh; one f32 LM iteration (``__graft_entry__.
dryrun_multichip``'s counterpart); and ``bundle_adjuster --mesh 2`` under
``torch.distributed.run``, held to the JAX program on the same argv.

Tolerances as in tests/test_torch_parallel.py; the f32 step within 2e-4 of
the one-process step (``__graft_entry__.py:120-126``); the 2 x 2 mesh, the
1-D mesh's records to the bit (both are four ranks in one order); the
example, every printed progress row and the final cost to the printed
digits.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.problem import Problem
from test_torch_parallel import (
    JAX_RTOL,
    held_to_one_process,
    jax_solve,
    port_solve,
    spawn_cases,
    summary_record,
)

REPO = Path(__file__).resolve().parent.parent
FILE_CASES = ["iterative_schur_huber", "line_search", "dogleg"]
STEP_RTOL = 2e-4  # __graft_entry__.py:120-126


def _prior(p, target):
    return 0.5 * (p - target)


def straddle_problem():
    """The test instance's observations in two families (even and odd rows,
    each point-sorted: every point with two observations or more has rows
    in both), a prior on 40 points (a third family), a constant camera and
    a constant point (whose rows with that camera leave for the fixed
    families)."""
    inst = tbal.synthesize_bal(num_cameras=4, num_points=100, num_observations=397, seed=9)
    p = Problem()
    cams = p.add_parameter_blocks(inst.cameras)
    pts = p.add_parameter_blocks(inst.points)
    order = np.argsort(inst.point_index, kind="stable")
    ci, pi, obs = inst.camera_index[order], inst.point_index[order], inst.observations[order]
    for part in (np.arange(ci.shape[0]) % 2 == 0, np.arange(ci.shape[0]) % 2 == 1):
        p.add_residual_blocks(tbal.snavely_reprojection_residual, None,
                              [cams[ci[part]], pts[pi[part]]], data=obs[part])
    p.add_residual_blocks(_prior, None, [pts[:40]], data=inst.points[:40] + 0.1)
    p.set_parameter_block_constant(cams[0])
    p.set_parameter_block_constant(pts[pi[0]])
    return p


def straddle_solve(mesh=None):
    opts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                             max_num_iterations=10, mesh=mesh)
    problem = straddle_problem()
    return summary_record(ctt.solve(opts, problem, device="cpu"), problem)


def one_lm_iteration(mesh=None):
    """One f32 LM iteration of __graft_entry__._build's instance and
    options at radius 100: (cost, candidate cost, candidate)."""
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.problem import cast_program
    from ceres_tpu_torch.solver import initial_state
    from ceres_tpu_torch.trust_region import _make_lm_step_fn

    problem, _, _ = tbal.build_problem(
        tbal.synthesize_bal(num_cameras=4, num_points=64, num_observations=256, seed=0))
    program = problem.program("cpu")
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
        max_linear_solver_iterations=10, evaluation_dtype="float32", mesh=mesh)
    cast_program(program, "float32")
    if mesh is not None:
        from ceres_tpu_torch.parallel import shard_program

        shard_program(program, mesh)
    x = initial_state(program, mesh)
    ev = Evaluator(program)
    full = ev.cost_gradient_jacobian(x)
    step, _, _, _ = _make_lm_step_fn(options, program)(full.jacobian_context, 100.0)
    cand = program.plus(x, step)
    return float(full.cost), float(ev.cost(cand)), cand.tolist()


RANK_CASES = {
    2: FILE_CASES + ["straddle", "step_f32"],
    4: FILE_CASES + ["straddle", "step_f32", "dense_schur", "dense_schur@2x2", "step_f32@2x2"],
}


@pytest.fixture(scope="module")
def sharded():
    """{world size: the ranks' results} for every case of this file."""
    return {world: spawn_cases(world, names) for world, names in RANK_CASES.items()}


@pytest.fixture(scope="module")
def one_process():
    return {name: port_solve(name) for name in FILE_CASES}


@pytest.fixture(scope="module")
def jax_reference():
    return {name: (jax_solve(name, None), jax_solve(name, 8)) for name in FILE_CASES}


WORLDS = pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])


@WORLDS
@pytest.mark.parametrize("name", FILE_CASES)
def test_sharded_solve_matches_one_process(sharded, one_process, world, name):
    got = sharded[world][0][name]
    assert got["num_devices"] == world
    held_to_one_process(got, one_process[name])


@WORLDS
@pytest.mark.parametrize("name", FILE_CASES)
def test_sharded_solve_matches_the_jax_package(sharded, jax_reference, world, name):
    got = sharded[world][0][name]["final_cost"]
    unsharded, on_mesh = jax_reference[name]
    np.testing.assert_allclose(got, unsharded, rtol=JAX_RTOL)
    np.testing.assert_allclose(got, on_mesh, rtol=JAX_RTOL)


@WORLDS
def test_every_rank_returns_the_same_summary(sharded, world):
    ranks = sharded[world]
    assert all(r == ranks[0] for r in ranks[1:])


@WORLDS
def test_a_point_in_three_families_straddles_no_cut(sharded, world):
    """The straddling instance: the same records as one process."""
    ref = straddle_solve()
    assert len(ref["records"]) > 2
    held_to_one_process(sharded[world][0]["straddle"], ref)


@pytest.mark.parametrize("world,kind", [(2, "step_f32"), (4, "step_f32"), (4, "step_f32@2x2")])
def test_one_f32_lm_iteration_matches_one_process(sharded, world, kind):
    cost, cand_cost, cand = sharded[world][0][kind]
    ref_cost, _, ref = one_lm_iteration()
    assert cand_cost < cost
    np.testing.assert_allclose(cost, ref_cost, rtol=1e-6)
    np.testing.assert_allclose(cand, ref, rtol=STEP_RTOL, atol=STEP_RTOL)


def test_a_2x2_mesh_gives_the_1d_result(sharded):
    ranks = sharded[4]
    assert ranks[0]["dense_schur@2x2"] == ranks[0]["dense_schur"]
    held_to_one_process(ranks[0]["dense_schur@2x2"], port_solve("dense_schur"))


def _progress(text):
    """(iteration, cost) of the progress rows, the final cost and the
    termination line of a bundle_adjuster run's output."""
    rows = re.findall(r"^\s*(\d+) (\d\.\d{6}e[+-]\d\d) ", text, re.M)
    final = re.findall(r"Final cost\s+(\S+)", text)
    term = re.findall(r"^Termination: (\S+)", text, re.M)
    return rows, final, term


def test_bundle_adjuster_mesh_2_prints_the_jax_summary(monkeypatch, capsys):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    ceres_tpu_torch.examples.bundle_adjuster --mesh 2 --device cpu``
    against the JAX program with --mesh 2 (the conftest's virtual
    devices): the same progress rows and final cost as printed, and rank 0
    alone prints."""
    import importlib

    argv = ["--num_cameras", "3", "--num_points", "40", "--num_observations", "120",
            "--num_iterations", "5", "--mesh", "2"]
    # the port's two ranks run while the JAX program runs here
    port = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "ceres_tpu_torch.examples.bundle_adjuster", *argv, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        monkeypatch.setattr(sys, "argv", ["bundle_adjuster"] + argv)
        importlib.import_module("examples.bundle_adjuster").main()
        jtext = capsys.readouterr().out
        out, err = port.communicate(timeout=180)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    rows, final, term = _progress(out)
    assert rows and (rows, final, term) == _progress(jtext)
    assert out.count("Solver Summary") == 1  # rank 0 alone prints
    assert re.search(r"Devices\s+2\n", out)
