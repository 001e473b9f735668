"""The fused loop with its stops on the device (``utils/cuda_graph.py``,
``linear/cg.py``, ``fused_lm.py``), on the CPU.

(a) The CG (``run_while`` over blocks of ``run_if`` iterations) against the
JAX package's ``lax.while_loop`` CG on seeded systems (n = 50): SPD with
and without a Jacobi preconditioner, long enough for the residual refresh,
an iteration cap, the Q (zeta) test, an indefinite matrix, a zero rhs and a
start already good enough with min_num_iterations = 0: equal iteration
counts and termination codes, x within 1e-12 relative in float64 and 1e-5
in float32. The batched CG (``conjugate_gradients_columns``) the same way
against ``jax.vmap`` of that CG over 8 columns (n = 50), each column with
its own matrix: column by column equal counts and terminations, x within
the same tolerances. (b) One fused LM iteration reads nothing from the
device but the predicates of its ``run_if``s: with ``Tensor.__bool__``,
``item``, ``tolist``, ``cpu``, ``numpy``, ``__int__``, ``__float__``,
``new_tensor``, ``torch.tensor``, ``as_tensor`` and ``from_numpy`` (a copy
from the host, on the card) patched to raise everywhere else, one iteration
of each captured option set on the 8 / 500 / 2000 robust BAL (the cluster
preconditioners on S assembled and on the implicit S's probes, CGNR with
SUBSET among them); the same for one block of the batched CG, one chunk
of the matrix-free covariance's solve and one TinySolver iteration; a
Python number stored into a tensor (a copy from the host) raises too. (c) Which option sets ``captured_loop_eligible``
captures. (d) The launch accounting outside a capture, and
``profile_solve.eager_loop``'s summary. The solves' results are held to the
JAX package by ``test_torch_solve.py``, ``test_torch_pose_graph.py``,
``test_torch_dense_schur.py``, ``test_torch_cluster_preconditioners.py``,
``test_torch_linear_solvers.py``, ``test_torch_covariance.py`` and
``test_torch_tiny_solver.py``; the captured loops themselves need the card
(``test_torch_cuda.py``, ``chip_smoke.py``'s ``captured_loop`` phase).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu.linear.cg import conjugate_gradients as jax_cg
from ceres_tpu_torch import fused_lm, tiny_solver
from ceres_tpu_torch import trust_region as ttr
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.linear.cg import conjugate_gradients, conjugate_gradients_columns
from ceres_tpu_torch.models import bal
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.trust_region import _build_solve_aux
from ceres_tpu_torch.utils import cuda_graph

N = 50
X_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _system(kind: str, dtype, seed: int):
    """A (N, N) symmetric matrix and rhs: ``spd`` has eigenvalues 1 .. 10;
    ``scaled`` is that under a random diagonal scaling (what a Jacobi
    preconditioner undoes); ``indefinite`` has eigenvalues -1 .. 10."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    eig = np.linspace(-1.0, 10.0, N) if kind == "indefinite" else np.logspace(0, 1, N)
    a = (q * eig) @ q.T
    if kind == "scaled":
        d = rng.uniform(0.5, 2.0, N)
        a = d[:, None] * a * d[None, :]
    a = 0.5 * (a + a.T)
    b = rng.standard_normal(N)
    if kind == "zero_rhs":
        b[:] = 0.0
    return a.astype(dtype), b.astype(dtype)


# r_tolerance "tight": a residual the dtype reaches in tens of iterations
TIGHT = {np.float64: 1e-8, np.float32: 1e-3}
CASES = {
    # kind, Jacobi-preconditioned, start at the solution, cg options
    "spd": ("spd", False, False, dict(max_num_iterations=60)),  # residual refreshes
    "scaled_jacobi": ("scaled", True, False, dict(max_num_iterations=60)),
    "capped": ("spd", False, False, dict(max_num_iterations=7)),
    "q_test": ("spd", True, False, dict(max_num_iterations=50, q_tolerance=0.1,
                                        r_tolerance=-1.0)),
    "indefinite": ("indefinite", False, False, dict(max_num_iterations=50)),
    "zero_rhs": ("zero_rhs", False, False, dict(max_num_iterations=50)),
    "x0_good": ("spd", False, True, dict(max_num_iterations=50, min_num_iterations=0,
                                         r_tolerance=1e-3)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cg_matches_jax(case, dtype):
    kind, jacobi, x0, kw = CASES[case]
    kw = {"r_tolerance": TIGHT[dtype], **kw}
    a, b = _system(kind, dtype, seed=len(case))
    start = np.linalg.solve(a.astype(np.float64), b).astype(dtype) if x0 else None
    inv_diag = (1.0 / np.diag(a)).astype(dtype)

    ja, jinv = jnp.asarray(a), jnp.asarray(inv_diag)
    jres = jax_cg(lambda v: ja @ v, jnp.asarray(b),
                  preconditioner=(lambda v: jinv * v) if jacobi else None,
                  x0=None if start is None else jnp.asarray(start), **kw)
    ta, tinv = torch.from_numpy(a), torch.from_numpy(inv_diag)
    tres = conjugate_gradients(lambda v: ta @ v, torch.from_numpy(b),
                               preconditioner=(lambda v: tinv * v) if jacobi else None,
                               x0=None if start is None else torch.from_numpy(start), **kw)
    assert int(tres.num_iterations) == int(jres.num_iterations)
    assert int(tres.termination) == int(jres.termination)
    jx = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), jx, rtol=0,
                               atol=X_RTOL[dtype] * max(np.abs(jx).max(), 1.0))
    if kind == "zero_rhs":
        assert not tres.x.any()


K = 8
# per case: the kind of each column's matrix (a "zero" column: an spd
# matrix with a zero rhs), Jacobi-preconditioned, cg options. Near the
# tight r tolerance the Q test with q_tolerance = 0 fires by rounding (zeta
# below 0; ROADMAP "Facts about the reference" item 13), and ``vmap`` alone
# moves the reference's count there: column 5 of "mixed" takes 26
# iterations vmapped, 27 as one column, 27 in both with the r test alone.
# So the cases of the r test run with q_tolerance = -inf, and "q_test" has
# the Q test decide by a margin.
COLUMN_CASES = {
    "spd": (["spd"] * K, False, dict(max_num_iterations=60)),
    "scaled_jacobi": (["scaled"] * K, True, dict(max_num_iterations=60)),
    "mixed": (["spd", "scaled", "zero", "spd", "indefinite", "scaled", "spd", "zero"], True,
              dict(max_num_iterations=60)),
    "capped": (["spd", "scaled"] * (K // 2), False, dict(max_num_iterations=7)),
    "q_test": (["spd", "scaled"] * (K // 2), True, dict(max_num_iterations=50,
                                                          q_tolerance=0.1, r_tolerance=-1.0)),
}


def _columns(kinds, dtype, seed):
    """(K, N, N) matrices and (K, N) rhs, column j from ``_system``."""
    systems = [_system("zero_rhs" if kind == "zero" else kind, dtype, seed + j)
               for j, kind in enumerate(kinds)]
    return np.stack([a for a, _ in systems]), np.stack([b for _, b in systems])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_cg_columns_match_jax_vmap(case, dtype):
    """Each column of the batched CG is the JAX package's CG on its own
    system, as ``jax.vmap`` runs it (a finished column held by the select
    while the others go on)."""
    kinds, jacobi, kw = COLUMN_CASES[case]
    kw = {"r_tolerance": TIGHT[dtype], "q_tolerance": -np.inf, "residual_reset_period": 10, **kw}
    a, b = _columns(kinds, dtype, seed=10 * len(case))
    inv_diag = (1.0 / np.diagonal(a, axis1=1, axis2=2)).astype(dtype)

    def one(ak, bk, dk):
        return jax_cg(lambda v: ak @ v, bk, preconditioner=(lambda v: dk * v) if jacobi else None,
                      **kw)

    jres = jax.vmap(one)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(inv_diag))
    ta, tinv = torch.from_numpy(a), torch.from_numpy(inv_diag).T
    tres = conjugate_gradients_columns(
        lambda V: torch.einsum("kij,jk->ik", ta, V), torch.from_numpy(b).T.contiguous(),
        preconditioner=(lambda V: tinv * V) if jacobi else None, **kw)
    np.testing.assert_array_equal(tres.num_iterations.numpy(), np.asarray(jres.num_iterations))
    np.testing.assert_array_equal(tres.termination.numpy(), np.asarray(jres.termination))
    jx = np.asarray(jres.x)
    for j in range(K):
        np.testing.assert_allclose(tres.x[:, j].numpy(), jx[j], rtol=0,
                                   atol=X_RTOL[dtype] * max(np.abs(jx[j]).max(), 1.0),
                                   err_msg=f"column {j}")
    if "zero" in kinds:
        assert not tres.x[:, kinds.index("zero")].any()
    if case == "mixed":  # the columns end in different ways
        assert len(set(tres.termination.tolist())) > 1


SMALL = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)
PT = ctt.PreconditionerType
LST = ctt.LinearSolverType
# option sets the captured loop takes
CAPTURED = {
    "iterative_schur_jacobi": dict(),
    "iterative_jacobi": dict(preconditioner_type=PT.JACOBI),
    "iterative_identity": dict(preconditioner_type=PT.IDENTITY),
    "iterative_power_series": dict(preconditioner_type=PT.SCHUR_POWER_SERIES_EXPANSION),
    "iterative_explicit": dict(use_explicit_schur_complement=True),
    "iterative_spse_initialization": dict(use_spse_initialization=True),
    "iterative_mixed_precision": dict(use_mixed_precision_solves=True,
                                      max_num_refinement_iterations=2),
    "dense_schur": dict(linear_solver_type=LST.DENSE_SCHUR),
    "dense_qr": dict(linear_solver_type=LST.DENSE_QR),
    "dense_normal_cholesky": dict(linear_solver_type=LST.DENSE_NORMAL_CHOLESKY),
    "cgnr_jacobi": dict(linear_solver_type=LST.CGNR, preconditioner_type=PT.JACOBI),
    "cgnr_identity": dict(linear_solver_type=LST.CGNR, preconditioner_type=PT.IDENTITY),
    "iterative_cluster_jacobi": dict(preconditioner_type=PT.CLUSTER_JACOBI),
    "iterative_cluster_tridiagonal": dict(preconditioner_type=PT.CLUSTER_TRIDIAGONAL),
    # no S assembled: the cluster blocks from the implicit S's probes
    "iterative_cluster_jacobi_implicit": dict(preconditioner_type=PT.CLUSTER_JACOBI,
                                              implicit_s=True),
    "iterative_cluster_tridiagonal_implicit": dict(preconditioner_type=PT.CLUSTER_TRIDIAGONAL,
                                                   implicit_s=True),
    "cgnr_subset": dict(linear_solver_type=LST.CGNR, preconditioner_type=PT.SUBSET,
                        residual_blocks_for_subset_preconditioner=list(range(0, 2000, 3))),
}


class _HostReads(Exception):
    pass


def _guarded(name, orig):
    def guarded(*args, **kwargs):
        if not sys._getframe(1).f_code.co_filename.endswith("cuda_graph.py"):
            raise _HostReads(f"{name} outside run_if")
        return orig(*args, **kwargs)

    return guarded


def _no_host_scalar_setitem(orig):
    """``t[index] = 1.0`` puts the Python number in a host tensor and copies
    it to the card, which a capture refuses."""
    def setitem(self, index, value):
        if isinstance(value, (bool, int, float)):
            raise _HostReads(f"a host scalar stored into a tensor: [...] = {value!r}")
        return orig(self, index, value)

    return setitem


def _reading_only_predicates(m):
    """Patch ``m`` (a monkeypatch context) so that every read of the device
    outside ``utils/cuda_graph.py``, and every copy from the host, raises."""
    for attr in ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "new_tensor"):
        m.setattr(torch.Tensor, attr, _guarded(attr, getattr(torch.Tensor, attr)))
    for fn in ("tensor", "as_tensor", "from_numpy"):  # a copy from the host on the card
        m.setattr(torch, fn, _guarded(f"torch.{fn}", getattr(torch, fn)))
    m.setattr(torch.Tensor, "__setitem__", _no_host_scalar_setitem(torch.Tensor.__setitem__))


@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_one_fused_iteration_reads_only_its_predicates(name, monkeypatch):
    problem = bal.build_problem(bal.synthesize_bal(**SMALL), loss=ctt.HuberLoss(1.0))[0]
    opts = bal.default_options(iterative=True)
    changes = dict(CAPTURED[name])
    if changes.pop("implicit_s", False):
        monkeypatch.setattr(tschur, "EXPLICIT_S_AUTO_MAX_NF", 0)
        monkeypatch.setattr(ttr, "EXPLICIT_S_AUTO_MAX_NF", 0)
    for field, value in changes.items():
        setattr(opts, field, value)
    program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
    assert fused_lm.captured_loop_eligible(resolved, _program())
    x0 = initial_state(program)
    aux = _build_solve_aux(resolved, program)
    if opts.preconditioner_type in (PT.CLUSTER_JACOBI, PT.CLUSTER_TRIDIAGONAL):
        assert aux["ss"].cluster_groups.shape[0] > 1
        assert (aux["ss"].explicit is None) == ("implicit" in name)
    loop = fused_lm._device_loop(program, aux, fused_lm._fused_config(resolved, True), True,
                                 False, x0)
    loop.x0.copy_(x0)
    loop._start()
    before = loop.state.cost.clone()
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        loop._iteration()
    # the iteration ran: one row of the trace, a step taken
    assert int(loop.state.iteration) == 1
    assert int(loop.state.linear_iterations) >= 1
    assert float(loop.trace[0, 0]) == float(before)
    assert float(loop.state.cost) < float(before)


def test_one_block_of_the_batched_cg_reads_only_its_predicates(monkeypatch):
    a, b = _columns(COLUMN_CASES["mixed"][0], np.float64, seed=3)
    ta, rhs = torch.from_numpy(a), torch.from_numpy(b).T.contiguous()
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        res = conjugate_gradients_columns(lambda V: torch.einsum("kij,jk->ik", ta, V), rhs,
                                          max_num_iterations=10, residual_reset_period=10)
    assert int(res.num_iterations.max()) == 10


def test_one_covariance_chunk_reads_only_its_predicates(monkeypatch):
    """The matrix-free covariance's solve of one chunk of 8 columns (the
    body its CUDA graph holds), on a 30-pose sphere's Jacobian."""
    from ceres_tpu_torch import covariance
    from ceres_tpu_torch.evaluator import _full_impl
    from ceres_tpu_torch.models import pose_graph

    problem = pose_graph.build_problem_3d(*pose_graph.synthesize_sphere(30, seed=1)[:3])[0]
    program = problem.program("cpu")
    ctx = _full_impl(initial_state(program), program.families, program.num_tangent,
                     program.groups)[2]
    inv_d = 1.0 / ctx.squared_column_norms()[:, None]
    solves = covariance._ColumnSolves(ctx, inv_d, list(range(0, 60, 6)), captured=False)
    solves.max_iters = 30  # a few blocks of the 280-odd iterations these columns take
    solves.chunk.copy_(solves.table[1])  # 2 columns and 6 of padding
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        solves._solve()
    assert solves.iterations.tolist() == [30, 30] + [0] * 6
    assert solves.termination.tolist() == [0, 0] + [1] * 6 and not solves.x[:, 2:].any()


def test_one_tiny_solver_iteration_reads_only_its_predicates(monkeypatch):
    def rosenbrock(x):
        return torch.cat([10.0 * (x[1:2] - x[0:1] ** 2), 1.0 - x[0:1]])

    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 2)))
    loop = tiny_solver.tiny_loop(rosenbrock, x0, 1, 1e-10, 1e-8, 1e-16)
    loop.x0.copy_(x0)
    loop.budget.fill_(1)
    with monkeypatch.context() as m:
        _reading_only_predicates(m)
        loop._solve()
    assert loop.it.tolist() == [1] * 16
    assert bool((loop.cost <= loop.cost0).all()) and bool((loop.cost < loop.cost0).any())


def _program(device_type="cuda", comm=None):
    return types.SimpleNamespace(device=torch.device(device_type), comm=comm)


# (linear solver, preconditioner, mixed precision, spse initialization) -> captured
ELIGIBLE = [
    (LST.DENSE_SCHUR, PT.JACOBI, False, False, True),
    (LST.DENSE_SCHUR, PT.CLUSTER_JACOBI, True, False, True),
    (LST.DENSE_QR, PT.JACOBI, False, False, True),
    (LST.DENSE_NORMAL_CHOLESKY, PT.JACOBI, True, False, True),
    (LST.ITERATIVE_SCHUR, PT.SCHUR_JACOBI, False, False, True),
    (LST.ITERATIVE_SCHUR, PT.JACOBI, False, False, True),
    (LST.ITERATIVE_SCHUR, PT.IDENTITY, False, False, True),
    (LST.ITERATIVE_SCHUR, PT.SCHUR_POWER_SERIES_EXPANSION, False, False, True),
    (LST.ITERATIVE_SCHUR, PT.SCHUR_JACOBI, False, True, True),
    (LST.ITERATIVE_SCHUR, PT.SCHUR_JACOBI, True, False, True),
    (LST.CGNR, PT.JACOBI, False, False, True),
    (LST.CGNR, PT.IDENTITY, True, False, True),
    (LST.ITERATIVE_SCHUR, PT.CLUSTER_JACOBI, False, False, True),
    (LST.ITERATIVE_SCHUR, PT.CLUSTER_TRIDIAGONAL, False, False, True),
    (LST.CGNR, PT.SUBSET, False, False, True),
    (LST.SPARSE_NORMAL_CHOLESKY, PT.JACOBI, False, False, False),
    (LST.SPARSE_SCHUR, PT.JACOBI, False, False, False),
]


@pytest.mark.parametrize("lst,pt,mixed,spse,captured", ELIGIBLE,
                         ids=[f"{a.name}-{b.name}-{c}-{d}" for a, b, c, d, _ in ELIGIBLE])
def test_captured_loop_eligible(lst, pt, mixed, spse, captured):
    opts = ctt.SolverOptions(linear_solver_type=lst, preconditioner_type=pt,
                             use_mixed_precision_solves=mixed, use_spse_initialization=spse)
    assert fused_lm.captured_loop_eligible(opts, _program()) is captured
    # never on the CPU, never over a mesh
    assert not fused_lm.captured_loop_eligible(opts, _program("cpu"))
    assert not fused_lm.captured_loop_eligible(opts, _program(comm=object()))


def test_cpu_solve_runs_the_eager_loop():
    problem = bal.build_problem(bal.synthesize_bal(**SMALL), loss=ctt.HuberLoss(1.0))[0]
    summary = ctt.solve(bal.default_options(iterative=True), problem, device="cpu")
    assert not summary.captured_loop and summary.graph_capture_time_in_seconds == 0.0
    assert "Graph capture" not in summary.full_report()
    assert summary.termination_type == ctt.TerminationType.CONVERGENCE


def test_launches_outside_a_capture_are_credited_at_once():
    got = []
    cuda_graph.launched(lambda n, *key: got.append((n, key)), 9)
    with cuda_graph.uncounted():
        cuda_graph.launched(lambda n, *key: got.append((n, key)), 3)
    assert got == [(1, (9,))]


def test_run_if_on_the_cpu_reads_its_predicate():
    ran = []
    for value in (True, False):
        with cuda_graph.run_if(torch.tensor(value)) as taken:
            if taken:
                ran.append(value)
    assert ran == [True]


def test_eager_loop_gives_the_solves_summary():
    """``profile_solve.eager_loop``, the captured loop's baseline on the
    card, keeps ``solve``'s records and counts."""
    from ceres_tpu_torch.tools.profile_solve import eager_loop

    problem = bal.build_problem(bal.synthesize_bal(**SMALL), loss=ctt.HuberLoss(1.0))[0]
    opts = bal.default_options(iterative=True)
    start = problem.state().copy()
    eager, seconds = eager_loop(problem, opts, "cpu")
    problem.write_back(start)
    solved = ctt.solve(opts, problem, device="cpu")
    assert seconds > 0.0 and [repr(r) for r in eager.iterations] == [
        repr(r) for r in solved.iterations]
    for field in ("initial_cost", "final_cost", "num_successful_steps",
                  "num_unsuccessful_steps", "num_linear_solver_iterations"):
        assert getattr(eager, field) == getattr(solved, field), field


def test_a_loss_swapped_between_solves_gets_a_new_loop():
    """``LossFunctionWrapper.reset`` swaps a family's loss without a new
    program. The program's loop for those options is made anew (on the
    card its graphs hold the old loss's arithmetic), and the second solve
    equals a fresh problem's under the new loss, records included."""
    inst = bal.synthesize_bal(**SMALL)
    wrapper = ctt.LossFunctionWrapper(ctt.HuberLoss(1.0))
    problem = bal.build_problem(inst, loss=wrapper)[0]
    opts = bal.default_options(iterative=True)
    start = problem.state().copy()
    ctt.solve(opts, problem, device="cpu")
    program = problem.program("cpu")
    before = fused_lm.device_loops(program)
    wrapper.reset(ctt.TrivialLoss())
    problem.write_back(start)
    swapped = ctt.solve(opts, problem, device="cpu")
    assert problem.program("cpu") is program
    after = fused_lm.device_loops(program)
    assert len(before) == len(after) == 1 and after[0] is not before[0]
    fresh = bal.build_problem(inst, loss=ctt.LossFunctionWrapper(ctt.TrivialLoss()))[0]
    expected = ctt.solve(opts, fresh, device="cpu")
    assert swapped.final_cost == expected.final_cost
    assert [repr(r) for r in swapped.iterations] == [repr(r) for r in expected.iterations]
    # the same losses again: the loop is kept
    problem.write_back(start)
    ctt.solve(opts, problem, device="cpu")
    assert fused_lm.device_loops(program) == after
