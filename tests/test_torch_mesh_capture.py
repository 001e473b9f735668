"""A sharded solve on captured device regions (``parallel/sharding.py``,
``fused_lm.regions_capturable``): what the CPU can hold of it. On the card
an NCCL mesh runs the fused loop and the host loop's regions as CUDA graphs
with the collectives inside them (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``sharded`` phase); here two gloo ranks run the same
code eagerly, and the tests hold what a capture needs of it:

(a) one fused LM iteration under the mesh (DENSE_SCHUR, ITERATIVE_SCHUR on
    the explicit and the implicit S, CGNR, DENSE_QR), one LM step and one
    fused iteration of the host loop's regions, one inner-iteration pass
    and one line-search phi read nothing of the device but their
    ``run_if`` / ``run_while`` predicates and copy nothing from the host
    (``test_torch_device_loop``'s read guards); a SPARSE_NORMAL_CHOLESKY
    LM step and DOGLEG's sparse Gauss-Newton solve read the device once,
    their prep's flat buffer, and copy in only the host's solution (with
    mixed precision, DOGLEG's also reads each refinement's residual);
(b) every rank takes the same branches and enters the same collectives in
    the same order: each rank's sequence of predicate values and of
    collectives (kind, bytes) over whole solves is the same;
(c) the solves, each run twice on one problem from the same start (the
    repeat on the cached sharded program, ``Problem.sharded_program``):
    the same bits and collectives both times, the port's one-process
    solve within FINAL_RTOL and the JAX package's mesh solve within
    JAX_RTOL (``tests/test_torch_parallel.py``'s bars; JAX's CPU mesh
    runs every option set held to it here, the sparse ones included);
(d) the eligibility of a comm of each backend, without a process group;
(e) the per-replay credit of the collectives' calls and bytes;
(f) the sparse solvers' cells: each rank's J'J and eliminator cells placed
    in the whole program's layout and summed over the ranks are the
    one-process cells (f64, 1e-12), and the assembly built from the layout
    is the one-process assembly.

The two ranks are spawned once for the file (a module-scoped fixture); the
ranks import nothing of JAX.
"""

import contextlib
import io
import sys
import types

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch import fused_lm
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.parallel.launch import spawn_ranks
from ceres_tpu_torch.parallel.sharding import NO_TIME_BUDGET, MeshComm
from ceres_tpu_torch.solver import SolverSummary, initial_state, preprocess
from ceres_tpu_torch.types import LinearSolverType as LST
from ceres_tpu_torch.utils import cuda_graph
from test_torch_parallel import (
    CASES,
    INSTANCE,
    JAX_RTOL,
    SPAWN_TIMEOUT,
    _options,
    explicit_s_limit,
    held_to_one_process,
    summary_record,
)

WORLD = 2
# One fused LM iteration under the guards, by test_torch_parallel's case
# names plus DENSE_QR, gathered on every rank.
ITERATION_CASES = {
    "dense_schur": CASES["dense_schur"],
    "iterative_schur_explicit": CASES["iterative_schur_explicit"],
    "iterative_schur_implicit": CASES["iterative_schur_implicit"],
    "cgnr_jacobi": CASES["cgnr_jacobi"],
    "dense_qr": (dict(linear_solver_type="DENSE_QR"), {}),
}
REGION_CASES = ["host_loop_lm_step", "inner_pass", "line_search_phi", "sparse_lm_step",
                "dogleg_sparse_gauss_newton", "dogleg_sparse_gauss_newton_mixed"]
# The solves of (b) and (c): the fused loop under each solver form, the host
# loop with progress output (its fused iteration) and with inner
# iterations, and the line search.
SOLVE_CASES = {
    "dense_schur": CASES["dense_schur"],
    "iterative_schur_implicit": CASES["iterative_schur_implicit"],
    "dense_qr": ITERATION_CASES["dense_qr"],
    "progress": (dict(linear_solver_type="ITERATIVE_SCHUR",
                      preconditioner_type="SCHUR_JACOBI"), {"progress": True}),
    "inner_iterations": (dict(linear_solver_type="DENSE_SCHUR"), {"inner": True}),
    "line_search": CASES["line_search"],
    "sparse_normal": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"), {}),
    "sparse_normal_dynamic": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"),
                              {"dynamic": True}),
    "sparse_schur": (dict(linear_solver_type="SPARSE_SCHUR"), {}),
    "dogleg_sparse_normal": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
                                  trust_region_strategy_type="DOGLEG"), {}),
    "dogleg_sparse_normal_mixed": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
                                        trust_region_strategy_type="DOGLEG"), {"mixed": True}),
}
# the host factor's solvers, held to the JAX package's mesh solve, and the
# solves that run no run_if / run_while (no CG)
SPARSE_CASES = ["sparse_normal", "sparse_normal_dynamic", "sparse_schur", "dogleg_sparse_normal",
                "dogleg_sparse_normal_mixed"]
NO_PREDICATES = ["inner_iterations", "line_search"] + SPARSE_CASES


def _problem():
    return tbal.build_problem(tbal.synthesize_bal(**INSTANCE))[0]


def _solve_options(name, mesh, module=ctt):
    kw, flags = SOLVE_CASES[name]
    opts = _options(module, kw, mesh)
    opts.minimizer_progress_to_stdout = bool(flags.get("progress"))
    opts.use_inner_iterations = bool(flags.get("inner"))
    opts.dynamic_sparsity = bool(flags.get("dynamic"))
    opts.use_mixed_precision_solves = bool(flags.get("mixed"))
    return opts, flags


def _read_guarded(fn) -> str:
    """``fn()`` under the read guards: "ok", or what read the device."""
    from test_torch_device_loop import _HostReads, _reading_only_predicates

    try:
        with pytest.MonkeyPatch.context() as m:
            _reading_only_predicates(m)
            fn()
    except _HostReads as e:
        return str(e)
    return "ok"


def _reads(name, mesh) -> str:
    """Case ``name`` of (a) on this rank: "ok", or what read the device."""
    problem = _problem()
    if name in ITERATION_CASES:
        kw, flags = ITERATION_CASES[name]
        opts = _options(ctt, kw, mesh)
        with explicit_s_limit(0 if flags.get("implicit") else 2048,
                              *_port_limit_modules()):
            program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
            from ceres_tpu_torch.trust_region import _build_solve_aux

            loop = fused_lm._device_loop(program, _build_solve_aux(resolved, program),
                                         fused_lm._fused_config(resolved, True), True, False,
                                         initial_state(program, mesh))
            loop.x0.copy_(initial_state(program, mesh))
            loop._start()
            return _read_guarded(loop._iteration)
    if name == "line_search_phi":
        from ceres_tpu_torch.line_search import ProgramOracle

        opts = _options(ctt, CASES["line_search"][0], mesh)
        program, _ = preprocess(opts, problem, "cpu", SolverSummary())
        graphs = ProgramOracle(program).graphs
        x0 = initial_state(program, mesh)
        _, g0 = graphs.cost_and_gradient(x0)
        graphs.line(x0, -g0)
        graphs.phi(1e-8)  # the buffers are made at a region's first run
        return _read_guarded(lambda: graphs.phi(2e-8))
    from ceres_tpu_torch.trust_region import TrustRegionMinimizer

    if name in SPARSE_REGION_CASES:
        return _sparse_reads(name, mesh)
    opts = _options(ctt, dict(linear_solver_type="ITERATIVE_SCHUR",
                              preconditioner_type="SCHUR_JACOBI"), mesh)
    opts.use_inner_iterations = name == "inner_pass"
    program, resolved = preprocess(opts, problem, "cpu", SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    graphs, x0 = minimizer.graphs, program.clamp(initial_state(program, mesh))
    graphs.full(x0)
    graphs.jacobi_scaling()
    if name == "host_loop_lm_step":
        graphs.lm_step(1e4)
        graphs.iteration(1e4)
        return _read_guarded(lambda: (graphs.lm_step(1e4), graphs.iteration(1e4)))
    inner = minimizer.inner_minimizer
    inner.minimize(x0)  # the sets' buffers are made at their first run

    def one_pass():  # CoordinateDescentMinimizer.minimize less its one read
        regions = inner.regions
        regions.start(x0)
        for si, groups in enumerate(inner._set_structs):
            regions.fill_radii(si, {T: rows.shape[0] for T, (rows, _) in groups.items()},
                               opts.initial_trust_region_radius)
            for _ in range(inner.num_steps):
                regions.set_step(si, lambda x_, radii, g=groups: inner._set_step(g, x_, radii))

    return _read_guarded(one_pass)


# region case -> (options, what the guarded run may read and copy in: the
# prep's flat buffer once, the host's solution once per host solve; with
# mixed precision, at each mu, the refinement's f64 solution in and its
# residual read)
SPARSE_REGION_CASES = {
    "sparse_lm_step": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"),
                       ["sparse_normal_prep", "sparse_y"]),
    "dogleg_sparse_gauss_newton": (dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
                                        trust_region_strategy_type="DOGLEG"),
                                   ["dogleg_sparse_prep", "dogleg_y", "dogleg_y"]),
    "dogleg_sparse_gauss_newton_mixed": (
        dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY", trust_region_strategy_type="DOGLEG"),
        ["dogleg_sparse_prep"] + ["dogleg_y64", "dogleg_sparse_refine", "dogleg_y"] * 2),
}


def _guarded_but_flat_reads(run, allowed) -> str:
    """``run()`` under the read guards, except the sparse regions' flat
    reads (``read_flat``) and host copies (``_host_input``), which are
    logged by name: "ok" when the log is ``allowed``, else what read the
    device."""
    from test_torch_device_loop import _HostReads, _reading_only_predicates

    from ceres_tpu_torch.host_loop_graphs import SparseRegions, _Regions

    log, guard = [], pytest.MonkeyPatch()

    def lifted(real):
        def call(self, name, *args):
            log.append(name)
            guard.undo()
            try:
                return real(self, name, *args)
            finally:
                _reading_only_predicates(guard)

        return call

    with pytest.MonkeyPatch.context() as m:
        m.setattr(SparseRegions, "read_flat", lifted(SparseRegions.read_flat))
        m.setattr(_Regions, "_host_input", lifted(_Regions._host_input))
        _reading_only_predicates(guard)
        try:
            run()
        except _HostReads as e:
            return str(e)
        finally:
            guard.undo()
    return "ok" if log == allowed else f"read and copied in {log}"


def _sparse_reads(name, mesh) -> str:
    """A SPARSE_NORMAL_CHOLESKY LM step, or DOGLEG's sparse Gauss-Newton
    solve at two mu (with mixed precision: one refinement each), at a new point of the host loop's regions (the first
    point's makes the buffers), under :func:`_guarded_but_flat_reads`."""
    from ceres_tpu_torch.trust_region import TrustRegionMinimizer

    kw, allowed = SPARSE_REGION_CASES[name]
    opts = _options(ctt, kw, mesh)
    opts.use_mixed_precision_solves = name.endswith("mixed")
    program, resolved = preprocess(opts, _problem(), "cpu", SolverSummary())
    minimizer = TrustRegionMinimizer(program, resolved, SolverSummary())
    graphs, x0 = minimizer.graphs, program.clamp(initial_state(program, mesh))
    if name == "sparse_lm_step":
        def run():
            minimizer.step_fn(graphs.scaled(), 1e4)
    else:
        def run():
            for mu in (1e-8, 1e-6):  # the second damps the same host cells
                minimizer.dogleg._sparse(graphs.scaled(), mu)
    try:
        for point in range(2):
            graphs.full(x0)
            graphs.jacobi_scaling()
            graphs.scaled()
            if point:
                return _guarded_but_flat_reads(run, allowed)
            run()
    finally:
        minimizer.step_fn is None or minimizer.step_fn.close()


def _cells(mesh) -> dict:
    """At the start: SPARSE_NORMAL_CHOLESKY's J'J cells and SPARSE_SCHUR's
    eliminator cells (at radius 1e4, with the reduced rhs and damping), as
    the host reads them (on a mesh the whole program's, summed over the
    ranks), and each assembly's arrays."""
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linear.inner_product import compute_normal_cells, normal_assembly
    from ceres_tpu_torch.linear.sparse_schur import _sparse_schur_prep_impl, sparse_schur_assembly
    from ceres_tpu_torch.trust_region import _build_solve_aux, _config_from_options

    out = {}
    for solver in ("SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR"):
        program, resolved = preprocess(_options(ctt, dict(linear_solver_type=solver), mesh),
                                       _problem(), "cpu", SolverSummary())
        ctx = Evaluator(program).cost_gradient_jacobian(
            initial_state(program, mesh)).jacobian_context
        if solver == "SPARSE_NORMAL_CHOLESKY":
            plan, assembly = normal_assembly(program)
            cells = compute_normal_cells(ctx, plan)
        else:
            ss = _build_solve_aux(resolved, program)["ss"]
            sparse_schur_assembly(program, ss)
            _, cells, rhs_red, df = _sparse_schur_prep_impl(
                ctx, torch.tensor(1e4, dtype=torch.float64), ss, _config_from_options(resolved))
            cells = [*cells, rhs_red, df]
            assembly = ss.sparse_assembly
        out[solver] = dict(cells=[c.numpy() for c in cells],
                           assembly=[assembly.indptr, assembly.indices, assembly.pos])
    return out


def _port_limit_modules():
    import ceres_tpu_torch.linear.schur as schur
    import ceres_tpu_torch.trust_region as tr

    return schur, tr


@contextlib.contextmanager
def _recording(log: list):
    """Append to ``log`` every predicate a ``run_if`` / ``run_while``
    reads (its value) and every collective (kind, bytes), in order."""
    real_bool, real_run = torch.Tensor.__bool__, MeshComm._run

    def recorded_bool(self):
        value = real_bool(self)
        if sys._getframe(1).f_code.co_filename.endswith("cuda_graph.py"):
            log.append(("predicate", value))
        return value

    def recorded_run(self, kind, op, t):
        log.append((kind, t.numel() * t.element_size()))
        return real_run(self, kind, op, t)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.Tensor, "__bool__", recorded_bool)
        m.setattr(MeshComm, "_run", recorded_run)
        yield


def _solves(name, mesh) -> list:
    """Case ``name`` of (b) and (c) on this rank: a solve and its repeat on
    the same problem from the same start, each with its record and its
    predicates and collectives in order."""
    opts, flags = _solve_options(name, mesh)
    problem = _problem()
    start = problem.state().copy()
    runs, programs = [], []
    for _ in range(2):
        problem.write_back(start)
        log = []
        with explicit_s_limit(0 if flags.get("implicit") else 2048, *_port_limit_modules()):
            with _recording(log), contextlib.redirect_stdout(io.StringIO()):
                s = ctt.solve(opts, problem, device="cpu")
        runs.append(dict(summary_record(s, problem), log=log, x=problem.state().copy(),
                         captured=s.captured_loop))
        programs.append(problem.sharded_program("cpu", mesh))
    runs[1]["same_program"] = programs[0] is programs[1]
    return runs


def _budget_agreed(mesh) -> list:
    """``MeshComm.over_budget`` on both ranks, rank 0 over its budget and
    rank 1 not: below NO_TIME_BUDGET every rank takes rank 0's answer."""
    program, _ = preprocess(_options(ctt, CASES["dense_schur"][0], mesh), _problem(), "cpu",
                            SolverSummary())
    over = torch.distributed.get_rank() == 0
    return [program.comm.over_budget(over, 10.0, "cpu"),
            program.comm.over_budget(over, NO_TIME_BUDGET, "cpu")]


def mesh_rank(rank, world):
    del rank
    torch.set_num_threads(1)
    from ceres_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device_type="cpu")
    return dict(
        reads={name: _reads(name, mesh) for name in list(ITERATION_CASES) + REGION_CASES},
        solves={name: _solves(name, mesh) for name in SOLVE_CASES},
        budget=_budget_agreed(mesh),
        cells=_cells(mesh),
    )


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(mesh_rank, WORLD, timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def one_process():
    out = {}
    for name in SOLVE_CASES:
        opts, flags = _solve_options(name, None)
        problem = _problem()
        with explicit_s_limit(0 if flags.get("implicit") else 2048, *_port_limit_modules()):
            with contextlib.redirect_stdout(io.StringIO()):
                out[name] = summary_record(ctt.solve(opts, problem, device="cpu"), problem)
    return out


# -- (a) reads ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ITERATION_CASES) + REGION_CASES)
def test_one_iteration_under_the_mesh_reads_only_its_predicates(ranks, name):
    assert [r["reads"][name] for r in ranks] == ["ok"] * WORLD


# -- (b) the same branches --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_every_rank_takes_the_same_branches_and_collectives(ranks, name):
    logs = [[run["log"] for run in r["solves"][name]] for r in ranks]
    first = logs[0][0]
    # the host loop under DENSE_SCHUR or a host factor and the line search
    # run no run_if
    assert any(k == "predicate" for k, _ in first) != (name in NO_PREDICATES)
    assert any(k == "all_reduce" for k, _ in first)
    for rank_logs in logs:
        assert rank_logs == [first, first]  # every rank, the repeat too


# -- (c) the solves -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_a_repeat_on_the_cached_program_gives_the_same_bits(ranks, name):
    for r in ranks:
        first, repeat = r["solves"][name]
        assert repeat["same_program"] and not first["captured"]
        for key in ("final_cost", "records", "collectives", "termination"):
            assert repeat[key] == first[key]
        assert np.array_equal(repeat["x"], first["x"])
    assert all(r["solves"][name][0]["final_cost"] == ranks[0]["solves"][name][0]["final_cost"]
               for r in ranks)


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_mesh_solves_match_the_one_process_solve(ranks, one_process, name):
    got = ranks[0]["solves"][name][0]
    assert got["num_devices"] == WORLD and got["collectives"]["all_reduce"][0] > 0
    held_to_one_process(got, one_process[name])  # FINAL_RTOL


def test_a_gathered_mesh_solve_matches_the_jax_mesh_solve(ranks):
    """DENSE_QR, gathered on every rank, against the JAX package's solve on
    its 8-device mesh (the distributed solvers are held to it by
    ``tests/test_torch_parallel.py``)."""
    import ceres_tpu as ct
    from ceres_tpu.models import bal as jbal
    from ceres_tpu.parallel import make_mesh as jax_make_mesh

    problem = jbal.build_problem(jbal.synthesize_bal(**INSTANCE))[0]
    ref = ct.solve(_options(ct, SOLVE_CASES["dense_qr"][0], jax_make_mesh(8)), problem)
    np.testing.assert_allclose(ranks[0]["solves"]["dense_qr"][0]["final_cost"],
                               ref.final_cost, rtol=JAX_RTOL)


@pytest.mark.parametrize("name", SPARSE_CASES)
def test_a_sparse_mesh_solve_matches_the_jax_mesh_solve(ranks, name):
    """The host factor's solvers against the JAX package's solve on its
    8-device mesh, which runs each of these option sets."""
    import ceres_tpu as ct
    from ceres_tpu.models import bal as jbal
    from ceres_tpu.parallel import make_mesh as jax_make_mesh

    problem = jbal.build_problem(jbal.synthesize_bal(**INSTANCE))[0]
    ref = ct.solve(_solve_options(name, jax_make_mesh(8), ct)[0], problem)
    got = ranks[0]["solves"][name][0]
    assert len(got["records"]) == len(ref.iterations)
    np.testing.assert_allclose(got["final_cost"], ref.final_cost, rtol=JAX_RTOL)


def test_the_time_budget_is_rank_0s_only_below_no_time_budget(ranks):
    assert [r["budget"] for r in ranks] == [[True, False]] * WORLD


# -- (d) eligibility ----------------------------------------------------------------


def _comm(backend):
    return MeshComm(0, [], np.zeros(0, np.int64), np.zeros(0, np.int64), 0, backend)


# (device, backend or None, solver) -> (regions_capturable,
# captured_loop_eligible, host_loop_capturable)
ELIGIBILITY = [
    ("cuda", "nccl", LST.DENSE_SCHUR, (True, True, True)),
    ("cuda", "nccl", LST.ITERATIVE_SCHUR, (True, True, True)),
    ("cuda", "nccl", LST.CGNR, (True, True, True)),
    ("cuda", "nccl", LST.DENSE_QR, (True, True, True)),
    ("cuda", "nccl", LST.SPARSE_NORMAL_CHOLESKY, (True, False, True)),
    ("cuda", "nccl", LST.SPARSE_SCHUR, (True, False, True)),
    ("cuda", "gloo", LST.DENSE_SCHUR, (False, False, False)),
    ("cuda", "gloo", LST.ITERATIVE_SCHUR, (False, False, False)),
    ("cpu", "nccl", LST.DENSE_SCHUR, (False, False, False)),
    ("cpu", "gloo", LST.DENSE_SCHUR, (False, False, False)),
    ("cuda", None, LST.SPARSE_SCHUR, (True, False, True)),
]


@pytest.mark.parametrize("device,backend,lst,expected", ELIGIBILITY,
                         ids=[f"{d}-{b}-{s.name}" for d, b, s, _ in ELIGIBILITY])
def test_eligibility_by_the_comms_backend(device, backend, lst, expected):
    comm = None if backend is None else _comm(backend)
    program = types.SimpleNamespace(device=torch.device(device), comm=comm, families=())
    opts = ctt.SolverOptions(linear_solver_type=lst)
    assert (fused_lm.regions_capturable(program.device, comm, ()),
            fused_lm.captured_loop_eligible(opts, program),
            fused_lm.host_loop_capturable(opts, program)) == expected
    assert (comm is not None and comm.on_device) == (backend == "nccl")


@pytest.mark.parametrize("device,backend,expected", [
    ("cuda", "nccl", True), ("cuda", None, True), ("cuda", "gloo", False), ("cpu", "nccl", False)])
def test_dogleg_under_sparse_normal_cholesky_is_captured_where_the_comm_allows(
        device, backend, expected):
    """Its Gauss-Newton solve is two regions around the host factor
    (``dogleg.SparseGaussNewton``), on one process or a device comm."""
    program = types.SimpleNamespace(device=torch.device(device),
                                    comm=None if backend is None else _comm(backend), families=())
    opts = ctt.SolverOptions(linear_solver_type=LST.SPARSE_NORMAL_CHOLESKY,
                             trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG)
    assert fused_lm.host_loop_capturable(opts, program) is expected
    assert not fused_lm.captured_loop_eligible(opts, program)


# -- (e) the per-replay credit ---------------------------------------------------------


def test_an_eager_collective_is_counted_at_once_and_a_warm_up_nowhere():
    comm = _comm("gloo")
    old = comm.stats
    t = torch.zeros((5,), dtype=torch.float64)
    comm._run("all_reduce", lambda _: None, t)
    with cuda_graph.uncounted():
        comm._run("broadcast", lambda _: None, t)
    assert old["all_reduce"]["calls"] == 1 and old["all_reduce"]["bytes"] == 40
    assert old["broadcast"]["calls"] == 0 and old["all_reduce"]["seconds"] >= 0.0
    fresh = comm.new_stats()
    comm._run("broadcast", lambda _: None, t[:1])
    assert comm.stats is fresh and fresh["broadcast"] == {"calls": 1, "bytes": 8,
                                                          "seconds": fresh["broadcast"]["seconds"]}
    assert old["broadcast"]["calls"] == 0  # a finished solve's summary keeps its counts


def test_captured_collectives_are_credited_once_per_run_of_their_region():
    """A graph's root region holds a broadcast, a WHILE body two
    all-reduces: ``CapturedGraph.credit`` of the device's run counters
    credits each collective once per run since the last credit."""
    comm = _comm("nccl")
    root, body = cuda_graph._Region(), cuda_graph._Region()
    root.launches = [(comm._credit, ("broadcast", 8))]
    body.launches = [(comm._credit, ("all_reduce", 96)), (comm._credit, ("all_reduce", 96))]
    graph = object.__new__(cuda_graph.CapturedGraph)
    graph._regions, graph._credited, graph.launches = [root, body], [0, 0], 0
    graph.credit([1, 7])  # one replay, seven trips of the WHILE body
    assert (comm.stats["broadcast"]["calls"], comm.stats["broadcast"]["bytes"]) == (1, 8)
    assert (comm.stats["all_reduce"]["calls"], comm.stats["all_reduce"]["bytes"]) == (14, 1344)
    graph.credit([2, 10])  # a second replay, three trips
    assert (comm.stats["broadcast"]["calls"], comm.stats["all_reduce"]["calls"]) == (2, 20)
    assert comm.stats["all_reduce"]["bytes"] == 20 * 96 and graph.launches == 22
    assert comm.stats["all_reduce"]["seconds"] == 0.0  # a replay adds no seconds


# -- (f) the sparse solvers' cells -----------------------------------------------------


@pytest.mark.parametrize("solver", ["SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR"])
def test_the_ranks_cells_summed_in_the_whole_layout_are_the_one_process_cells(ranks, solver):
    ref = _cells(None)[solver]
    for r in ranks:
        got = r["cells"][solver]
        for a, b in zip(got["assembly"], ref["assembly"]):
            assert np.array_equal(a, b)
        assert [c.shape for c in got["cells"]] == [c.shape for c in ref["cells"]]
        for a, b in zip(got["cells"], ref["cells"]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0]["cells"][solver]["cells"],
                                                     ranks[1]["cells"][solver]["cells"]))
