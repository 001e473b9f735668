"""The host-loop trust-region minimizer: ceres_tpu_torch.solve against
ceres_tpu.solve with the options that need the host loop, record by record.

Instances: the small robust BAL (8 / 500 / 2000, seed 42, HuberLoss(1.0)) of
the canonical drive for the three linear solvers, and a tiny robust BAL with
two constant cameras (the gauge fixed) for the option cases. f64 record
tolerances: costs rtol 1e-10 (above 1e-16 of the initial cost, the f64
resolution of the cost's scale); cost changes rtol 1e-10 or to 1e-10 of the
cost (a cost change is a difference of two costs); relative decrease, the
radius that follows from it and gradient norms rtol 1e-6 (above 1e-12 of
the initial gradient), step norms 1e-4 (without a fixed gauge the step's component along
the gauge directions, and what follows from it, is set by rounding: the
DENSE_SCHUR records part there at ~4e-8 and 2e-5); counts, flags and linear
iterations exactly. f32: the dtypes, and the final cost rtol 1e-4 of f64.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch import trust_region as ttr
from ceres_tpu_torch.fused_lm import fused_traced_eligible
from ceres_tpu_torch.models import bal as tbal

SMALL_ROBUST = dict(num_cameras=8, num_points=500, num_observations=2000, seed=42)
TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
SOLVERS = ["DENSE_SCHUR", "ITERATIVE_SCHUR", "CGNR"]
_EXACT = ("iteration", "step_is_valid", "step_is_nonmonotonic", "step_is_successful",
          "line_search_function_evaluations", "linear_solver_iterations", "eta", "step_size")


def _problem(mod, bm, sizes, constant_cameras=0):
    p, cams, _ = bm.build_problem(bm.synthesize_bal(**sizes), loss=mod.loss.HuberLoss(1.0))
    if constant_cameras:
        p.set_parameter_block_constant(cams[:constant_cameras])
    return p


def _options(mod, bm, solver="ITERATIVE_SCHUR", **kw):
    opts = bm.default_options(iterative=solver == "ITERATIVE_SCHUR")
    if solver not in ("ITERATIVE_SCHUR", "DENSE_SCHUR"):
        opts.linear_solver_type = mod.LinearSolverType[solver]
        opts.preconditioner_type = mod.PreconditionerType.JACOBI
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


def _solve(mod, sizes, solver="ITERATIVE_SCHUR", constant_cameras=0, **kw):
    bm = jbal if mod is ct else tbal
    p = _problem(mod, bm, sizes, constant_cameras)
    opts = _options(mod, bm, solver, **kw)
    s = mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)
    return s, p


def _both(sizes=TINY, solver="DENSE_SCHUR", constant_cameras=2, **kw):
    """(JAX summary, JAX problem, port summary, port problem); ``kw`` may
    hold a factory ``make(mod) -> {option: value}`` for per-package values."""
    make = kw.pop("make", None)
    out = []
    for mod in (ct, ctt):
        extra = dict(kw, **(make(mod) if make else {}))
        out.extend(_solve(mod, sizes, solver, constant_cameras, **extra))
    return out


def _same_records(st, sj):
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    floor = 1e-16 * sj.iterations[0].cost  # f64 resolution of the cost's scale
    g_floor = 1e-12 * sj.iterations[0].gradient_max_norm  # the same for gradients
    for a, b in zip(st.iterations, sj.iterations):
        for f in _EXACT:
            assert getattr(a, f) == getattr(b, f), (f, b.iteration)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10, atol=floor)
        np.testing.assert_allclose(a.cost_change, b.cost_change, rtol=1e-10,
                                   atol=max(1e-10 * b.cost, floor))
        for f, rtol in (("relative_decrease", 1e-6), ("trust_region_radius", 1e-6),
                        ("gradient_max_norm", 1e-6), ("gradient_norm", 1e-6),
                        ("step_norm", 1e-4)):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol,
                                       atol=g_floor if f.startswith("gradient") else 0.0)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10, atol=floor)
    assert st.num_successful_steps == sj.num_successful_steps
    assert st.num_unsuccessful_steps == sj.num_unsuccessful_steps
    assert st.num_linear_solver_iterations == sj.num_linear_solver_iterations


def _values(problem):
    return np.concatenate([problem.parameter_block_value(i)
                           for i in range(problem.num_parameter_blocks())])


def _noop(it):
    return None


@functools.lru_cache(maxsize=None)
def _small_robust(solver):
    """The small robust BAL through the host loop (a no-op callback) in both
    packages and through the port's traced path."""
    sj, _ = _solve(ct, SMALL_ROBUST, solver, callbacks=[_noop])
    st, _ = _solve(ctt, SMALL_ROBUST, solver, callbacks=[_noop])
    traced, _ = _solve(ctt, SMALL_ROBUST, solver)
    return sj, st, traced


@pytest.mark.parametrize("solver", SOLVERS)
def test_host_loop_matches_jax_record_by_record(solver):
    sj, st, _ = _small_robust(solver)
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    assert len(st.iterations) > 10
    _same_records(st, sj)
    assert st.linear_solver_type_used.name == solver


@pytest.mark.parametrize("solver", SOLVERS)
def test_host_loop_matches_the_traced_path(solver):
    """Both loops of the port, one case each: the same records. Not the same
    bits: the host loop fixes the Jacobi scaling at iteration 0 (as the
    reference does) where the traced loop scales each iterate's Jacobian,
    and it takes the candidate's cost from the full evaluation."""
    _, host, traced = _small_robust(solver)
    assert len(traced.iterations) == len(host.iterations)
    assert traced.num_iterations == host.num_iterations
    assert traced.message.split(":")[0] == host.message.split(":")[0]
    for a, b in zip(host.iterations, traced.iterations):
        assert (a.step_is_successful, a.step_is_valid, a.linear_solver_iterations) == (
            b.step_is_successful, b.step_is_valid, b.linear_solver_iterations)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-12)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-12)


def test_host_loop_f32():
    s32, p = _solve(ctt, TINY, "ITERATIVE_SCHUR", 2, callbacks=[_noop],
                    evaluation_dtype="float32")
    s64, _ = _solve(ctt, TINY, "ITERATIVE_SCHUR", 2, callbacks=[_noop])
    assert s32.is_solution_usable() and s32.evaluation_dtype == "float32"
    np.testing.assert_allclose(s32.final_cost, s64.final_cost, rtol=1e-4)
    prog = p.program("cpu")
    assert prog.eval_dtype == torch.float32
    ev = ttr.Evaluator(prog)
    full = ev.cost_gradient_jacobian(torch.from_numpy(p.state()).to(torch.float32))
    assert full.gradient.dtype == torch.float32 and full.cost.dtype == torch.float64


def _rosenbrock(mod):
    if mod is ct:
        return lambda z: jnp.stack([10.0 * (z[1] - z[0] * z[0]), 1.0 - z[0]])
    return lambda z: torch.cat([10.0 * (z[1:2] - z[0:1] * z[0:1]), 1.0 - z[0:1]])


def test_nonmonotonic_steps_match_jax():
    """Rosenbrock from (-1.2, 1) takes three steps that raise the cost and
    are accepted against the reference cost."""
    out = []
    for mod in (ct, ctt):
        p = mod.Problem()
        pid = p.add_parameter_block(np.array([-1.2, 1.0]))
        p.add_residual_block(_rosenbrock(mod), None, [pid])
        opts = mod.SolverOptions(use_nonmonotonic_steps=True, max_num_iterations=200)
        s = mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)
        out.append((s, p.parameter_block_value(pid)))
    (sj, xj), (st, xt) = out
    assert sum(r.step_is_nonmonotonic for r in st.iterations) > 0
    assert st.termination_type == ctt.TerminationType.CONVERGENCE
    _same_records(st, sj)
    np.testing.assert_allclose(xt, xj, rtol=1e-10)


@pytest.mark.parametrize("ret,termination,usable", [
    ("SOLVER_ABORT", "USER_FAILURE", False),
    ("SOLVER_TERMINATE_SUCCESSFULLY", "USER_SUCCESS", True),
])
def test_callback_return_ends_the_solve(ret, termination, usable):
    def make(mod):
        def cb(it):
            return getattr(mod.CallbackReturnType, ret) if it.iteration == 2 else None
        return dict(callbacks=[cb])

    sj, jp, st, tp = _both(make=make)
    assert st.termination_type.name == sj.termination_type.name == termination
    assert st.message == sj.message
    assert len(st.iterations) == len(sj.iterations) == 3
    assert st.is_solution_usable() == usable
    _same_records(st, sj)
    x0 = tbal.build_problem(tbal.synthesize_bal(**TINY))[0].state()
    np.testing.assert_allclose(_values(tp), _values(jp), rtol=1e-10, atol=1e-10)
    assert np.array_equal(_values(tp), x0) != usable  # written back if usable


def test_update_state_every_iteration():
    """A callback reads the problem's state, written back every iteration."""
    seen = {ct: [], ctt: []}

    def make(mod):
        box = {}

        def cb(it):
            seen[mod].append(_values(box["problem"]))
        return dict(callbacks=[cb], update_state_every_iteration=True, _box=box)

    # the callback needs the problem it reads: build both by hand
    for mod, bm in ((ct, jbal), (ctt, tbal)):
        p = _problem(mod, bm, TINY, 2)
        opts = _options(mod, bm, "DENSE_SCHUR")
        made = make(mod)
        made.pop("_box")["problem"] = p
        for k, v in made.items():
            setattr(opts, k, v)
        s = mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)
        assert s.termination_type == getattr(mod.TerminationType, "CONVERGENCE")
    a, b = np.asarray(seen[ctt]), np.asarray(seen[ct])
    assert a.shape == b.shape and a.shape[0] > 3
    assert not np.allclose(a[0], a[-1])
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max())


def test_time_budget_zero():
    sj, _, st, _ = _both(max_solver_time_in_seconds=0.0)
    assert st.termination_type.name == sj.termination_type.name == "NO_CONVERGENCE"
    assert st.message == sj.message == "Maximum solver time reached."
    assert len(st.iterations) == len(sj.iterations) == 1


@pytest.mark.parametrize("iterations", [0, 3000])
def test_iteration_limits_take_the_host_loop(iterations):
    for mod, bm in ((ct, jbal), (ctt, tbal)):
        opts = _options(mod, bm, max_num_iterations=iterations)
        opts.linear_solver_type = mod.LinearSolverType.ITERATIVE_SCHUR
        if mod is ctt:
            assert not fused_traced_eligible(opts, _problem(mod, bm, TINY).program("cpu"))
    sj, _, st, _ = _both(max_num_iterations=iterations)
    _same_records(st, sj)
    assert len(st.iterations) == 1 if iterations == 0 else len(st.iterations) > 3


def test_progress_output_matches_jax(capsys):
    texts = []
    for mod in (ct, ctt):
        _solve(mod, TINY, "DENSE_SCHUR", 2, minimizer_progress_to_stdout=True)
        texts.append(capsys.readouterr().out)
    # mask the two time columns
    masked = [re.sub(r" \S+ \S+$", " T T", t, flags=re.M) for t in texts]
    lines = masked[1].splitlines()
    assert lines[0].startswith("iter      cost      cost_change")
    assert len(lines) > 4
    assert masked[0] == masked[1]


class _Recorder(ctt.EvaluationCallback, ct.EvaluationCallback):
    def __init__(self):
        self.calls = []

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        self.calls.append((bool(new_evaluation_point), bool(evaluate_jacobians)))


def test_evaluation_callback_sequence_matches_jax():
    recorders = {}

    def make(mod):
        recorders[mod] = _Recorder()
        return dict(evaluation_callback=recorders[mod])

    sj, _, st, _ = _both(make=make)
    _same_records(st, sj)
    assert recorders[ctt].calls == recorders[ct].calls
    assert len(recorders[ctt].calls) > len(st.iterations)
    assert {(True, True), (True, False)} <= set(recorders[ctt].calls)


def test_dumps_match_jax(tmp_path):
    dirs = {ct: tmp_path / "jax", ctt: tmp_path / "torch"}
    for d in dirs.values():
        d.mkdir()

    def make(mod):
        return dict(trust_region_problem_dump_directory=str(dirs[mod]),
                    trust_region_minimizer_iterations_to_dump=[1, 2])

    sj, _, st, _ = _both(make=make)
    _same_records(st, sj)
    for it in (1, 2):
        name = f"lm_problem_{it:03d}.npz"
        with np.load(dirs[ct] / name) as a, np.load(dirs[ctt] / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["D", "jacobian", "rhs", "step"]
            for k in a.files:
                assert a[k].shape == b[k].shape, k
                scale = np.abs(a[k]).max()
                np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-12 * scale, err_msg=k)


def test_step_evaluator_and_strategy_follow_jax():
    from ceres_tpu.trust_region import LevenbergMarquardtStrategy as JStrategy
    from ceres_tpu.trust_region import TrustRegionStepEvaluator as JEvaluator

    rng = np.random.default_rng(3)
    opts = ctt.SolverOptions()
    pairs = [(JEvaluator(100.0, 3), ttr.TrustRegionStepEvaluator(100.0, 3)),
             (JStrategy(opts), ttr.LevenbergMarquardtStrategy(opts))]
    (je, te), (js, ts) = pairs
    cost = 100.0
    for _ in range(60):
        cost = cost * rng.uniform(0.7, 1.2)
        mcc = rng.uniform(0.1, 20.0)
        q = (je.step_quality(cost, mcc), te.step_quality(cost, mcc))
        assert q[0] == q[1]
        for e in (je, te):
            if q[0] > 0.1:
                e.step_accepted(cost, mcc)
        for s in (js, ts):
            (s.step_accepted if q[0] > 0.1 else s.step_rejected)(q[0])
        assert vars(je) == vars(te)
        assert (js.radius, js.decrease_factor) == (ts.radius, ts.decrease_factor)
    assert te.num_consecutive_nonmonotonic_steps >= 0 and te.reference_cost != 100.0
    assert ttr.TrustRegionStepEvaluator(5.0, 1).step_quality(ttr._DBL_MAX, 1.0) == -ttr._DBL_MAX


def test_fused_iteration_reads_the_device_once_per_iteration(monkeypatch):
    """The fused-iteration branch reads the device once per LM iteration and
    once at iteration 0 (counted: every copy to the host and every Python
    number taken from a tensor while the host loop runs)."""
    counts = {"cpu": 0, "scalar": 0}
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        counts["cpu"] += 1
        return real_cpu(self, *a, **k)

    def scalar(name):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            counts["scalar"] += 1
            return real(self, *a, **k)
        return wrapped

    real_minimize = ttr.TrustRegionMinimizer.minimize
    summaries = []

    def minimize(self, x0):
        assert self._use_fused_iteration
        summaries.append(self.summary)
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "cpu", cpu)
            for name in ("item", "__float__", "__int__", "__bool__", "tolist"):
                m.setattr(torch.Tensor, name, scalar(name))
            return real_minimize(self, x0)

    monkeypatch.setattr(ttr.TrustRegionMinimizer, "minimize", minimize)
    s, _ = _solve(ctt, TINY, "DENSE_SCHUR", 2, callbacks=[_noop])
    assert s.num_iterations > 3
    assert counts["cpu"] == 1 + s.num_iterations
    # the reads' own tolist() on the host copies, nothing else
    assert counts["scalar"] == counts["cpu"]


def test_fused_traced_eligible_decides_as_jax():
    from ceres_tpu.fused_lm import fused_traced_eligible as jax_eligible
    from ceres_tpu.trust_region import _config_from_options as jax_config

    programs = {mod: _problem(mod, bm, TINY) for mod, bm in ((ct, jbal), (ctt, tbal))}
    cases = [{}, {"callbacks": [_noop]}, {"use_nonmonotonic_steps": True},
             {"minimizer_progress_to_stdout": True}, {"update_state_every_iteration": True},
             {"max_solver_time_in_seconds": 10.0}, {"max_num_iterations": 0},
             {"max_num_iterations": 2048}, {"max_num_iterations": 2049},
             {"evaluation_callback": _Recorder()},
             {"trust_region_problem_dump_directory": "d",
              "trust_region_minimizer_iterations_to_dump": [1]}]
    for kw in cases:
        decided = []
        for mod, bm in ((ct, jbal), (ctt, tbal)):
            opts = _options(mod, bm, **kw)
            if mod is ct:
                prog = programs[ct].program()
                decided.append(jax_eligible(opts, prog, jax_config(opts, prog)))
            else:
                decided.append(fused_traced_eligible(opts, programs[ctt].program("cpu")))
        assert decided[0] == decided[1], kw
        assert decided[1] == (kw == {} or kw == {"max_num_iterations": 2048}), kw
    p = _problem(ctt, tbal, TINY)
    p.set_parameter_lower_bound(0, 6, 100.0)
    assert not fused_traced_eligible(_options(ctt, tbal), p.program("cpu"))
