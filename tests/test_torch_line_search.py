"""The LINE_SEARCH minimizer of the port against ceres_tpu's: every
direction type with Armijo and Wolfe (where valid) on a tiny robust BAL and
on four Moré-Garbow-Hillstrom problems (tests/test_mgh_battery.py), record
by record over the first iterations; the MGH problems solved to their
documented minima; restarts and each stop, with the JAX messages.

Records: the same count, flags, line-search evaluations and termination,
costs, cost changes, gradient norms, step norms and step sizes rtol 1e-9
(above 1e-16 of the initial cost / 1e-12 of the initial gradient). A line
search amplifies the last-bit differences of two packages' reductions from
iteration to iteration (PERF.md §7), so the record-by-record cases are
short (10 iterations).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu import line_search as jls
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch import line_search as tls
from ceres_tpu_torch.models import bal as tbal

TINY = dict(num_cameras=4, num_points=60, num_observations=240, noise=2.0, perturb=0.5, seed=9)
CASES = [
    ("STEEPEST_DESCENT", "ARMIJO", None),
    ("STEEPEST_DESCENT", "WOLFE", None),
    ("NONLINEAR_CONJUGATE_GRADIENT", "ARMIJO", "FLETCHER_REEVES"),
    ("NONLINEAR_CONJUGATE_GRADIENT", "WOLFE", "FLETCHER_REEVES"),
    ("NONLINEAR_CONJUGATE_GRADIENT", "WOLFE", "POLAK_RIBIERE"),
    ("NONLINEAR_CONJUGATE_GRADIENT", "WOLFE", "HESTENES_STIEFEL"),
    ("LBFGS", "WOLFE", None),
    ("BFGS", "WOLFE", None),
]
_EXACT = ("iteration", "step_is_valid", "step_is_successful",
          "line_search_function_evaluations")


def _ids(case):
    return "-".join(c for c in case if c)


def _options(mod, direction, search, ncg=None, **kw):
    opts = mod.SolverOptions(
        minimizer_type=mod.MinimizerType.LINE_SEARCH,
        line_search_direction_type=mod.LineSearchDirectionType[direction],
        line_search_type=mod.LineSearchType[search], **kw,
    )
    if ncg:
        opts.nonlinear_conjugate_gradient_type = mod.NonlinearConjugateGradientType[ncg]
    return opts


def _solve(mod, problem, opts):
    return mod.solve(opts, problem, device="cpu") if mod is ctt else mod.solve(opts, problem)


def _same_records(st, sj, rtol=1e-9):
    assert len(st.iterations) == len(sj.iterations)
    assert st.termination_type.name == sj.termination_type.name
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    floor = 1e-16 * sj.iterations[0].cost
    g_floor = 1e-12 * sj.iterations[0].gradient_max_norm
    for a, b in zip(st.iterations, sj.iterations):
        for f in _EXACT:
            assert getattr(a, f) == getattr(b, f), (f, b.iteration)
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol, atol=floor)
        np.testing.assert_allclose(a.cost_change, b.cost_change, rtol=rtol,
                                   atol=max(rtol * b.cost, floor))
        for f in ("gradient_max_norm", "gradient_norm", "step_norm", "step_size"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol * 1e3,
                                       atol=g_floor if f.startswith("gradient") else 0.0)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=rtol, atol=floor)


def _tiny_bal(mod):
    bm = jbal if mod is ct else tbal
    p, cams, _ = bm.build_problem(bm.synthesize_bal(**TINY), loss=mod.loss.HuberLoss(1.0))
    p.set_parameter_block_constant(cams[:2])
    return p


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_small_bal_matches_jax_record_by_record(case):
    out = [_solve(mod, _tiny_bal(mod), _options(mod, *case, max_num_iterations=10))
           for mod in (ct, ctt)]
    sj, st = out
    assert len(st.iterations) > 5
    assert st.minimizer_type == ctt.MinimizerType.LINE_SEARCH
    _same_records(st, sj)
    # the evaluator's counts are the summary's (solver.cc:650-676)
    evals = sum(r.line_search_function_evaluations for r in st.iterations)
    assert st.num_jacobian_evaluations == evals + 1 == sj.num_jacobian_evaluations


# -- Moré-Garbow-Hillstrom problems (tests/test_mgh_battery.py) ---------------


def _mgh(mod, name):
    """(residual function, x0, documented minimal cost) in one package."""
    if mod is ct:
        stack, sqrt, exp, atan2 = jnp.stack, jnp.sqrt, jnp.exp, jnp.arctan2

        def e(x, i):
            return x[i]
    else:
        def stack(parts):
            return torch.cat(parts)

        sqrt, exp, atan2 = torch.sqrt, torch.exp, torch.atan2

        def e(x, i):
            return x[i:i + 1]

    if name == "rosenbrock":
        def f(x):
            return stack([10.0 * (e(x, 1) - e(x, 0) ** 2), 1.0 - e(x, 0)])
        return f, np.array([-1.2, 1.0]), 0.0
    if name == "beale":
        def f(x):
            return stack([1.5 - e(x, 0) * (1.0 - e(x, 1)),
                          2.25 - e(x, 0) * (1.0 - e(x, 1) ** 2),
                          2.625 - e(x, 0) * (1.0 - e(x, 1) ** 3)])
        return f, np.array([1.0, 1.0]), 0.0
    if name == "helical_valley":
        def f(x):
            theta = atan2(e(x, 1), e(x, 0)) / (2.0 * math.pi)
            return stack([10.0 * (e(x, 2) - 10.0 * theta),
                          10.0 * (sqrt(e(x, 0) ** 2 + e(x, 1) ** 2) - 1.0), e(x, 2)])
        return f, np.array([-1.0, 0.0, 0.0]), 0.0

    def f(x):  # wood
        return stack([10.0 * (e(x, 1) - e(x, 0) ** 2), 1.0 - e(x, 0),
                      math.sqrt(90.0) * (e(x, 3) - e(x, 2) ** 2), 1.0 - e(x, 2),
                      math.sqrt(10.0) * (e(x, 1) + e(x, 3) - 2.0),
                      (e(x, 1) - e(x, 3)) / math.sqrt(10.0)])
    return f, np.array([-3.0, -1.0, -3.0, -1.0]), 0.0


def _mgh_problem(mod, name):
    fn, x0, expected = _mgh(mod, name)
    p = mod.Problem()
    b = p.add_parameter_block(x0.copy())
    p.add_residual_block(fn, None, [b])
    return p, expected


MGH = ["rosenbrock", "beale", "helical_valley", "wood"]


@pytest.mark.parametrize("name", MGH)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mgh_matches_jax_record_by_record(name, case):
    out = [_solve(mod, _mgh_problem(mod, name)[0], _options(mod, *case, max_num_iterations=10))
           for mod in (ct, ctt)]
    _same_records(out[1], out[0])


@pytest.mark.parametrize("name", MGH)
def test_mgh_reaches_the_documented_minimum(name):
    """tests/test_mgh_battery.py's line-search bar, with its options."""
    for mod in (ct, ctt):
        p, expected = _mgh_problem(mod, name)
        opts = mod.SolverOptions(minimizer_type=mod.MinimizerType.LINE_SEARCH,
                                 max_num_iterations=2000, function_tolerance=1e-14,
                                 gradient_tolerance=1e-14, parameter_tolerance=1e-14)
        s = _solve(mod, p, opts)
        assert s.final_cost <= expected + 1e-4, (mod.__name__, name, s.final_cost)


# -- restarts and stops --------------------------------------------------------


def test_restarts_then_failure(monkeypatch):
    """A direction that is not one of descent restarts from steepest
    descent, and more restarts than allowed end the solve FAILURE."""
    monkeypatch.setattr(jls._LBFGS, "apply", lambda self, g: -g)
    monkeypatch.setattr(tls._LBFGS, "apply", lambda self, g: -g)
    out = [_solve(mod, _tiny_bal(mod), _options(mod, "LBFGS", "WOLFE",
                                                max_num_line_search_direction_restarts=2))
           for mod in (ct, ctt)]
    sj, st = out
    assert st.termination_type == ctt.TerminationType.FAILURE
    assert st.message == sj.message and "max_num_line_search_direction_restarts" in st.message
    _same_records(st, sj)
    assert len(st.iterations) == 3


def _abort(it):
    return ct.CallbackReturnType.SOLVER_ABORT if it.iteration == 3 else None


def _succeed(it):
    return ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY if it.iteration == 2 else None


STOPS = {
    "gradient_tolerance": dict(gradient_tolerance=400.0),
    "function_tolerance": dict(function_tolerance=1e-2),
    "parameter_tolerance": dict(parameter_tolerance=1e-2),
    "max_num_iterations": dict(max_num_iterations=4),
    "max_solver_time_in_seconds": dict(max_solver_time_in_seconds=0.0),
    "line_search_failure": dict(max_num_line_search_step_size_iterations=1,
                                min_line_search_step_size=0.9),
    "callback_abort": dict(callbacks=[_abort]),
    "callback_success": dict(callbacks=[_succeed]),
}


@functools.lru_cache(maxsize=None)
def _stop_case(stop):
    out = []
    for mod in (ct, ctt):
        kw = dict(STOPS[stop])
        if "callbacks" in kw:
            cb = kw["callbacks"][0]
            kw["callbacks"] = [lambda it, cb=cb, mod=mod: (
                None if cb(it) is None else getattr(mod.CallbackReturnType, cb(it).name))]
        out.append(_solve(mod, _tiny_bal(mod), _options(mod, "STEEPEST_DESCENT", "ARMIJO", **kw)))
    return out


@pytest.mark.parametrize("stop", sorted(STOPS))
def test_each_stop_matches_jax(stop):
    sj, st = _stop_case(stop)
    _same_records(st, sj)
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    expected = {
        "gradient_tolerance": "Gradient tolerance reached",
        "function_tolerance": "Function tolerance reached",
        "parameter_tolerance": "Parameter tolerance reached.",
        "max_num_iterations": "Maximum number of iterations reached. Number of iterations",
        "max_solver_time_in_seconds": "Maximum solver time reached.",
        "line_search_failure": "Line search failed at iteration",
        "callback_abort": "User callback returned SOLVER_ABORT.",
        "callback_success": "User callback returned SOLVER_TERMINATE_SUCCESSFULLY.",
    }[stop]
    assert st.message.startswith(expected), st.message


@pytest.mark.parametrize("search", ["ARMIJO"])
@pytest.mark.parametrize("direction", ["LBFGS", "BFGS"])
def test_quasi_newton_needs_wolfe(direction, search):
    """solver.cc:471-484, with the JAX message."""
    messages = [_solve(mod, _tiny_bal(mod), _options(mod, direction, search)).message
                for mod in (ct, ctt)]
    assert messages[1] == messages[0] and "line_search_type must be WOLFE" in messages[0]


def test_line_search_option_checks_match_jax():
    """Every check of _validate_line_search, for both minimizer types."""
    changes = [
        dict(max_lbfgs_rank=0), dict(min_line_search_step_size=0.0),
        dict(max_line_search_step_contraction=1.5),
        dict(min_line_search_step_contraction=1e-4),
        dict(max_num_line_search_step_size_iterations=0),
        dict(line_search_sufficient_function_decrease=0.0),
        dict(line_search_sufficient_curvature_decrease=1e-5),
        dict(max_line_search_step_expansion=1.0),
        dict(check_gradients=True, gradient_check_relative_precision=0.0),
        dict(check_gradients=True, gradient_check_numeric_derivative_relative_step_size=-1.0),
    ]
    for minimizer in ("TRUST_REGION", "LINE_SEARCH"):
        for change in changes:
            messages = []
            for mod in (ct, ctt):
                opts = mod.SolverOptions(minimizer_type=mod.MinimizerType[minimizer], **change)
                messages.append(opts.validate(10))
            assert messages[1] == messages[0], (minimizer, change)
            if not (minimizer == "TRUST_REGION"
                    and "max_num_line_search_step_size_iterations" in change):
                assert messages[1], (minimizer, change)

