"""The port's C API against ceres_tpu's: the same callbacks (plain numpy,
shared by both) through ``ceres_problem_add_residual_block`` and
``ceres_solve``, with a stock loss and with a loss callback.

Tolerances: final costs and solutions rtol 1e-10; the Jacobian blocks the
evaluator holds are the callback's own, to the bit.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

jc = importlib.import_module("ceres_tpu.c_api")
tc = importlib.import_module("ceres_tpu_torch.c_api")
SMALL_CURVE = dict(points=12, seed=4)


def _curve(capi, loss=None, kw=None):
    xs, ys = chip_smoke.curve_data(**SMALL_CURVE)
    m, c = np.zeros(1), np.zeros(1)
    problem = capi.ceres_create_problem()
    if loss == "stock":
        lf, data = capi.ceres_stock_loss_function, capi.ceres_create_cauchy_loss_function_data(0.5)
    elif loss == "callback":
        lf, data = _soft_l1, 2.0
    else:
        lf, data = None, None
    for x, y in zip(xs, ys):
        capi.ceres_problem_add_residual_block(
            problem, chip_smoke.curve_cost, (float(x), float(y)), lf, data, 1, 2, [1, 1], [m, c])
    s = capi.ceres_solve(problem, **(kw or {}))
    return m, c, s


def _soft_l1(scale, s, out):
    """A ceres_loss_function_t: rho(s) = 2 (sqrt(1 + s) - 1), scaled."""
    t = np.sqrt(1.0 + s / scale)
    out[0] = 2.0 * scale * (t - 1.0)
    out[1] = 1.0 / t
    out[2] = -0.5 / (scale * t ** 3)


@pytest.mark.parametrize("loss", [None, "stock", "callback"])
def test_curve_fit_matches_jax(loss, capsys):
    jm, jcc, js = _curve(jc, loss)
    tm, tcc, ts = _curve(tc, loss, dict(device="cpu"))
    out = capsys.readouterr().out
    assert out.count("Solver Summary") == 2  # both printed the full report
    assert len(ts.iterations) == len(js.iterations) > 2
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-10)
    # ceres_solve wrote the solution back into the caller's arrays
    np.testing.assert_allclose([tm[0], tcc[0]], [jm[0], jcc[0]], rtol=1e-10)
    assert tm[0] != 0.0 and tcc[0] != 0.0


def test_jacobians_are_the_callbacks_own():
    """The evaluator's Jacobian blocks of a C API problem, in f64, equal
    what the callback wrote, bit for bit."""
    from ceres_tpu_torch.evaluator import Evaluator

    xs, ys = chip_smoke.curve_data(**SMALL_CURVE)
    m, c = np.array([0.21]), np.array([-0.13])
    problem = tc.ceres_create_problem()
    for x, y in zip(xs, ys):
        tc.ceres_problem_add_residual_block(problem, chip_smoke.curve_cost, (float(x), float(y)),
                                            None, None, 1, 2, [1, 1], [m, c])
    program = problem.problem.program("cpu")
    ctx = Evaluator(program).cost_gradient_jacobian(
        torch.from_numpy(program.initial_ambient())).jacobian_context
    J = ctx.to_dense().numpy()
    for i, (x, y) in enumerate(zip(xs, ys)):
        res, jacs = np.zeros(1), [np.zeros((1, 1)), np.zeros((1, 1))]
        chip_smoke.curve_cost((float(x), float(y)), [m, c], res, jacs)
        assert J[i, 0] == jacs[0][0, 0] and J[i, 1] == jacs[1][0, 0]
        assert ctx.residuals[i][0, 0].item() == res[0]


def test_stock_loss_functions_match_jax():
    for make, args in (("huber", (1.5,)), ("softl1", (0.7,)), ("cauchy", (2.0,)),
                       ("arctan", (1.1,)), ("tolerant", (1.0, 0.5))):
        jl = getattr(jc, f"ceres_create_{make}_loss_function_data")(*args)
        tl = getattr(tc, f"ceres_create_{make}_loss_function_data")(*args)
        for s in (0.0, 0.3, 4.0):
            a, b = np.zeros(3), np.zeros(3)
            jc.ceres_stock_loss_function(jl, s, a)
            tc.ceres_stock_loss_function(tl, s, b)
            np.testing.assert_allclose(b, a, rtol=1e-13, err_msg=make)
        tc.ceres_free_stock_loss_function_data(tl)


def _refuse_past_five(data, params, residuals, jacobians):
    """r = x - 10, whose evaluation fails once x reaches 5."""
    residuals[0] = params[0][0] - 10.0
    if jacobians is not None and jacobians[0] is not None:
        jacobians[0][0, 0] = 1.0
    return params[0][0] < 5.0


def test_a_failing_callback_is_a_rejected_step_like_jax():
    """A callback that returns false makes the residuals NaN: the step that
    reached x = 10 is rejected and the solve goes on from x as in JAX."""
    out = []
    for capi, kw in ((jc, {}), (tc, dict(device="cpu"))):
        x = np.array([0.0])
        problem = capi.ceres_create_problem()
        capi.ceres_problem_add_residual_block(problem, _refuse_past_five, None, None, None,
                                              1, 1, [1], [x])
        s = capi.ceres_solve(problem, **kw)
        out.append((s.termination_type.name, len(s.iterations), s.final_cost, x[0]))
    assert out[1][:2] == out[0][:2]
    np.testing.assert_allclose(out[1][2:], out[0][2:], rtol=1e-10)


def test_size_mismatches_raise():
    problem = tc.ceres_create_problem()
    with pytest.raises(ValueError):
        tc.ceres_problem_add_residual_block(problem, chip_smoke.curve_cost, None, None, None,
                                            1, 2, [1], [np.zeros(1)])
    with pytest.raises(ValueError):
        tc.ceres_problem_add_residual_block(problem, chip_smoke.curve_cost, None, None, None,
                                            1, 1, [2], [np.zeros(1)])
    tc.ceres_init()
    tc.ceres_free_problem(problem)
    assert problem.problem is None
