"""Bounds-constrained solves: ceres_tpu_torch.solve against ceres_tpu.solve.

Every case of ``tests/test_bounds_matrix.py`` that does not use DOGLEG (the
port's DOGLEG is ROADMAP item 16b), built the same way in both packages and
run through both as one case of one parametrised test. A bounded problem
runs the host-loop minimizer in both: the LM step, the projected Armijo
line search with polynomial interpolation, and the clamp onto the box.
Compared (f64): final parameters (rtol 1e-10, atol 1e-10), final cost (rtol
1e-10, atol 1e-14), the number of records, the termination type and message
head, and any error raised while the problem is built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt


def _quad(mod, target):
    """Residual pulling the block toward ``target``."""
    if mod is ct:
        t = jnp.asarray(target)
        return lambda x: x - t
    t = torch.tensor(target, dtype=torch.float64)
    return lambda x: x - t.to(x.dtype)


def _rosen(mod, order):
    """Rosenbrock's two residuals, in ``order`` ('fr': 10 (y - x^2) first)."""
    if mod is ct:
        def rosen(z):
            a, b = 10.0 * (z[1] - z[0] * z[0]), 1.0 - z[0]
            return jnp.stack([a, b] if order == "fr" else [b, a])
    else:
        def rosen(z):
            a, b = 10.0 * (z[1:2] - z[0:1] * z[0:1]), 1.0 - z[0:1]
            return torch.cat([a, b] if order == "fr" else [b, a])
    return rosen


# Each case: build(mod, problem) -> (ids to read back, SolverOptions kwargs);
# the problem is fresh and empty.


def _inactive(mod, p):
    pid = p.add_parameter_block(np.array([5.0, -3.0]))
    p.add_residual_block(_quad(mod, [1.0, 2.0]), None, [pid])
    p.set_parameter_lower_bound(pid, 0, -100.0)
    p.set_parameter_upper_bound(pid, 0, 100.0)
    p.set_parameter_lower_bound(pid, 1, -100.0)
    return [pid], {}


def _active_lower(mod, p):
    pid = p.add_parameter_block(np.array([5.0]))
    p.add_residual_block(_quad(mod, [0.0]), None, [pid])
    p.set_parameter_lower_bound(pid, 0, 2.0)
    return [pid], {}


def _active_upper(mod, p):
    pid = p.add_parameter_block(np.array([-5.0]))
    p.add_residual_block(_quad(mod, [10.0]), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 3.0)
    return [pid], {}


def _corner(mod, p):
    pid = p.add_parameter_block(np.array([0.0, 0.0]))
    p.add_residual_block(_quad(mod, [10.0, -10.0]), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 1.0)
    p.set_parameter_lower_bound(pid, 1, -2.0)
    return [pid], {}


def _mixed(mod, p):
    pid = p.add_parameter_block(np.array([0.0, 0.0, 0.0]))
    p.add_residual_block(_quad(mod, [5.0, 0.5, -5.0]), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 1.0)
    p.set_parameter_lower_bound(pid, 1, -1.0)
    p.set_parameter_upper_bound(pid, 1, 1.0)
    p.set_parameter_lower_bound(pid, 2, -1.0)
    return [pid], {}


def _infeasible_start(mod, p):
    pid = p.add_parameter_block(np.array([100.0]))
    p.add_residual_block(_quad(mod, [0.0]), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 5.0)
    p.set_parameter_lower_bound(pid, 0, 1.0)
    return [pid], {}


def _robust_loss(mod, p):
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(4.0, 0.1, 50), [100.0]])
    pid = p.add_parameter_block(np.array([0.0]))
    p.add_residual_block(
        lambda x, d: x - d, mod.loss.HuberLoss(1.0), [pid],
        data=jnp.asarray(data) if mod is ct else data,
    )
    p.set_parameter_upper_bound(pid, 0, 3.0)
    return [pid], {}


def _one_block_of_many(mod, p):
    pa = p.add_parameter_block(np.array([0.0]))
    pb = p.add_parameter_block(np.array([0.0]))
    p.add_residual_block(_quad(mod, [10.0]), None, [pa])
    p.add_residual_block(_quad(mod, [10.0]), None, [pb])
    p.set_parameter_upper_bound(pa, 0, 2.0)
    return [pa, pb], {}


def _rosenbrock_bounded(mod, p):
    pid = p.add_parameter_block(np.array([-1.2, 1.0]))
    p.add_residual_block(_rosen(mod, "fr"), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 0.5)
    return [pid], dict(max_num_iterations=300)


def _crossed(mod, p):
    pid = p.add_parameter_block(np.array([0.0]))
    p.add_residual_block(_quad(mod, [0.0]), None, [pid])
    p.set_parameter_lower_bound(pid, 0, 2.0)
    p.set_parameter_upper_bound(pid, 0, -2.0)  # upper < lower
    return [pid], {}


def _index_validation(mod, p):
    pid = p.add_parameter_block(np.array([0.0, 0.0]))
    for setter, index in ((p.set_parameter_lower_bound, 5), (p.set_parameter_upper_bound, -1)):
        with pytest.raises((ValueError, IndexError)):
            setter(pid, index, 0.0)
    return None, None


def _feasible_throughout(mod, p):
    pid = p.add_parameter_block(np.array([4.9]))
    p.add_residual_block(_quad(mod, [-100.0]), None, [pid])
    p.set_parameter_lower_bound(pid, 0, -1.0)
    seen = []

    def cb(itsum):
        seen.append(p.parameter_block_value(pid).copy())
        return mod.CallbackReturnType.SOLVER_CONTINUE

    return [pid], dict(update_state_every_iteration=True, callbacks=[cb], max_num_iterations=50,
                       _seen=seen)


def _armijo_constrained_optimum(mod, p):
    pid = p.add_parameter_block(np.array([-1.2, 1.0]))
    p.add_residual_block(_rosen(mod, "rf"), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 0.5)
    return [pid], {}


CASES = {
    "inactive_bounds_match_unconstrained": _inactive,
    "active_lower_bound_single_coordinate": _active_lower,
    "active_upper_bound_single_coordinate": _active_upper,
    "corner_solution_two_active_bounds": _corner,
    "mixed_active_inactive": _mixed,
    "infeasible_start_is_rejected": _infeasible_start,
    "bounds_with_robust_loss": _robust_loss,
    "bounds_on_one_block_of_many": _one_block_of_many,
    "nonlinear_rosenbrock_bounded_away_from_optimum": _rosenbrock_bounded,
    "bound_validation_rejects_crossed_bounds": _crossed,
    "bound_index_validation": _index_validation,
    "iterates_stay_feasible_throughout": _feasible_throughout,
    "projected_armijo_reaches_constrained_optimum": _armijo_constrained_optimum,
}


def _run(mod, build):
    p = mod.Problem()
    ids, kw = build(mod, p)
    if ids is None:
        return None
    kw = dict(kw)
    seen = kw.pop("_seen", None)
    opts = mod.SolverOptions(max_num_iterations=kw.pop("max_num_iterations", 100), **kw)
    s = mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p)
    values = np.concatenate([p.parameter_block_value(i) for i in ids])
    return s, values, seen


@pytest.mark.parametrize("case", list(CASES))
def test_bounds_case_matches_jax(case):
    j, t = _run(ct, CASES[case]), _run(ctt, CASES[case])
    if j is None:  # the case checks the problem API only, in both packages
        assert t is None
        return
    (sj, xj, seen_j), (st, xt, seen_t) = j, t
    assert st.termination_type.name == sj.termination_type.name
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    assert len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10, atol=1e-14)
    if sj.iterations:
        assert [r.step_is_successful for r in st.iterations] == [
            r.step_is_successful for r in sj.iterations
        ]
    if seen_j is not None:
        assert len(seen_t) == len(seen_j) > 0
        np.testing.assert_allclose(np.asarray(seen_t), np.asarray(seen_j), rtol=1e-10, atol=1e-10)
        assert min(float(v[0]) for v in seen_t) >= -1.0


def test_bounded_f32_solve_stays_f32_and_inside_the_box():
    """float32 evaluation: the bounds are rounded toward the inside of the
    box in float32, so the float64 solution meets the float64 bounds."""
    p = ctt.Problem()
    pid = p.add_parameter_block(np.array([0.0, 0.0, 0.0]))
    p.add_residual_block(_quad(ctt, [5.0, 0.5, -5.0]), None, [pid])
    p.set_parameter_upper_bound(pid, 0, 0.1)  # not a float32 number
    p.set_parameter_lower_bound(pid, 2, -1.0)
    s = ctt.solve(ctt.SolverOptions(evaluation_dtype="float32"), p, device="cpu")
    assert s.is_solution_usable()
    v = p.parameter_block_value(pid)
    assert v[0] <= 0.1 and v[2] >= -1.0
    np.testing.assert_allclose(v, [0.1, 0.5, -1.0], atol=1e-3)  # f32 stops early
    prog = p.program("cpu")
    lo, hi = prog.device_bounds
    assert lo.dtype == hi.dtype == torch.float32
    assert float(hi[0]) <= 0.1 < float(np.nextafter(np.float32(hi[0]), np.float32(1)))
    x = prog.clamp(torch.tensor([1.0, 2.0, -2.0], dtype=torch.float32))
    assert x.dtype == torch.float32 and float(x[2]) == -1.0
