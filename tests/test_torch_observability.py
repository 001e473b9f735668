"""Host-only utilities of the port against the JAX package's:
``utils/observability.py`` (EventLogger, the ExecutionSummary report, the
trust-region problem dump, a CheckpointManager round trip through the port's
Problem) and ``ops/polynomial.py`` (every function, on seeded inputs: equal
to 1e-12)."""

import re

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu.ops import polynomial as jpoly
from ceres_tpu.utils import observability as jobs
from ceres_tpu_torch.ops import polynomial as tpoly
from ceres_tpu_torch.utils import observability as tobs


def test_event_logger(capsys):
    for mod in (jobs, tobs):
        log = mod.EventLogger("Solver::Solve", verbose=True)
        log.add_event("Preprocess")
        log.add_event("Minimize")
        log.finish()
        assert [e[0] for e in log.events] == ["Preprocess", "Minimize", "total"]
        assert all(e[1] >= 0 and e[2] >= e[1] for e in log.events)
    out = capsys.readouterr().out.splitlines()
    masked = [re.sub(r"[0-9.]+ +[0-9.]+$", "T T", line) for line in out]
    assert masked[:3] == masked[3:] and masked[0].startswith("Solver::Solve")


def test_execution_summary_report_text():
    reports = []
    for mod in (jobs, tobs):
        es = mod.ExecutionSummary()
        for name, dt in (("Evaluator::Residual", 0.25), ("Evaluator::Jacobian", 1.5),
                         ("Evaluator::Residual", 0.125)):
            es.update_time(name, dt)
        with mod.ScopedExecutionTimer("Evaluator::Gradient", es):
            pass
        es.times["Evaluator::Gradient"] = 0.0  # the timed block's seconds vary
        reports.append(es.report())
        assert es.calls == {"Evaluator::Residual": 2, "Evaluator::Jacobian": 1,
                            "Evaluator::Gradient": 1}
    assert reports[0] == reports[1]
    assert "Evaluator::Residual" in reports[1] and "0.3750" in reports[1]


def test_dump_trust_region_problem(tmp_path):
    """The port's dump of a small BAL subproblem holds its dense Jacobian,
    residuals, D and step."""
    from ceres_tpu_torch.evaluator import _full_impl
    from ceres_tpu_torch.models import bal

    prog = bal.build_problem(bal.synthesize_bal(num_cameras=3, num_points=20,
                                                num_observations=60, seed=1))[0].program("cpu")
    x = torch.from_numpy(prog.initial_ambient())
    _, _, ctx = _full_impl(x, prog.families, prog.num_tangent, prog.groups)
    D = torch.linspace(0.5, 1.5, prog.num_tangent, dtype=torch.float64)
    step = torch.ones(prog.num_tangent, dtype=torch.float64)
    path = tobs.dump_trust_region_problem(str(tmp_path / "lm"), 7, ctx, D, step)
    assert path.endswith("lm_007.npz")
    with np.load(path) as d:
        assert d["jacobian"].shape == (120, prog.num_tangent)
        np.testing.assert_array_equal(d["jacobian"], ctx.to_dense().numpy())
        np.testing.assert_array_equal(d["rhs"], ctx.residual_vector().numpy())
        np.testing.assert_array_equal(d["D"], D.numpy())
        np.testing.assert_array_equal(d["step"], step.numpy())


def test_checkpoint_manager_round_trip(tmp_path):
    problem = ctt.Problem()
    a = problem.add_parameter_block(np.array([1.0, 2.0]))
    b = problem.add_parameter_block(np.array([3.0]))
    cm = tobs.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert cm.latest() is None and cm.restore(problem) is None
    cm.attach(problem)
    for i in range(4):
        problem.set_parameter_block_value(a, np.array([1.0 + i, 2.0 - i]))
        cm.callback(ctt.IterationSummary(iteration=i, cost=10.0 - i, trust_region_radius=1e4 * 3 ** i))
    assert len(list((tmp_path / "ckpt").glob("ckpt_*.npz"))) == 2
    problem.set_parameter_block_value(a, np.array([0.0, 0.0]))
    problem.set_parameter_block_value(b, np.array([-1.0]))
    meta = cm.restore(problem)
    assert meta == {"iteration": 3, "cost": 7.0, "trust_region_radius": 270000.0}
    np.testing.assert_array_equal(problem.parameter_block_value(a), [4.0, -1.0])
    np.testing.assert_array_equal(problem.parameter_block_value(b), [3.0])


def test_checkpoint_callback_in_a_solve(tmp_path):
    """As an iteration callback with update_state_every_iteration: the last
    checkpoint holds the solved state."""
    from ceres_tpu_torch.models import bal

    problem = bal.build_problem(bal.synthesize_bal(num_cameras=3, num_points=30,
                                                   num_observations=90, seed=2))[0]
    cm = tobs.CheckpointManager(str(tmp_path), keep=1)
    cm.attach(problem)
    opts = bal.default_options(iterative=False)
    opts.update_state_every_iteration = True
    opts.callbacks = [cm.callback]
    s = ctt.solve(opts, problem, device="cpu")
    ck = cm.latest()
    assert ck["meta"]["iteration"] == s.iterations[-1].iteration
    solved = problem.state()
    restored = np.concatenate([ck["blocks"][i] for i in sorted(ck["blocks"])])
    np.testing.assert_array_equal(restored, solved)


# -- ops/polynomial.py -------------------------------------------------------


def _rng():
    return np.random.default_rng(12)


@pytest.mark.parametrize("real_parts", [False, True])
def test_polynomial_roots(real_parts):
    rng = _rng()
    for deg in range(0, 6):
        c = rng.standard_normal(deg + 1)
        c[0] = 0.0 if deg == 3 else c[0]  # a leading zero is stripped
        np.testing.assert_allclose(tpoly.polynomial_roots(c, real_parts),
                                   jpoly.polynomial_roots(c, real_parts), rtol=1e-12, atol=1e-12)


def test_minimize_polynomials():
    rng = _rng()
    for _ in range(20):
        c = rng.standard_normal(rng.integers(1, 6))
        lo, hi = sorted(rng.uniform(-3, 3, 2))
        np.testing.assert_allclose(tpoly.minimize_polynomial(c, lo, hi),
                                   jpoly.minimize_polynomial(c, lo, hi), rtol=1e-12, atol=1e-12)
        samples = [(float(x), float(rng.standard_normal()),
                    None if i % 2 else float(rng.standard_normal()))
                   for i, x in enumerate(rng.uniform(-2, 2, 3))]
        np.testing.assert_allclose(
            tpoly.minimize_interpolating_polynomial(samples, lo, hi),
            jpoly.minimize_interpolating_polynomial(samples, lo, hi), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tpoly.minimize_interpolating_polynomial([(0.0, None, None)], 0.0, 1.0)


def test_line_search_minimizers():
    rng = _rng()
    for _ in range(50):
        phi0, dphi0 = rng.uniform(1, 10), -rng.uniform(0.1, 5)
        a0, a1 = sorted(rng.uniform(0.05, 2.0, 2))
        f0, f1 = rng.uniform(0, 12, 2)
        g0, g1 = rng.standard_normal(2)
        for name, args in (
            ("quadratic_minimizer", (phi0, dphi0, a1, f1)),
            ("cubic_minimizer_from_samples", (phi0, dphi0, a0, f0, a1, f1)),
            ("cubic_minimizer_two_points", (a0, f0, g0, a1, f1, g1)),
        ):
            np.testing.assert_allclose(getattr(tpoly, name)(*args), getattr(jpoly, name)(*args),
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    assert tpoly.cubic_minimizer_two_points(1.0, 0.0, 0.0, 1.0, 0.0, 0.0) == 1.0
    assert tpoly.quadratic_minimizer(1.0, -1.0, 1.0, 0.0) == 0.5  # non-convex: a1 / 2
