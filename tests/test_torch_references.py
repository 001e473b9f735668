"""The JAX package's results that ``chip_smoke.py`` holds the port to, and
the parity test of the solves that make them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_references.py [large] [flagship_host_loop]

prints one JSON line per reference, computed by ``ceres_tpu`` in float64 on
the CPU: ``large`` runs ``ceres_tpu.fused_solve`` of the large instance
(464 / 200 000 / 1 200 000, seed 7, the large phase's options) with and
without ``HuberLoss(1.0)`` (ROBUST_LARGE_REFERENCE_FINAL_COST; about six
minutes); ``flagship_host_loop`` runs ``ceres_tpu.solve`` of the flagship
instance bounded and non-monotonic (FLAGSHIP_BOUNDED_REFERENCE,
FLAGSHIP_NONMONOTONIC_REFERENCE; about half a minute). The test runs the
flagship function through both packages at a small size: the same records,
costs (rtol 1e-10), active bounds and evaluation-callback calls (the large
one is ``fused_solve``, held to the JAX package by test_torch_solve.py).
"""

import json
import sys
import time

import numpy as np

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.fused_lm import fused_solve as jax_fused_solve
from ceres_tpu.models import bal as jbal
from ceres_tpu_torch.models import bal as tbal

LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000, seed=7)
FLAGSHIP = dict(num_cameras=16, num_points=22106, num_observations=83718, seed=16)
SMALL = dict(num_cameras=4, num_points=200, num_observations=800, seed=3)


def _package(mod):
    return (jbal, {}) if mod is ct else (tbal, dict(device="cpu"))


def large_references(mod, sizes=LARGE):
    """fused_solve of the instance at the large phase's options, f64, plain
    and with HuberLoss(1.0): [(loss, LM iterations, final cost, seconds)]."""
    bm, kw = _package(mod)
    fused = jax_fused_solve if mod is ct else ctt.fused_solve
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    out = []
    for loss in (None, mod.loss.HuberLoss(1.0)):
        t0 = time.time()
        opts = bm.default_options(iterative=False)
        opts.max_num_iterations = 50
        opts.evaluation_dtype = "float64"
        s = fused(opts, bm.build_problem(inst, loss=loss)[0], **kw)
        count = len(s.iterations) if mod is ct else s.num_iterations
        out.append((None if loss is None else "HuberLoss(1.0)", count, s.final_cost,
                    time.time() - t0))
    return out


class _Counter:
    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        self.calls += 1


def flagship_host_loop_references(mod, sizes=FLAGSHIP):
    """The flagship host-loop phase's two solves at
    bal.default_options(iterative=True), f64: bounded (every point's z in
    [-1, 1], the start clipped into the box) -> (records, final cost, active
    bounds); non-monotonic with an evaluation callback and a time budget of
    1e5 s -> (records, final cost, evaluation-callback calls)."""
    bm, kw = _package(mod)
    boxed = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    boxed.points[:, 2] = np.clip(boxed.points[:, 2], -1.0, 1.0)
    p, _, pts = bm.build_problem(boxed)
    for pid in pts:
        p.set_parameter_lower_bound(int(pid), 2, -1.0)
        p.set_parameter_upper_bound(int(pid), 2, 1.0)
    s = mod.solve(bm.default_options(iterative=True), p, **kw)
    z = np.array([p.parameter_block_value(int(pid))[2] for pid in pts])
    assert np.all(np.abs(z) <= 1.0)
    bounded = (len(s.iterations), s.final_cost, int(np.sum(np.abs(z) == 1.0)))

    counter = type("Counter", (_Counter, mod.EvaluationCallback), {})()
    opts = bm.default_options(iterative=True)
    opts.use_nonmonotonic_steps = True
    opts.evaluation_callback = counter
    opts.max_solver_time_in_seconds = 1e5
    inst = bm.synthesize_bal(noise=2.0, perturb=0.7, **sizes)
    s = mod.solve(opts, bm.build_problem(inst)[0], **kw)
    return bounded, (len(s.iterations), s.final_cost, counter.calls)


def test_flagship_host_loop_solves_match_jax():
    (bj, nj), (bt, nt) = (flagship_host_loop_references(m, SMALL) for m in (ct, ctt))
    assert bt[0] == bj[0] and bt[2] == bj[2] > 0
    assert nt[0] == nj[0] and nt[2] == nj[2] > 0
    np.testing.assert_allclose([bt[1], nt[1]], [bj[1], nj[1]], rtol=1e-10)


if __name__ == "__main__":
    for what in sys.argv[1:] or ["large", "flagship_host_loop"]:
        if what == "large":
            for loss, count, cost, seconds in large_references(ct):
                print(json.dumps(dict(reference="large", loss=loss, lm_iterations=count,
                                      final_cost=cost, seconds=seconds)), flush=True)
        else:
            bounded, nonmono = flagship_host_loop_references(ct)
            print(json.dumps(dict(reference="flagship_host_loop", bounded=bounded,
                                  nonmonotonic=nonmono)), flush=True)
