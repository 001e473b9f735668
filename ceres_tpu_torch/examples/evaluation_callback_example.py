"""EvaluationCallback — analog of examples/evaluation_callback_example.cc.

The reference's example shows a cost function whose residuals/Jacobians
are produced by shared code that must run once per evaluation point (a
renderer, a physics engine, ...); EvaluationCallback::PrepareForEvaluation
is the hook that triggers that shared computation.

Here the "expensive shared computation" is exp(m x + c) over the whole
data set, recomputed only when the solver moves to a new evaluation
point; the callback counts how many evaluations were for new points vs.
re-evaluations.
"""

import argparse

import numpy as np

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples.iteration_callback_example import exp_residual


class SharedExpTable(ctt.EvaluationCallback):
    """Caches exp(m x + c) for the current iterate (the analog of
    MyEvaluationCallback's residual/jacobian staging buffers)."""

    def __init__(self, x):
        self.x = x
        self.new_point_count = 0
        self.reuse_count = 0
        self.table = None

    def prepare_for_evaluation(self, new_evaluation_point, evaluate_jacobians):
        if new_evaluation_point or self.table is None:
            self.new_point_count += 1
        else:
            self.reuse_count += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 5.0, 67)
    y = np.exp(0.3 * x + 0.1) + 0.2 * rng.standard_normal(x.size)

    callback = SharedExpTable(x)

    p = ctt.Problem()
    mb = p.add_parameter_block(np.array([0.0]))
    cb = p.add_parameter_block(np.array([0.0]))
    p.add_residual_block(exp_residual, None, [mb, cb], data=(x, y))

    opts = ctt.SolverOptions(max_num_iterations=50)
    opts.evaluation_callback = callback
    summary = ctt.solve(opts, p, device=args.device)
    print(summary.brief_report())
    print(
        f"m -> {p.parameter_block_value(mb)[0]:.4f}, "
        f"c -> {p.parameter_block_value(cb)[0]:.4f}"
    )
    print(
        f"evaluation callback: {callback.new_point_count} new-point "
        f"preparations, {callback.reuse_count} cached re-evaluations"
    )
    assert callback.new_point_count > 0
    assert summary.termination_type == ctt.TerminationType.CONVERGENCE


if __name__ == "__main__":
    main()
