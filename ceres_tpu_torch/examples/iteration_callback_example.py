"""Iteration callbacks — analog of examples/iteration_callback_example.cc.

Fits y = e^(m x + c) to noisy data while an IterationCallback watches the
per-iteration summaries and terminates the solve early once the cost
change stalls below a user threshold (the reference's
MyIterationCallback returning SOLVER_TERMINATE_SUCCESSFULLY).
"""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


def make_data(rng, n=67, m=0.3, c=0.1, sigma=0.2):
    x = np.linspace(0.0, 5.0, n)
    y = np.exp(m * x + c) + sigma * rng.standard_normal(n)
    return x, y


def exp_residual(m, c, d):
    """y - exp(m x + c) over the whole data set."""
    xx, yy = d
    return yy - torch.exp(m * xx + c)


class StallDetector:
    """Terminate once |cost_change| < threshold for two iterations."""

    def __init__(self, threshold):
        self.threshold = threshold
        self.stalled = 0
        self.history = []

    def __call__(self, summary):
        self.history.append((summary.iteration, summary.cost, summary.cost_change))
        print(
            f"  [callback] iter {summary.iteration:2d} "
            f"cost {summary.cost:.6e} change {summary.cost_change:.3e}"
        )
        if summary.iteration > 0 and abs(summary.cost_change) < self.threshold:
            self.stalled += 1
        else:
            self.stalled = 0
        if self.stalled >= 2:
            print("  [callback] cost stalled -> terminate successfully")
            return ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ctt.CallbackReturnType.SOLVER_CONTINUE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stall_threshold", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(5)
    x, y = make_data(rng)

    p = ctt.Problem()
    mb = p.add_parameter_block(np.array([0.0]))
    cb = p.add_parameter_block(np.array([0.0]))
    p.add_residual_block(exp_residual, None, [mb, cb], data=(x, y))

    detector = StallDetector(args.stall_threshold)
    # Disable the built-in convergence tests so termination is visibly
    # the callback's decision (the point of the example).
    opts = ctt.SolverOptions(
        max_num_iterations=100,
        function_tolerance=1e-300,
        gradient_tolerance=1e-300,
        parameter_tolerance=1e-300,
    )
    opts.callbacks = [detector]
    # Callbacks that read parameter values need the live state:
    opts.update_state_every_iteration = True
    summary = ctt.solve(opts, p, device=args.device)
    print(summary.brief_report())
    print(
        f"m: 0.0 -> {p.parameter_block_value(mb)[0]:.4f}, "
        f"c: 0.0 -> {p.parameter_block_value(cb)[0]:.4f} "
        f"({len(detector.history)} callback invocations)"
    )
    assert summary.termination_type == ctt.TerminationType.USER_SUCCESS


if __name__ == "__main__":
    main()
