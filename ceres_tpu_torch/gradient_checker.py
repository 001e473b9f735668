"""Gradient checking: analytic against numeric Jacobians (port of
``ceres_tpu/gradient_checker.py``; analog of
``include/ceres/gradient_checker.h:66`` and
``internal/ceres/gradient_checking_cost_function.{h,cc}:105``).

The forward-mode Jacobian of every residual family is compared with central
differences in the tangent space, and the worst relative error reported.
``SolverOptions.check_gradients`` runs the check before the loop
(solver.cc:765-780) and at every accepted iterate of the trust-region host
loop. The numeric Jacobian is taken on the host in float64, one instance at
a time.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ceres_tpu_torch.evaluator import family_residuals_and_jacobians


def _host(a) -> torch.Tensor:
    """A host float64 tensor of ``a`` (floating leaves only are cast)."""
    t = torch.as_tensor(a).detach().cpu()
    return t.to(torch.float64) if t.is_floating_point() else t


def numeric_jacobian(fn: Callable, args: Sequence, argnum: int, step: float = 1e-6) -> np.ndarray:
    """Central-difference Jacobian of fn with respect to args[argnum]."""
    args = [np.asarray(a, dtype=np.float64) for a in args]
    x = args[argnum]

    def call(xa):
        out = fn(*[torch.from_numpy(xa if k == argnum else a) for k, a in enumerate(args)])
        return out.detach().cpu().numpy()

    r0 = call(x)
    J = np.zeros((r0.shape[0], x.shape[0]))
    for i in range(x.shape[0]):
        h = step * max(1.0, abs(x[i]))
        xp, xm = x.copy(), x.copy()
        xp[i] += h
        xm[i] -= h
        J[:, i] = (call(xp) - call(xm)) / (2 * h)
    return J


class GradientChecker:
    """Check one residual function's Jacobians (gradient_checker.h:66)."""

    def __init__(
        self,
        fn: Callable,
        block_sizes: Sequence[int],
        relative_precision: float = 1e-8,
        step: float = 1e-6,
    ):
        self.fn = fn
        self.block_sizes = tuple(block_sizes)
        self.relative_precision = relative_precision
        self.step = step

    def probe(self, args: Sequence) -> Tuple[bool, float, str]:
        """Returns (ok, max_relative_error, message)."""
        max_err = 0.0
        tensors = [_host(np.asarray(a, dtype=np.float64)) for a in args]
        for j in range(len(args)):
            analytic = torch.func.jacfwd(self.fn, argnums=j)(*tensors).detach().numpy()
            numeric = numeric_jacobian(self.fn, args, j, self.step)
            scale = max(np.max(np.abs(analytic)), np.max(np.abs(numeric)), 1.0)
            max_err = max(max_err, np.max(np.abs(analytic - numeric)) / scale)
        ok = max_err <= self.relative_precision
        msg = "" if ok else (
            f"max relative jacobian error {max_err:e} > {self.relative_precision:e}"
        )
        return ok, max_err, msg


def check_problem_gradients(
    problem, relative_precision: float = 1e-8, max_blocks_per_family: int = 4, device="cuda"
) -> Tuple[bool, str]:
    """Check every residual family at the current parameter values, a few
    instances per family (the analog of wrapping every cost function in a
    GradientCheckingCostFunction, gradient_checking_cost_function.h:105),
    with the analytic Jacobians evaluated on ``device``."""
    program = problem.program(device)
    return check_program_gradients_at(
        program, program.initial_ambient(), relative_precision, max_blocks_per_family
    )


def check_program_gradients_at(
    program, x, relative_precision: float = 1e-8, max_blocks_per_family: int = 4
) -> Tuple[bool, str]:
    """The check at an iterate ``x`` of the program (host array or device
    tensor): the during-solve form, for the reference aborts the solve at
    the first mismatch at ANY iterate (gradient_checking_cost_function.h:105,
    solver.cc:765-780)."""
    x = torch.as_tensor(x).to(program.device, torch.float64)
    x_host = x.cpu().numpy()
    for fam in program.families:
        _, jacs = family_residuals_and_jacobians(fam, x)
        st = fam.structure
        n_check = min(fam.batch, max_blocks_per_family)
        coords = [
            fam.amb_groups[A][fam.amb_pos[j][:n_check]].cpu().numpy()
            for j, A in enumerate(st.block_sizes)
        ]
        analytic_all = [J[:n_check].detach().cpu().numpy() for J in jacs]
        for i in range(n_check):
            blocks = [torch.from_numpy(x_host[c[i]]) for c in coords]
            data_i = (
                (pytree.tree_map(lambda leaf: _host(leaf[i]), fam.data),)
                if st.has_data else ()
            )

            def tangent_fn(*deltas):
                moved = [
                    b + d if m is None else m.plus(b, d)
                    for b, d, m in zip(blocks, deltas, st.manifolds)
                ]
                return st.fn(*moved, *data_i)

            zero_args = [np.zeros(t) for t in st.tangent_sizes]
            for j in range(len(zero_args)):
                numeric = numeric_jacobian(tangent_fn, zero_args, j)
                analytic = analytic_all[j][i]
                scale = max(np.max(np.abs(analytic)), np.max(np.abs(numeric)), 1.0)
                err = np.max(np.abs(analytic - numeric)) / scale
                if err > relative_precision:
                    name = st.fn.__name__ if hasattr(st.fn, "__name__") else st.fn
                    return False, f"family {name} instance {i} arg {j}: relative error {err:e}"
    return True, ""
