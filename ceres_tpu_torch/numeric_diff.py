"""Numeric differentiation of residual functions (port of
``ceres_tpu/numeric_diff.py``, after ``internal/numeric_diff.h:109-245``:
forward, central and Ridders' differences, and ``numeric_diff_options.h``).

Numeric differentiation is a function transform: ``numeric_diff(fn)``
returns a function with the same signature whose forward-mode derivative is
a finite difference. It is the forward rule of a ``torch.autograd.Function``
(``generate_vmap_rule``, as ``cost_functions.analytic_cost``), so the
evaluator's ``vmap(jacfwd)`` turns it into Jacobian blocks like any other
residual: under ``jacfwd`` each lane receives one basis direction and takes
one (FORWARD) or two (CENTRAL) extra evaluations, the reference's count per
column.

The rule is not linear in the tangent: it normalises the direction and takes
its step from the coordinates the direction moves, so it has no transpose and
reverse mode is not offered.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ceres_tpu_torch.types import NumericDiffMethodType


class NumericDiffOptions:
    """Analog of ceres::NumericDiffOptions (numeric_diff_options.h)."""

    def __init__(
        self,
        relative_step_size: float = 1e-6,
        ridders_relative_initial_step_size: float = 1e-2,
        max_num_ridders_extrapolations: int = 10,
        ridders_epsilon: float = 1e-12,
        ridders_step_shrink_factor: float = 2.0,
    ):
        self.relative_step_size = relative_step_size
        self.ridders_relative_initial_step_size = ridders_relative_initial_step_size
        self.max_num_ridders_extrapolations = max_num_ridders_extrapolations
        self.ridders_epsilon = ridders_epsilon
        self.ridders_step_shrink_factor = ridders_step_shrink_factor


def numeric_diff(
    fn: Callable,
    method: NumericDiffMethodType = NumericDiffMethodType.CENTRAL,
    options: NumericDiffOptions | None = None,
) -> Callable:
    """Wrap a residual function so that its derivatives come from finite
    differences. Every tensor argument with a tangent is differentiated; an
    argument without one (the Problem API's trailing ``data``, which may be
    a tuple of tensors) is a constant.

    Along the tangent v the derivative is f(x + h v/|v|) against f(x)
    (FORWARD), f(x ± h v/|v|) (CENTRAL) or Ridders' extrapolation over
    shrinking h (RIDDERS, numeric_diff.h:175-245), times |v|, with h the
    relative step times max(|x restricted to the coordinates v moves|, 1)
    (numeric_diff.h:130-139 for a direction)."""
    opts = options or NumericDiffOptions()
    if isinstance(method, str):
        method = NumericDiffMethodType.from_string(method)
    if method not in tuple(NumericDiffMethodType):
        raise ValueError(f"unknown numeric diff method {method}")

    class _NumericDiff(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(treedef, *leaves):
            return fn(*pytree.tree_unflatten(list(leaves), treedef))

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.treedef = inputs[0]
            ctx.num_leaves = len(inputs) - 1
            ctx.save_for_forward(*inputs[1:])

        @staticmethod
        def jvp(ctx, _treedef_tangent, *tangents):
            leaves = ctx.saved_tensors
            treedef = ctx.treedef

            def call(ls):
                return fn(*pytree.tree_unflatten(list(ls), treedef))

            y0 = call(leaves)
            live = [(i, t) for i, t in enumerate(tangents) if t is not None]
            if not live:
                return torch.zeros_like(y0)
            vnorm = torch.sqrt(sum(torch.sum(t * t) for _, t in live))
            safe = torch.clamp(vnorm, min=1e-300)
            # The step's scale: x over the coordinates the direction moves.
            xnorm = torch.sqrt(sum(
                torch.sum(torch.where(t.abs() > 0, leaves[i] * leaves[i], 0.0))
                for i, t in live
            ))
            scale = torch.clamp(xnorm, min=1.0)
            moved = dict(live)

            def at(h):
                return call([
                    p + h * (moved[i] / safe) if i in moved else p
                    for i, p in enumerate(leaves)
                ])

            if method == NumericDiffMethodType.FORWARD:
                h = opts.relative_step_size * scale
                dydv = (at(h) - y0) / h
            elif method == NumericDiffMethodType.CENTRAL:
                h = opts.relative_step_size * scale
                dydv = (at(h) - at(-h)) / (2.0 * h)
            else:
                dydv = _ridders(at, opts.ridders_relative_initial_step_size * scale, opts)
            return dydv * vnorm

    def wrapped(*args):
        leaves, treedef = pytree.tree_flatten(args)
        return _NumericDiff.apply(treedef, *leaves)

    return wrapped


def _ridders(at: Callable, h0: torch.Tensor, opts: NumericDiffOptions):
    """Ridders' method: central differences at geometrically shrinking
    steps and Neville extrapolation to h -> 0 (numeric_diff.h:175-245,
    Ridders 1982), unrolled to the configured number of extrapolations; the
    entry of least error is selected with ``where`` in the JAX package's
    order."""
    shrink = opts.ridders_step_shrink_factor
    n = opts.max_num_ridders_extrapolations
    h = h0
    current = (at(h) - at(-h)) / (2.0 * h)
    best = current
    best_err = torch.full((), float("inf"), dtype=current.dtype, device=current.device)
    prev_row = [current]
    for k in range(1, n):
        h = h / shrink
        row = [(at(h) - at(-h)) / (2.0 * h)]
        fac = shrink * shrink
        for m in range(1, k + 1):
            extrapolated = (fac * row[m - 1] - prev_row[m - 1]) / (fac - 1.0)
            fac = fac * shrink * shrink
            err = torch.maximum(
                torch.max(torch.abs(extrapolated - row[m - 1])),
                torch.max(torch.abs(extrapolated - prev_row[m - 1])),
            )
            take = err < best_err
            best = torch.where(take, extrapolated, best)
            best_err = torch.where(take, err, best_err)
            row.append(extrapolated)
        prev_row = row
    return best


def numeric_diff_jacobian(
    fn: Callable,
    x: torch.Tensor,
    method: NumericDiffMethodType = NumericDiffMethodType.CENTRAL,
    options: NumericDiffOptions | None = None,
) -> torch.Tensor:
    """Dense finite-difference Jacobian of fn at a 1-D x (the building block
    of gradient checks, gradient_checker.h:66)."""
    return torch.func.jacfwd(numeric_diff(fn, method, options))(x)


def numeric_diff_gradient(
    fn: Callable,
    method: NumericDiffMethodType = NumericDiffMethodType.CENTRAL,
    options: NumericDiffOptions | None = None,
) -> Callable:
    """Finite-difference gradient of a scalar function, the analog of
    NumericDiffFirstOrderFunction (numeric_diff_first_order_function.h):
    forward mode over the finite-difference rule, one directional difference
    per coordinate. Pass it as ``GradientProblem``'s ``gradient_fn``."""
    return torch.func.jacfwd(numeric_diff(fn, method, options))
