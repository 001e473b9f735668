"""Cost-function adapters and stock residuals (port of
``ceres_tpu/cost_functions.py``).

A "cost function" is any callable of torch tensors that returns one
instance's residual vector, so the reference's wrapper classes become
higher-order functions:

- ``normal_prior``    — include/ceres/normal_prior.h: r = A (x - b)
- ``conditioned``     — include/ceres/conditioned_cost_function.h: per-row
                        conditioner functions
- ``scaled``          — residuals scaled by a constant matrix or scalar
- ``fixed_arguments`` — some arguments bound to constants
- ``to_functor``      — cost_function_to_functor.h: the identity here
- ``analytic_cost``   — a hand-written Jacobian attached to a residual

and ``EvaluationCallback``, the hook the host-loop minimizer calls before
each evaluation.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch


def _const(value) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, dtype=np.float64))


def _like(const: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stored f64 constant in the dtype and on the device of ``x``."""
    return const.to(device=x.device, dtype=x.dtype)


def normal_prior(A, b) -> Callable:
    """r(x) = A (x - b) (normal_prior.h:43-58). A may be rectangular
    (rank-deficient covariance)."""
    A, b = _const(A), _const(b)
    if A.ndim != 2 or A.shape[1] != b.shape[0]:
        raise ValueError(f"A must be (r, {b.shape[0]}), got {tuple(A.shape)}")

    def fn(x):
        return _like(A, x) @ (x - _like(b, x))

    return fn


def conditioned(fn: Callable, conditioners: Sequence[Callable]) -> Callable:
    """Apply scalar conditioners per residual row
    (conditioned_cost_function.h:46-100): out[i] = c_i(r[i]). Each
    conditioner sees a 1-element tensor."""

    def wrapped(*args):
        r = fn(*args)
        return torch.cat([c(r[i : i + 1]).reshape(1) for i, c in enumerate(conditioners)])

    return wrapped


def scaled(fn: Callable, scale) -> Callable:
    """Residuals premultiplied by a scalar or matrix (the residual-space
    analog of ScaledLoss)."""
    scale = _const(scale)

    def wrapped(*args):
        r = fn(*args)
        s = _like(scale, r)
        if s.ndim == 2:
            return s @ r
        return s.reshape(-1) * r if s.ndim else float(scale) * r

    return wrapped


def fixed_arguments(fn: Callable, fixed: Dict[int, np.ndarray]) -> Callable:
    """Bind argument positions to constants; remaining args shift left."""
    fixed = {int(k): _const(v) for k, v in fixed.items()}

    def wrapped(*args):
        full = []
        it = iter(args)
        for i in range(len(args) + len(fixed)):
            full.append(_like(fixed[i], args[0]) if i in fixed else next(it))
        return fn(*full)

    return wrapped


def to_functor(fn: Callable) -> Callable:
    """cost_function_to_functor.h analog: the identity, for API parity."""
    return fn


def analytic_cost(residual_fn: Callable, jacobian_fn: Callable) -> Callable:
    """User-supplied analytic Jacobians (SizedCostFunction::Evaluate,
    include/ceres/sized_cost_function.h).

    The hand-written Jacobian is attached as the forward-mode rule of a
    ``torch.autograd.Function``, so the evaluator's ``vmap(jacfwd)`` pass
    consumes it like any other residual: same batching, same manifold chain
    rule.

    ``jacobian_fn(*args)`` returns one Jacobian per argument, each of shape
    ``(num_residuals, arg.size)``, or ``None`` for an argument with zero
    derivative (a NULL ``jacobians[i]`` in the reference's contract).
    """

    class _Analytic(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*args):
            return residual_fn(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(*inputs)

        @staticmethod
        def jvp(ctx, *tangents):
            primals = ctx.saved_tensors
            jacs = jacobian_fn(*primals)
            if not isinstance(jacs, (tuple, list)):
                jacs = (jacs,)
            if len(jacs) != len(primals):
                raise ValueError(
                    f"jacobian_fn returned {len(jacs)} Jacobians for "
                    f"{len(primals)} arguments"
                )
            out_t = None
            for J, t in zip(jacs, tangents):
                if J is None or t is None:
                    continue
                term = J @ t.reshape(-1)
                out_t = term if out_t is None else out_t + term
            if out_t is None:
                out_t = torch.zeros_like(residual_fn(*primals))
            return out_t

    def fn(*args):
        return _Analytic.apply(*args)

    return fn


class EvaluationCallback:
    """Analog of ceres::EvaluationCallback (evaluation_callback.h:63):
    ``prepare_for_evaluation(new_evaluation_point, evaluate_jacobians)``
    fires before every residual/Jacobian evaluation the solver performs.
    Attach via ``SolverOptions.evaluation_callback``."""

    def prepare_for_evaluation(
        self, new_evaluation_point: bool, evaluate_jacobians: bool
    ) -> None:
        raise NotImplementedError
