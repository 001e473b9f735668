"""Robust loss functions rho(s) and the Triggs corrector (port of
``ceres_tpu/loss.py``).

Each loss evaluates ``rho(s) -> (rho, rho', rho'')`` elementwise on a tensor
of squared residual norms, so a whole residual family is robustified in one
vectorized pass. Formulas follow ``internal/ceres/loss_function.cc:46-176``
and the corrector ``internal/ceres/corrector.cc`` (clamped Triggs
correction, BAMS eq. 10-12), with the rho'' <= 0 and s == 0 special cases.

A loss parameter is a Python float, or a ``(B,)`` tensor when the residual
blocks of one family carry different values (``stack_losses``). A float
takes the dtype of the squared norms it meets, so a float32 evaluation
stays in float32.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

_DBL_MIN = float(np.finfo(np.float64).tiny)
_TOLERANT_BIG = math.log(float(np.finfo(np.float64).max)) - 1.0


def _param(a):
    """A loss parameter as given: a float, or a per-instance f64 tensor."""
    if isinstance(a, torch.Tensor):
        return a if a.ndim else float(a)
    a = np.asarray(a, dtype=np.float64)
    return float(a) if a.ndim == 0 else torch.from_numpy(a.copy())


class LossFunction:
    """Base class. ``evaluate(s)`` returns ``(rho0, rho1, rho2)`` elementwise
    (LossFunction::Evaluate, loss_function.h:86-127). The cost of a residual
    block is ``0.5 * rho(||r||^2)``."""

    def evaluate(self, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in vars(self).items())
        return f"{type(self).__name__}({args})"


class TrivialLoss(LossFunction):
    """rho(s) = s (loss_function.cc:46-49)."""

    def evaluate(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


class _ScalarParamLoss(LossFunction):
    """Base for losses with a single scale parameter ``a``."""

    def __init__(self, a):
        self.a = _param(a)


class HuberLoss(_ScalarParamLoss):
    """rho(s) = s for s <= a^2 else 2a sqrt(s) - a^2 (loss_function.cc:52-65)."""

    def evaluate(self, s):
        a, b = self.a, self.a * self.a
        out = s > b
        safe = torch.where(out, s, 1.0)
        r = torch.sqrt(safe)
        rho0 = torch.where(out, 2.0 * a * r - b, s)
        rho1_out = torch.clamp(a / r, min=_DBL_MIN)
        rho1 = torch.where(out, rho1_out, 1.0)
        rho2 = torch.where(out, -rho1_out / (2.0 * safe), 0.0)
        return rho0, rho1, rho2


class SoftLOneLoss(_ScalarParamLoss):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1), b = a^2 (loss_function.cc:68-75)."""

    def evaluate(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        tmp = torch.sqrt(total)
        rho0 = 2.0 * b * (tmp - 1.0)
        rho1 = torch.clamp(1.0 / tmp, min=_DBL_MIN)
        rho2 = -(c * rho1) / (2.0 * total)
        return rho0, rho1, rho2


class CauchyLoss(_ScalarParamLoss):
    """rho(s) = b log(1 + s/b), b = a^2 (loss_function.cc:77-84)."""

    def evaluate(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = b * torch.log(total)
        rho1 = torch.clamp(inv, min=_DBL_MIN)
        rho2 = -c * (inv * inv)
        return rho0, rho1, rho2


class ArctanLoss(_ScalarParamLoss):
    """rho(s) = a atan2(s, a) (loss_function.cc:86-93)."""

    def evaluate(self, s):
        a = self.a
        b = 1.0 / (a * a)
        total = 1.0 + s * s * b
        inv = 1.0 / total
        rho0 = a * torch.atan2(s, torch.zeros_like(s) + a)
        rho1 = torch.clamp(inv, min=_DBL_MIN)
        rho2 = -2.0 * s * b * (inv * inv)
        return rho0, rho1, rho2


class TolerantLoss(LossFunction):
    """rho(s) = b log(1 + exp((s - a) / b)) - b log(1 + exp(-a / b))
    (loss_function.cc:95-120), with the reference's x > log(DBL_MAX) - 1
    overflow branch."""

    def __init__(self, a, b):
        self.a = _param(a)
        self.b = _param(b)

    def evaluate(self, s):
        a, b = self.a, self.b
        ratio = -a / b
        if isinstance(ratio, torch.Tensor):
            c = b * torch.log1p(torch.exp(ratio))
        else:
            c = b * math.log1p(math.exp(ratio))
        x = (s - a) / b
        big = x > _TOLERANT_BIG
        x_safe = torch.where(big, 0.0, x)
        e_x = torch.exp(x_safe)
        rho0 = torch.where(big, s - a - c, b * torch.log1p(e_x) - c)
        rho1 = torch.where(big, 1.0, torch.clamp(e_x / (1.0 + e_x), min=_DBL_MIN))
        rho2 = torch.where(big, 0.0, 0.5 / (b * (1.0 + torch.cosh(x_safe))))
        return rho0, rho1, rho2


class TukeyLoss(_ScalarParamLoss):
    """Tukey biweight (loss_function.cc:122-136)."""

    def evaluate(self, s):
        a2 = self.a * self.a
        inlier = s <= a2
        value = 1.0 - s / a2
        value_sq = value * value
        rho0 = torch.where(inlier, a2 / 3.0 * (1.0 - value_sq * value), a2 / 3.0)
        rho1 = torch.where(inlier, value_sq, 0.0)
        rho2 = torch.where(inlier, -2.0 / a2 * value, 0.0)
        return rho0, rho1, rho2


class ScaledLoss(LossFunction):
    """a * rho(s) for a wrapped loss, or a * s if none
    (loss_function.cc:167-177)."""

    def __init__(self, inner, a):
        self.inner = inner
        self.a = _param(a)

    def evaluate(self, s):
        if self.inner is None:
            return self.a * s, self.a * torch.ones_like(s), torch.zeros_like(s)
        r0, r1, r2 = self.inner.evaluate(s)
        return self.a * r0, self.a * r1, self.a * r2


class ComposedLoss(LossFunction):
    """rho(s) = f(g(s)) (loss_function.cc:156-165)."""

    def __init__(self, f, g):
        self.f = f
        self.g = g

    def evaluate(self, s):
        g0, g1, g2 = self.g.evaluate(s)
        f0, f1, f2 = self.f.evaluate(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


class LossFunctionWrapper(LossFunction):
    """Mutable holder so the loss can be swapped between solves
    (loss_function.h:391)."""

    def __init__(self, inner):
        self.inner = inner

    def reset(self, inner):
        self.inner = inner

    def evaluate(self, s):
        if self.inner is None:
            return TrivialLoss().evaluate(s)
        return self.inner.evaluate(s)


# -- losses as trees of parameters ------------------------------------------


def loss_structure(loss):
    """Hashable shape of a loss: class names and parameter slots, without
    the values. Residual blocks whose losses share it can share a family."""
    if loss is None:
        return None
    return (
        type(loss).__name__,
        tuple(
            (k, loss_structure(v) if isinstance(v, LossFunction) or v is None else "*")
            for k, v in vars(loss).items()
        ),
    )


def loss_leaves(loss) -> list:
    """The parameter values of a loss, in ``loss_structure`` order."""
    out = []
    if loss is not None:
        for v in vars(loss).values():
            if isinstance(v, LossFunction):
                out.extend(loss_leaves(v))
            elif v is not None:
                out.append(v)
    return out


def map_loss(fn: Callable, loss, *rest):
    """A copy of ``loss`` with every parameter replaced by
    ``fn(param, *matching params of rest)``."""
    if loss is None:
        return None
    new = copy.copy(loss)
    for k, v in vars(loss).items():
        others = [getattr(o, k) for o in rest]
        if isinstance(v, LossFunction):
            setattr(new, k, map_loss(fn, v, *others))
        elif v is not None:
            setattr(new, k, fn(v, *others))
    return new


def stack_losses(losses: Sequence):
    """One loss for a family of residual blocks added one by one: the first
    when every block carries the same parameter values, else a copy whose
    parameters are ``(B,)`` tensors."""
    first = losses[0]
    if first is None or len(losses) == 1:
        return first
    leaves0 = loss_leaves(first)
    if all(loss_leaves(l) == leaves0 for l in losses[1:]):
        return first
    return map_loss(
        lambda *vals: torch.tensor([float(v) for v in vals], dtype=torch.float64),
        first,
        *losses[1:],
    )


def loss_to(loss, device, dtype):
    """``loss`` with its tensor parameters on ``device`` in ``dtype`` (the
    same object when it has none)."""
    if not any(isinstance(v, torch.Tensor) for v in loss_leaves(loss)):
        return loss
    return map_loss(
        lambda v: v.to(device, dtype) if isinstance(v, torch.Tensor) else v, loss
    )


def loss_take(loss, rows: torch.Tensor):
    """``loss`` restricted to the given instances of its family."""
    if not any(isinstance(v, torch.Tensor) for v in loss_leaves(loss)):
        return loss
    return map_loss(lambda v: v[rows] if isinstance(v, torch.Tensor) else v, loss)


# -- corrector (internal/ceres/corrector.cc) ---------------------------------


def corrector_coefficients(sq_norm, rho1, rho2):
    """Per-block correction factors, batched. Returns
    ``(residual_scaling, alpha_sq_norm)`` such that

        r_corrected = residual_scaling * r
        J_corrected = sqrt(rho') * (J - alpha_sq_norm * r r^T J)

    (corrector.cc:40-131): the clamped Triggs second-order correction,
    degrading to pure sqrt(rho') scaling when s == 0 or rho'' <= 0."""
    sqrt_rho1 = torch.sqrt(rho1)
    trivial = (sq_norm == 0.0) | (rho2 <= 0.0)
    safe_sq_norm = torch.where(trivial, 1.0, sq_norm)
    # Smaller root of 0.5 alpha^2 - alpha - (rho''/rho') s = 0.
    D = 1.0 + 2.0 * safe_sq_norm * rho2 / rho1
    D = torch.where(trivial, 1.0, D)
    alpha = 1.0 - torch.sqrt(D)
    residual_scaling = torch.where(trivial, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = torch.where(trivial, 0.0, alpha / safe_sq_norm)
    return residual_scaling, alpha_sq_norm


def correct_residuals(residuals, residual_scaling):
    """r *= residual_scaling (corrector.cc CorrectResiduals, BAMS eq. 11).
    residuals: (..., num_rows); residual_scaling: (...,)."""
    return residuals * residual_scaling[..., None]


def correct_jacobian(jacobian, residuals, sqrt_rho1, alpha_sq_norm):
    """J <- sqrt(rho') (J - alpha/s r r^T J) (corrector.cc, BAMS eq. 12).
    jacobian: (..., num_rows, num_cols); ``residuals`` are the uncorrected
    ones (the reference corrects the Jacobian before the residuals)."""
    rTJ = torch.einsum("...r,...rc->...c", residuals, jacobian)
    outer = residuals[..., :, None] * rTJ[..., None, :]
    return sqrt_rho1[..., None, None] * (
        jacobian - alpha_sq_norm[..., None, None] * outer
    )
