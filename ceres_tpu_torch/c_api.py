"""The flat "C API" (port of ``ceres_tpu/c_api.py``, after
``include/ceres/c_api.h:1-148`` and ``internal/ceres/c_api.cc``): problem
create / free, one callback-based ``ceres_problem_add_residual_block``, the
stock loss constructors and a fixed-options ``ceres_solve``, with the same
names and the same fill-in callback contract.

- A cost callback receives (user_data, parameters, residuals, jacobians) and
  FILLS the residual array and, when ``jacobians`` is not None, each
  non-None Jacobian array, returning truthy on success.
- Parameter blocks are identified by the numpy array the caller passes (the
  ``double*`` of C) and ``ceres_solve`` writes the solution back into them.
- ``ceres_solve`` uses the fixed options of ``c_api.cc:175-185``: 100
  iterations, DENSE_QR, progress to stdout, then the full report.

A callback runs on the host in float64, one residual block at a time. It is
the forward function of a ``torch.autograd.Function`` whose ``vmap`` rule
copies the batch to the host and calls the callback once per instance, and
whose forward-mode rule multiplies the tangents by the callback's own
Jacobians (fetched the same way), so the evaluator's ``vmap(jacfwd)`` takes
them as they are, to the bit in float64.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ceres_tpu_torch import loss as _loss
from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions, solve
from ceres_tpu_torch.types import LinearSolverType

__all__ = [
    "ceres_init",
    "ceres_create_problem",
    "ceres_free_problem",
    "ceres_problem_add_residual_block",
    "ceres_solve",
    "ceres_stock_loss_function",
    "ceres_create_huber_loss_function_data",
    "ceres_create_softl1_loss_function_data",
    "ceres_create_cauchy_loss_function_data",
    "ceres_create_arctan_loss_function_data",
    "ceres_create_tolerant_loss_function_data",
    "ceres_free_stock_loss_function_data",
]


def ceres_init() -> None:
    """``ceres_init()``: the reference initializes logging; a no-op here."""


class CeresProblem:
    """Opaque problem handle (``ceres_problem_t``)."""

    def __init__(self) -> None:
        self.problem = Problem()
        self._param_ids: dict = {}  # id(array) -> (pid, array)

    def _param_id(self, arr: np.ndarray) -> int:
        key = id(arr)
        if key not in self._param_ids:
            pid = self.problem.add_parameter_block(np.asarray(arr, float))
            self._param_ids[key] = (pid, arr)
        return self._param_ids[key][0]


def ceres_create_problem() -> CeresProblem:
    return CeresProblem()


def ceres_free_problem(problem: CeresProblem) -> None:
    """Release the handle (the collector does the real work)."""
    problem.problem = None
    problem._param_ids = {}


def _host_instances(in_dims, blocks, batch: int):
    """The blocks of a vmapped call as per-instance float64 numpy arrays."""
    host = []
    for b, d in zip(blocks, in_dims):
        a = b.detach().to("cpu", torch.float64)
        a = a.movedim(d, 0) if d is not None else a.expand(batch, *a.shape)
        host.append(a.reshape(batch, -1).numpy())
    return host


class _Callback:
    """One residual block's callback, its sizes, and its two host calls."""

    def __init__(self, fn: Callable, user_data, num_residuals: int, sizes: Sequence[int]):
        self.fn = fn
        self.user_data = user_data
        self.nr = num_residuals
        self.sizes = tuple(sizes)

    def residuals(self, params) -> np.ndarray:
        res = np.zeros(self.nr, dtype=np.float64)
        if not self.fn(self.user_data, list(params), res, None):
            res[:] = np.nan  # the evaluator reads non-finite as failure
        return res

    def jacobians(self, params):
        res = np.zeros(self.nr, dtype=np.float64)
        jacs = [np.zeros((self.nr, sz), dtype=np.float64) for sz in self.sizes]
        if not self.fn(self.user_data, list(params), res, jacs):
            for J in jacs:
                J[:] = np.nan
        return jacs


class _Jacobians(torch.autograd.Function):
    """The callback's Jacobians, one (num_residuals, size_j) per block."""

    @staticmethod
    def forward(cb, *blocks):
        params = [b.detach().to("cpu", torch.float64).reshape(-1).numpy() for b in blocks]
        like = blocks[0]
        return tuple(
            torch.from_numpy(J).to(like.device, like.dtype) for J in cb.jacobians(params)
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, cb, *blocks):
        B = info.batch_size
        host = _host_instances(in_dims[1:], blocks, B)
        out = [np.empty((B, cb.nr, sz)) for sz in cb.sizes]
        for i in range(B):
            for o, J in zip(out, cb.jacobians([h[i] for h in host])):
                o[i] = J
        like = blocks[0]
        return tuple(torch.from_numpy(o).to(like.device, like.dtype) for o in out), (0,) * len(out)


class _Residuals(torch.autograd.Function):
    """The callback's residuals, with its Jacobians as the forward rule."""

    @staticmethod
    def forward(cb, *blocks):
        params = [b.detach().to("cpu", torch.float64).reshape(-1).numpy() for b in blocks]
        return torch.from_numpy(cb.residuals(params)).to(blocks[0].device, blocks[0].dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cb = inputs[0]
        ctx.save_for_forward(*inputs[1:])

    @staticmethod
    def jvp(ctx, _cb_tangent, *tangents):
        blocks = ctx.saved_tensors
        jacs = _Jacobians.apply(ctx.cb, *blocks)
        out = None
        for J, t in zip(jacs, tangents):
            if t is None:
                continue
            term = J @ t.reshape(-1)
            out = term if out is None else out + term
        return out if out is not None else blocks[0].new_zeros((ctx.cb.nr,))

    @staticmethod
    def vmap(info, in_dims, cb, *blocks):
        B = info.batch_size
        host = _host_instances(in_dims[1:], blocks, B)
        out = np.empty((B, cb.nr))
        for i in range(B):
            out[i] = cb.residuals([h[i] for h in host])
        return torch.from_numpy(out).to(blocks[0].device, blocks[0].dtype), 0


class _CallbackLoss(_loss.LossFunction):
    """A ``ceres_loss_function_t`` callback, fn(user_data, s, out[3]),
    called per element on the host."""

    runs_on_host = True  # no CUDA graph holds it (fused_lm.captured_loop_eligible)

    def __init__(self, fn: Callable, user_data) -> None:
        self._fn = fn
        self._user_data = user_data

    def evaluate(self, s):
        flat = s.detach().to("cpu", torch.float64).reshape(-1).numpy()
        out = np.zeros((3, flat.shape[0]))
        for i, si in enumerate(flat):
            buf = np.zeros(3)
            self._fn(self._user_data, float(si), buf)
            out[:, i] = buf
        t = torch.from_numpy(out).to(s.device, s.dtype).reshape(3, *s.shape)
        return t[0], t[1], t[2]


def ceres_stock_loss_function(loss_function_data, squared_norm, out) -> None:
    """``ceres_stock_loss_function``: evaluate a stock loss made by a
    ``ceres_create_*_loss_function_data`` call into ``out[0:3]``."""
    rho = loss_function_data.evaluate(torch.tensor([float(squared_norm)], dtype=torch.float64))
    out[0], out[1], out[2] = (float(r[0]) for r in rho)


def ceres_create_huber_loss_function_data(a: float):
    return _loss.HuberLoss(a)


def ceres_create_softl1_loss_function_data(a: float):
    return _loss.SoftLOneLoss(a)


def ceres_create_cauchy_loss_function_data(a: float):
    return _loss.CauchyLoss(a)


def ceres_create_arctan_loss_function_data(a: float):
    return _loss.ArctanLoss(a)


def ceres_create_tolerant_loss_function_data(a: float, b: float):
    return _loss.TolerantLoss(a, b)


def ceres_free_stock_loss_function_data(loss_function_data) -> None:
    """A no-op (Python objects are collected)."""


def ceres_problem_add_residual_block(
    problem: CeresProblem,
    cost_function: Callable,
    cost_function_data,
    loss_function: Optional[Callable],
    loss_function_data,
    num_residuals: int,
    num_parameter_blocks: int,
    parameter_block_sizes: Sequence[int],
    parameter_pointers: Sequence[np.ndarray],
) -> int:
    """``ceres_problem_add_residual_block`` (c_api.cc:141-171).

    ``cost_function(user_data, parameters, residuals, jacobians)`` fills
    ``residuals`` (length ``num_residuals``) and, when ``jacobians`` is not
    None, each non-None ``jacobians[i]`` with the (num_residuals, size_i)
    row-major Jacobian; it returns truthy on success."""
    sizes = [int(s) for s in parameter_block_sizes]
    if len(sizes) != int(num_parameter_blocks) or len(parameter_pointers) != len(sizes):
        raise ValueError("parameter block count/size mismatch")
    for arr, sz in zip(parameter_pointers, sizes):
        if np.asarray(arr).size != sz:
            raise ValueError("parameter array size != declared size")
    cb = _Callback(cost_function, cost_function_data, int(num_residuals), sizes)

    def fn(*blocks):
        return _Residuals.apply(cb, *blocks)

    fn.runs_on_host = True  # no CUDA graph holds it (fused_lm.captured_loop_eligible)

    if loss_function is None:
        loss_obj: Optional[_loss.LossFunction] = None
    elif loss_function is ceres_stock_loss_function:
        loss_obj = loss_function_data  # already a LossFunction
    else:
        loss_obj = _CallbackLoss(loss_function, loss_function_data)

    pids = [problem._param_id(arr) for arr in parameter_pointers]
    return problem.problem.add_residual_block(fn, loss_obj, pids)


def ceres_solve(problem: CeresProblem, max_num_iterations: int = 100, device="cuda"):
    """``ceres_solve`` (c_api.cc:173-186): fixed options (100 iterations,
    DENSE_QR, progress to stdout) on ``device`` (the card by default), then
    the full report, and the solution written back into the caller's
    parameter arrays, as the C API writes through ``double*``."""
    opts = SolverOptions()
    opts.max_num_iterations = int(max_num_iterations)
    opts.linear_solver_type = LinearSolverType.DENSE_QR
    opts.minimizer_progress_to_stdout = True
    summary = solve(opts, problem.problem, device=device)
    print(summary.full_report())
    for pid, arr in problem._param_ids.values():
        value = np.asarray(problem.problem.parameter_block_value(pid)).reshape(np.shape(arr))
        np.asarray(arr)[...] = value
    return summary
