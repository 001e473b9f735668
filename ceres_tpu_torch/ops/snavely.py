"""The Snavely reprojection residual and its Jacobian in one pass: the CUDA
kernel and its plain version.

For B observations, each with a row of the (C, 9) camera table and of the
(P, 3) point table and an observed (2,) position, the residual of
``models/bal.snavely_reprojection_residual`` -> r (B, 2), and its Jacobian
with respect to the camera and to the point -> J_cam (B, 2, 9) and J_pt
(B, 2, 3), as ``vmap(jacfwd)`` gives them, to rounding. The kernel
(``ceres_tpu_torch/csrc/snavely_evaluate.cu``, with its design note) reads
the rows itself and keeps every intermediate in registers: no gathered
(B, 9) and (B, 3) copies, none of the (B, 12, .) tangent tensors.

:func:`evaluate` launches the kernel for CUDA tensors and takes
:func:`evaluate_plain` for CPU tensors; there is no other route.
:func:`fused_form` is the entry the evaluator calls through the residual's
``fused_form`` attribute (``models/bal.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ceres_tpu_torch.ops import cuda_build
from ceres_tpu_torch.utils import cuda_graph

# Kernel launches made by evaluate (a plain counter: a run can show that its
# main path went through the kernel).
launches = 0


def _credit(n: int) -> None:
    """Add n launches (``utils.cuda_graph.launched``)."""
    global launches
    launches += n


_SOURCE = "snavely_evaluate.cu"
_SMALL = 1e-24  # rotation.angle_axis_rotate_point's first-order branch below it


class _Dual:
    """A (B,) value and its (B, N) forward-mode tangents, combined as the
    kernel's ``Dual`` combines them."""

    __slots__ = ("v", "d")

    def __init__(self, v: torch.Tensor, d: torch.Tensor):
        self.v, self.d = v, d

    def __add__(self, o: "_Dual") -> "_Dual":
        return _Dual(self.v + o.v, self.d + o.d)

    def __sub__(self, o: "_Dual") -> "_Dual":
        return _Dual(self.v - o.v, self.d - o.d)

    def __neg__(self) -> "_Dual":
        return _Dual(-self.v, -self.d)

    def __mul__(self, o: "_Dual") -> "_Dual":
        return _Dual(self.v * o.v, o.d * self.v[:, None] + self.d * o.v[:, None])

    def __truediv__(self, o: "_Dual") -> "_Dual":
        q = self.v / o.v
        return _Dual(q, (self.d - o.d * q[:, None]) * (1.0 / o.v)[:, None])

    def where(self, mask: torch.Tensor, other: "_Dual") -> "_Dual":
        """``self`` where ``mask``, else ``other``."""
        return _Dual(torch.where(mask, self.v, other.v),
                     torch.where(mask[:, None], self.d, other.d))


def _variables(values: torch.Tensor, first_slot: int, N: int):
    """The columns of ``values`` (B, k) as duals with tangents e_first_slot,
    e_first_slot+1, ..."""
    B, k = values.shape
    out = []
    for i in range(k):
        d = values.new_zeros((B, N))
        d[:, first_slot + i] = 1.0
        out.append(_Dual(values[:, i], d))
    return out


def _sqrt(a: _Dual) -> _Dual:
    s = torch.sqrt(a.v)
    return _Dual(s, a.d * (1.0 / (s + s))[:, None])


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def evaluate_plain(cameras, points, cam_rows, pt_rows, observed, jacobians: bool = True):
    """Plain PyTorch version: the kernel's dual arithmetic on (B,) columns
    and (B, 12) tangents (angle-axis, translation, point, f, k1, k2), both
    branches of the rotation computed and one taken per row."""
    cam = cameras[cam_rows]
    pt = points[pt_rows]
    N = 12
    aa = _variables(cam[:, 0:3], 0, N)
    t = _variables(cam[:, 3:6], 3, N)
    X = _variables(pt, 6, N)
    focal, k1, k2 = _variables(cam[:, 6:9], 9, N)
    theta_sq = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2]
    small = theta_sq.v < _SMALL
    near = [x + c for x, c in zip(X, _cross(aa, X))]
    one = torch.ones_like(theta_sq.v)
    theta = _sqrt(_Dual(torch.where(small, one, theta_sq.v),
                        torch.where(small[:, None], 0.0, theta_sq.d)))
    w = [a / theta for a in aa]
    cos_t = _Dual(torch.cos(theta.v), theta.d * (-torch.sin(theta.v))[:, None])
    sin_t = _Dual(torch.sin(theta.v), theta.d * torch.cos(theta.v)[:, None])
    w_cross_x = _cross(w, X)
    w_dot_x = w[0] * X[0] + w[1] * X[1] + w[2] * X[2]
    k = w_dot_x * (_Dual(one, torch.zeros_like(cos_t.d)) - cos_t)
    full = [x * cos_t + wx * sin_t + wi * k for x, wx, wi in zip(X, w_cross_x, w)]
    p = [n.where(small, f) + ti for n, f, ti in zip(near, full, t)]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = _Dual(one, torch.zeros_like(r2.d)) + r2 * (k1 + k2 * r2)
    scale = focal * distortion
    px, py = scale * xp, scale * yp
    r = torch.stack([px.v - observed[:, 0], py.v - observed[:, 1]], dim=1)
    if not jacobians:
        return r
    cam_cols = [0, 1, 2, 3, 4, 5, 9, 10, 11]
    J = torch.stack([px.d, py.d], dim=1)  # (B, 2, 12)
    return r, J[:, :, cam_cols].contiguous(), J[:, :, 6:9].contiguous()


@functools.cache
def _library():
    """The loaded library with its argument types set (once per process)."""
    lib = cuda_build.load_library("snavely_evaluate", [_SOURCE])
    for fn in (lib.snavely_evaluate_f32, lib.snavely_evaluate_f64):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _library()


def evaluate(cameras: torch.Tensor, points: torch.Tensor, cam_rows: torch.Tensor,
             pt_rows: torch.Tensor, observed: torch.Tensor, jacobians: bool = True):
    """Camera table (C, 9), point table (P, 3), each observation's int64
    rows in them (B,) and observed positions (B, 2), all of one float dtype
    -> r (B, 2), or (r, J_cam (B, 2, 9), J_pt (B, 2, 3)) with
    ``jacobians``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise). The rows are not range-checked (that would read
    them on the host): they must index the tables."""
    dev, dtype = cameras.device, cameras.dtype
    B = cam_rows.shape[0] if cam_rows.ndim == 1 else -1
    if cameras.ndim != 2 or cameras.shape[1] != 9 or points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"tables must be (C, 9) and (P, 3), got {tuple(cameras.shape)} and "
                         f"{tuple(points.shape)}")
    if (B < 0 or pt_rows.shape != (B,) or observed.shape != (B, 2)
            or cam_rows.dtype != torch.int64 or pt_rows.dtype != torch.int64):
        raise ValueError("rows must be two int64 (B,) vectors and observed (B, 2)")
    for name, a in (("points", points), ("cam_rows", cam_rows), ("pt_rows", pt_rows),
                    ("observed", observed)):
        if a.device != dev:
            raise ValueError(f"{name} on {a.device} but cameras on {dev}")
    if points.dtype != dtype or observed.dtype != dtype:
        raise TypeError(f"dtypes differ: {dtype}, {points.dtype}, {observed.dtype}")
    if dev.type == "cpu":
        return evaluate_plain(cameras, points, cam_rows, pt_rows, observed, jacobians)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dtype == torch.float32:
        name = "snavely_evaluate_f32"
    elif dtype == torch.float64:
        name = "snavely_evaluate_f64"
    else:
        raise TypeError(f"unsupported dtype {dtype}")
    cameras, points, observed = cameras.contiguous(), points.contiguous(), observed.contiguous()
    cam_rows, pt_rows = cam_rows.contiguous(), pt_rows.contiguous()
    r = torch.empty((B, 2), dtype=dtype, device=dev)
    j_cam = torch.empty((B, 2, 9), dtype=dtype, device=dev) if jacobians else None
    j_pt = torch.empty((B, 2, 3), dtype=dtype, device=dev) if jacobians else None
    fn = getattr(_library(), name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        cameras.data_ptr(), points.data_ptr(), cam_rows.data_ptr(), pt_rows.data_ptr(),
        observed.data_ptr(), r.data_ptr(), j_cam.data_ptr() if jacobians else None,
        j_pt.data_ptr() if jacobians else None, B, int(jacobians), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if B:
        cuda_graph.launched(_credit)
    return (r, j_cam, j_pt) if jacobians else r


def fused_form(tables, rows, observed, jacobians: bool):
    """The evaluator's entry (``evaluator.family_residuals``,
    ``family_residuals_and_jacobians``): the family's ambient tables and
    rows of its two args (camera, point) and its data -> r, or
    (r, (J_cam, J_pt))."""
    (cameras, points), (cam_rows, pt_rows) = tables, rows
    out = evaluate(cameras, points, cam_rows, pt_rows, observed, jacobians)
    return (out[0], out[1:]) if jacobians else out
