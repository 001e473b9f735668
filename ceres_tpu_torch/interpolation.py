"""Cubic Hermite (Catmull-Rom) interpolation of sampled functions and images
(port of ``ceres_tpu/interpolation.py``, after
``include/ceres/cubic_interpolation.h``: ``CubicHermiteSpline`` (:65-91),
``Grid1D`` (:184), ``CubicInterpolator`` (:124), ``Grid2D`` (:381),
``BiCubicInterpolator`` (:252)).

Plain torch and transparent to ``torch.func``: the cell index is
``floor(x)`` cast to an integer, which carries no derivative, and the
derivative flows through the fractional part ``x - floor(x)`` into the local
polynomial, as the reference's Jets do. The grids keep their samples in
float64 and hand them out in the dtype and on the device of the point they
are asked at. Residuals are written on 1-element slices (see
``models/bal.py``), so a value comes back with the shape of the point plus
the sample's dimension D: ``evaluate(x)`` on a (1,) x gives (1, D).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def cubic_hermite_spline(p0, p1, p2, p3, x):
    """f and df/dx of the Catmull-Rom spline through p0..p3 on [0, 1]
    (cubic_interpolation.h:65-91)."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    d = p1
    f = d + x * (c + x * (b + x * a))
    dfdx = c + x * (2.0 * b + 3.0 * a * x)
    return f, dfdx


class _Samples:
    """A float64 sample array, handed out on an index's device in a point's
    dtype (one copy per pair, made at first use)."""

    def __init__(self, data):
        self.data = torch.as_tensor(np.asarray(data, dtype=np.float64))
        self._copies = {}

    def like(self, index: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        key = (index.device, self.data.dtype if x is None else x.dtype)
        out = self._copies.get(key)
        if out is None:
            out = self.data.to(device=key[0], dtype=key[1])
            self._copies[key] = out
        return out


class Grid1D:
    """Bounded 1-D grid of (possibly vector-valued) samples; a point outside
    [begin, begin + N) takes the edge sample (cubic_interpolation.h:184-247).

    data: (N,) or (N, D)."""

    def __init__(self, data, begin: int = 0):
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        self._samples = _Samples(data)
        self.data = self._samples.data
        self.begin = begin
        self.num = data.shape[0]

    def value(self, n: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Samples at integer positions n, in the dtype of ``like`` (float64
        without one)."""
        idx = torch.clamp(n - self.begin, 0, self.num - 1)
        return self._samples.like(n, like)[idx]


class CubicInterpolator:
    """f(x) and f'(x) anywhere on the real line (cubic_interpolation.h:124).
    ``evaluate(x)`` returns (f, dfdx), each of shape x.shape + (D,)."""

    def __init__(self, grid: Grid1D):
        self.grid = grid

    def evaluate(self, x: torch.Tensor):
        n = torch.floor(x).long()
        value = self.grid.value
        p0, p1 = value(n - 1, x), value(n, x)
        p2, p3 = value(n + 1, x), value(n + 2, x)
        return cubic_hermite_spline(p0, p1, p2, p3, (x - n)[..., None])

    def __call__(self, x):
        return self.evaluate(x)[0]


class Grid2D:
    """Bounded 2-D grid (cubic_interpolation.h:381-436). data: (R, C) or
    (R, C, D); rows and columns outside the grid take the edge samples."""

    def __init__(self, data, row_begin: int = 0, col_begin: int = 0):
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 2:
            data = data[:, :, None]
        self._samples = _Samples(data)
        self.data = self._samples.data
        self.row_begin = row_begin
        self.col_begin = col_begin
        self.rows = data.shape[0]
        self.cols = data.shape[1]

    def value(self, r: torch.Tensor, c: torch.Tensor,
              like: Optional[torch.Tensor] = None) -> torch.Tensor:
        ri = torch.clamp(r - self.row_begin, 0, self.rows - 1)
        ci = torch.clamp(c - self.col_begin, 0, self.cols - 1)
        return self._samples.like(r, like)[ri, ci]


class BiCubicInterpolator:
    """f(r, c), df/dr and df/dc by splines along the columns of four rows,
    then along the rows (cubic_interpolation.h:252-379). Each of shape
    r.shape + (D,)."""

    def __init__(self, grid: Grid2D):
        self.grid = grid

    def evaluate(self, r: torch.Tensor, c: torch.Tensor):
        row = torch.floor(r).long()
        col = torch.floor(c).long()
        cf = (c - col)[..., None]
        rf = (r - row)[..., None]
        value = self.grid.value

        def row_spline(ri):
            p0, p1 = value(ri, col - 1, c), value(ri, col, c)
            p2, p3 = value(ri, col + 1, c), value(ri, col + 2, c)
            return cubic_hermite_spline(p0, p1, p2, p3, cf)

        f0, df0 = row_spline(row - 1)
        f1, df1 = row_spline(row)
        f2, df2 = row_spline(row + 1)
        f3, df3 = row_spline(row + 2)
        f, dfdr = cubic_hermite_spline(f0, f1, f2, f3, rf)
        dfdc, _ = cubic_hermite_spline(df0, df1, df2, df3, rf)
        return f, dfdr, dfdc

    def __call__(self, r, c):
        return self.evaluate(r, c)[0]
