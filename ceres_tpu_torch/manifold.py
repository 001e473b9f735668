"""Manifolds: Plus/Minus charts between ambient and tangent spaces (port of
``ceres_tpu/manifold.py``; the reference's ``include/ceres/manifold.h:148-411``,
``sphere_manifold.h``, ``line_manifold.h``, ``product_manifold.h``).

Every operation is a torch function of single-block 1-D tensors, written
without branches (``torch.where`` + safe denominators) and without in-place
index writes, so it can be ``vmap``ped over all parameter blocks sharing a
manifold and differentiated by ``torch.func.jacfwd``. The evaluator composes
residual functions with ``plus(x, delta)`` and differentiates with respect
to ``delta`` at 0.

Scalars inside these functions are kept as 1-element tensors (``x[i:i+1]``,
``sum(..., keepdim)``), never 0-dim ones: under ``vmap(jacfwd)`` a Python
float meeting a 0-dim tensor turns float32 tangents into float64.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd

_EPS = float(np.finfo(np.float64).eps)


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    """(1,) sum of squares."""
    return torch.sum(v * v, dim=0, keepdim=True)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sumsq(v))


def _sinc(theta_sq: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with a Taylor branch at t ~ 0, safe under jacfwd."""
    small = theta_sq < 1e-24
    safe_theta = torch.where(small, 1.0, theta)
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_theta) / safe_theta)


def _sinc_cos(delta: torch.Tensor):
    """(sinc|d|, cos|d|) as (1,) tensors, both guarded at d = 0: the sqrt
    and the division see 1 where |d|^2 < 1e-24, because jacfwd carries NaN
    tangents through the unused branch of ``torch.where``."""
    theta_sq = _sumsq(delta)
    small = theta_sq < 1e-24
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    cos = torch.where(small, 1.0 - theta_sq / 2.0, torch.cos(theta))
    return _sinc(theta_sq, theta), cos


class Manifold:
    """Base manifold (manifold.h:148-221).

    plus(x, delta) -> x', minus(y, x) -> delta, plus_jacobian(x) -> (A, T),
    minus_jacobian(x) -> (T, A), with A = ambient_size, T = tangent_size.
    """

    @property
    def ambient_size(self) -> int:
        raise NotImplementedError

    @property
    def tangent_size(self) -> int:
        raise NotImplementedError

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def minus(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def plus_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """d plus(x, delta) / d delta at delta = 0 (default: autodiff)."""
        zero = x.new_zeros((self.tangent_size,))
        return jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """d minus(y, x) / d y at y = x (default: autodiff)."""
        return jacfwd(lambda y: self.minus(y, x))(x)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(A={self.ambient_size}, T={self.tangent_size})"

    # Manifolds act as family-grouping keys; equality = same structure.
    def _key(self):
        return (type(self).__name__, self.ambient_size, self.tangent_size)

    def __eq__(self, other):
        return isinstance(other, Manifold) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


class EuclideanManifold(Manifold):
    """Plain vector space: plus = +, jacobians = identity (manifold.h:241)."""

    def __init__(self, size: int):
        self._size = int(size)

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: self._size)

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    def plus_jacobian(self, x):
        return _eye(self._size, x)

    def minus_jacobian(self, x):
        return _eye(self._size, x)


class SubsetManifold(Manifold):
    """Euclidean with some coordinates held constant (manifold.h:317)."""

    def __init__(self, size: int, constant_indices: Sequence[int]):
        self._size = int(size)
        const = sorted(set(int(i) for i in constant_indices))
        for i in const:
            if not 0 <= i < size:
                raise ValueError(f"constant index {i} out of range [0, {size})")
        self._constant = tuple(const)
        self._free = tuple(i for i in range(size) if i not in set(const))
        # Maximal runs (start, stop, is_free) of the ambient coordinates:
        # plus and minus are concatenations of slices, one per run.
        self._runs = []
        for i in range(self._size):
            free = i in self._free
            if self._runs and self._runs[-1][2] == free:
                self._runs[-1][1] = i + 1
            else:
                self._runs.append([i, i + 1, free])

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: len(self._free))

    @property
    def constant_indices(self) -> Tuple[int, ...]:
        return self._constant

    def plus(self, x, delta):
        parts, t = [], 0
        for a, b, free in self._runs:
            if free:
                parts.append(x[a:b] + delta[t : t + b - a])
                t += b - a
            else:
                parts.append(x[a:b])
        return torch.cat(parts)

    def minus(self, y, x):
        d = y - x
        parts = [d[a:b] for a, b, free in self._runs if free]
        return torch.cat(parts) if parts else d[:0]

    def plus_jacobian(self, x):
        return _eye(self._size, x)[:, list(self._free)]

    def minus_jacobian(self, x):
        return self.plus_jacobian(x).T

    def _key(self):
        return ("Subset", self._size, self._constant)


def _quat_product(z, w):
    """Hamilton product z*w of (w, x, y, z) component tuples -> same."""
    return (
        z[0] * w[0] - z[1] * w[1] - z[2] * w[2] - z[3] * w[3],
        z[0] * w[1] + z[1] * w[0] + z[2] * w[3] - z[3] * w[2],
        z[0] * w[2] - z[1] * w[3] + z[2] * w[0] + z[3] * w[1],
        z[0] * w[3] + z[1] * w[2] - z[2] * w[1] + z[3] * w[0],
    )


class _QuaternionManifoldBase(Manifold):
    """Unit quaternion manifold (manifold.cc:27-130, 264-330).

    plus(x, delta) = q(delta) * x with q(delta) = [cos|d|, sinc|d| d]
    (full-angle convention); minus(y, x) = log(y * conj(x)).
    ``_order`` maps (w, x, y, z) to storage indices.
    """

    _order: Tuple[int, int, int, int]

    ambient_size = property(lambda self: 4)
    tangent_size = property(lambda self: 3)

    def _wxyz(self, q):
        """(w, x, y, z) components of a stored quaternion, as (1,) slices."""
        return tuple(q[i : i + 1] for i in self._order)

    def _store(self, wxyz):
        """(w, x, y, z) components -> storage order."""
        slot = {s: c for s, c in zip(self._order, wxyz)}
        return torch.cat([slot[i] for i in range(4)])

    def plus(self, x, delta):
        sinc, cos = _sinc_cos(delta)
        q = (cos, sinc * delta[0:1], sinc * delta[1:2], sinc * delta[2:3])
        return self._store(_quat_product(q, self._wxyz(x)))

    def minus(self, y, x):
        # y * conj(x) in (w, x, y, z) components (manifold.cc:81-114).
        xw, xx, xy, xz = self._wxyz(x)
        amb = _quat_product(self._wxyz(y), (xw, -xx, -xy, -xz))
        v = torch.cat(amb[1:])
        u_sq = _sumsq(v)
        small = u_sq < 1e-300
        u = torch.sqrt(torch.where(small, 1.0, u_sq))
        theta_by_u = torch.where(small, 0.0, torch.atan2(u, amb[0]) / u)
        return theta_by_u * v

    def _rows(self, x):
        w, xx, yy, zz = self._wxyz(x)
        by_component = (
            torch.cat([-xx, -yy, -zz]),
            torch.cat([w, zz, -yy]),
            torch.cat([-zz, w, xx]),
            torch.cat([yy, -xx, w]),
        )
        slot = {s: r for s, r in zip(self._order, by_component)}
        return [slot[i] for i in range(4)]

    def plus_jacobian(self, x):
        # d(q(delta) * x)/d delta at 0 = right-multiplication matrix
        # R(x)[:, (x,y,z)] (manifold.cc QuaternionPlusJacobianImpl).
        return torch.stack(self._rows(x), dim=0)

    def minus_jacobian(self, x):
        # d minus(y, x)/d y at y = x: rows (x, y, z) of right-mult by conj(x).
        return torch.stack(self._rows(x), dim=1)


class QuaternionManifold(_QuaternionManifoldBase):
    """Ceres storage order [w, x, y, z] (manifold.h:366)."""

    _order = (0, 1, 2, 3)


class EigenQuaternionManifold(_QuaternionManifoldBase):
    """Eigen storage order [x, y, z, w] (manifold.h:390)."""

    _order = (3, 0, 1, 2)


def householder_vector(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v, beta) with H = I - beta v v^T orthogonal and H x = |x| e_n; beta
    is a (1,) tensor. The pivot is the *last* element
    (householder_vector.h:48-82)."""
    sigma = _sumsq(x[:-1])
    x_pivot = x[-1:]
    small = sigma <= _EPS
    mu = torch.sqrt(x_pivot * x_pivot + sigma)
    denom = torch.where(x_pivot > 0.0, x_pivot + mu, 1.0)
    v_pivot = torch.where(x_pivot <= 0.0, x_pivot - mu, -sigma / denom)
    v_pivot_safe = torch.where(small | (v_pivot == 0.0), 1.0, v_pivot)
    beta = torch.where(
        small,
        torch.where(x_pivot < 0.0, 2.0, torch.zeros_like(x_pivot)),
        2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot),
    )
    head = torch.where(small, x[:-1], x[:-1] / v_pivot_safe)
    v = torch.cat([head, torch.ones_like(x_pivot)])
    return v, beta


def apply_householder(y: torch.Tensor, v: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """H y = y - beta v (v . y) (householder_vector.h:85-90)."""
    return y - v * (beta * torch.sum(v * y, dim=0, keepdim=True))


def _householder_matrix(x: torch.Tensor) -> torch.Tensor:
    v, beta = householder_vector(x)
    return _eye(x.shape[0], x) - beta * torch.outer(v, v)


class SphereManifold(Manifold):
    """Unit-direction sphere S^{n-1} embedded in R^n (sphere_manifold.h).

    Chart via the Householder reflection taking x to |x| e_n
    (sphere_manifold_functions.h:64-131; Hertzberg et al. B.2 eq. 106-108).
    """

    def __init__(self, size: int):
        if size <= 1:
            raise ValueError("SphereManifold needs ambient size > 1")
        self._size = int(size)

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: self._size - 1)

    def plus(self, x, delta):
        sinc, cos = _sinc_cos(delta)
        v, beta = householder_vector(x)
        y = torch.cat([sinc * delta, cos])
        return _norm(x) * apply_householder(y, v, beta)

    def minus(self, y, x):
        v, beta = householder_vector(x)
        hy = apply_householder(y, v, beta) / _norm(x)
        head, y_last = hy[:-1], hy[-1:]
        hn_sq = _sumsq(head)
        small = hn_sq == 0.0
        hn = torch.sqrt(torch.where(small, 1.0, hn_sq))
        scale = torch.where(small, 0.0, torch.atan2(hn, y_last) / hn)
        out = scale * head
        # Degenerate antipodal case: delta = [0, ..., pi]
        # (sphere_manifold_functions.h:124-127).
        last = torch.where(y_last >= 0, torch.zeros_like(y_last), math.pi)
        pi_tail = torch.cat([torch.zeros_like(out[:-1]), last])
        return torch.where(small, pi_tail, out)

    def plus_jacobian(self, x):
        return _householder_matrix(x)[:, :-1] * _norm(x)

    def minus_jacobian(self, x):
        return _householder_matrix(x)[:-1, :] / _norm(x)


class LineManifold(Manifold):
    """Line in R^n as (origin, direction) with direction on the sphere.

    Ambient = 2n ([origin, direction]); tangent = 2(n-1). Mirrors
    line_manifold.h:142-270: the origin moves only perpendicular to the
    direction (through the direction's Householder frame).
    """

    def __init__(self, size: int):
        if size <= 1:
            raise ValueError("LineManifold needs spatial dim > 1")
        self._n = int(size)
        self._sphere = SphereManifold(size)

    ambient_size = property(lambda self: 2 * self._n)
    tangent_size = property(lambda self: 2 * (self._n - 1))

    def plus(self, x, delta):
        n = self._n
        o, d = x[:n], x[n:]
        delta_o, delta_d = delta[: n - 1], delta[n - 1 :]
        d_new = self._sphere.plus(d, delta_d)
        v, beta = householder_vector(d)
        y = torch.cat([delta_o, torch.zeros_like(delta_o[:1])])
        o_new = o + apply_householder(y, v, beta)
        return torch.cat([o_new, d_new])

    def minus(self, y, x):
        n = self._n
        y_o, y_d = y[:n], y[n:]
        x_o, x_d = x[:n], x[n:]
        d_tangent = self._sphere.minus(y_d, x_d)
        v, beta = householder_vector(x_d)
        o_tangent = apply_householder(y_o - x_o, v, beta)[: n - 1]
        return torch.cat([o_tangent, d_tangent])

    def plus_jacobian(self, x):
        # line_manifold.h:219-238: both diagonal blocks are the sphere
        # plus-jacobian of the direction.
        jac_d = self._sphere.plus_jacobian(x[self._n :])  # (n, n-1)
        return _block_diagonal([jac_d, jac_d])

    def minus_jacobian(self, x):
        """Analytic d minus(y, x)/dy at y = x (line_manifold.h:240-263):
        block-diagonal of the Householder head rows (origin) and the
        sphere minus-jacobian (direction). The default autodiff path is
        numerically undefined exactly at y = x (chart branch point)."""
        d = x[self._n :]
        H = _householder_matrix(d)
        return _block_diagonal([H[:-1, :], self._sphere.minus_jacobian(d)])


def _block_diagonal(blocks) -> torch.Tensor:
    """Block-diagonal matrix of 2-D blocks, by concatenation."""
    widths = [b.shape[1] for b in blocks]
    rows, before = [], 0
    for b, w in zip(blocks, widths):
        after = sum(widths) - before - w
        rows.append(
            torch.cat(
                [b.new_zeros((b.shape[0], before)), b, b.new_zeros((b.shape[0], after))],
                dim=1,
            )
        )
        before += w
    return torch.cat(rows, dim=0)


class ProductManifold(Manifold):
    """Cartesian product of manifolds (product_manifold.h)."""

    def __init__(self, *manifolds: Manifold):
        if not manifolds:
            raise ValueError("ProductManifold needs at least one manifold")
        self._manifolds = tuple(manifolds)
        self._ambient = sum(m.ambient_size for m in manifolds)
        self._tangent = sum(m.tangent_size for m in manifolds)

    ambient_size = property(lambda self: self._ambient)
    tangent_size = property(lambda self: self._tangent)
    manifolds = property(lambda self: self._manifolds)

    def _splits(self):
        a = t = 0
        for m in self._manifolds:
            yield m, a, t
            a += m.ambient_size
            t += m.tangent_size

    def plus(self, x, delta):
        return torch.cat(
            [
                m.plus(x[a : a + m.ambient_size], delta[t : t + m.tangent_size])
                for m, a, t in self._splits()
            ]
        )

    def minus(self, y, x):
        return torch.cat(
            [
                m.minus(y[a : a + m.ambient_size], x[a : a + m.ambient_size])
                for m, a, _ in self._splits()
            ]
        )

    def plus_jacobian(self, x):
        return _block_diagonal(
            [m.plus_jacobian(x[a : a + m.ambient_size]) for m, a, _ in self._splits()]
        )

    def minus_jacobian(self, x):
        return _block_diagonal(
            [m.minus_jacobian(x[a : a + m.ambient_size]) for m, a, _ in self._splits()]
        )

    def _key(self):
        return ("Product",) + tuple(m._key() for m in self._manifolds)
