"""The plain reference the benchmark judges the program's solves by.

Plain PyTorch in float64, written from the Snavely model and the normal
equations and nothing else: it imports nothing of ``ceres_tpu_torch`` (a test
holds it to that) and takes none of the program's plans, orderings or
weights. It works from the scene's own arrays (observations in the order
they were drawn) and from a state the program returned, which it only
judges.

- :func:`cost`: 0.5 sum of squared reprojection errors at a state.
- :func:`gauss_newton_decrease`: the decrease of the cost that one
  Gauss-Newton step from a state predicts, as a share of the cost there:
  about 0 at a minimum, large away from one. The step solves the
  Levenberg-Marquardt system (J'J + lam diag(J'J)) d = -J'r exactly, by
  eliminating the points and factoring the dense reduced camera system with
  Cholesky; lam = 1e-8 only makes the 7 gauge directions of bundle
  adjustment (the similarity transforms, which leave every projection
  alone) solvable, along which the gradient is 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from port_bench.scene import Scene, project

F64 = torch.float64
# Observations a block: bounds the Jacobian's temporaries (vmap(jacfwd) over
# 12 tangents) and the pair products' (9 x 9 each).
BLOCK = 1 << 18
DAMPING = 1e-8


def _residual_one(cam, pt, obs):
    return project(cam[None], pt[None])[0] - obs


_jacobian = vmap(jacfwd(_residual_one, argnums=(0, 1)))


class Reference:
    """The scene's observations on ``device``, and the pair lists of its
    reduced camera system (every ordered pair of observations of one point,
    built here from the visibility), made once and used for every state
    judged."""

    def __init__(self, scene: Scene, device):
        self.device = torch.device(device)
        self.C, self.P = scene.num_cameras, scene.num_points
        self.ci = torch.from_numpy(scene.camera_index).to(self.device)
        self.pi = torch.from_numpy(scene.point_index).to(self.device)
        self.obs = torch.from_numpy(scene.observations).to(self.device, F64)
        pt = scene.point_index
        order = np.argsort(pt, kind="stable")
        n = np.bincount(pt, minlength=self.P)
        first = np.concatenate([[0], np.cumsum(n)])
        group = n[pt[order]]  # size of each sorted observation's point group
        ia = np.repeat(np.arange(order.size), group)
        start = first[pt[order]][ia]
        ib = start + (np.arange(ia.size) - np.repeat(np.cumsum(group) - group, group))
        self.pair_a = torch.from_numpy(order[ia]).to(self.device)
        self.pair_b = torch.from_numpy(order[ib]).to(self.device)

    def _split(self, x: np.ndarray):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)
        return x[: 9 * self.C].reshape(self.C, 9), x[9 * self.C:].reshape(self.P, 3)

    def _blocks(self):
        n = self.obs.shape[0]
        return [slice(s, min(s + BLOCK, n)) for s in range(0, n, BLOCK)]

    def cost(self, x: np.ndarray) -> float:
        cams, pts = self._split(x)
        total = torch.zeros((), dtype=F64, device=self.device)
        for b in self._blocks():
            r = project(cams[self.ci[b]], pts[self.pi[b]]) - self.obs[b]
            total += 0.5 * torch.sum(r * r)
        return float(total)

    def gauss_newton_decrease(self, x: np.ndarray) -> float:
        """Predicted relative decrease of one exact (lightly damped)
        Gauss-Newton step from ``x``: (-g'd - d'J'Jd/2) / cost."""
        C, P, dev = self.C, self.P, self.device
        cams, pts = self._split(x)
        gc = torch.zeros((C, 9), dtype=F64, device=dev)
        gp = torch.zeros((P, 3), dtype=F64, device=dev)
        U = torch.zeros((C, 9, 9), dtype=F64, device=dev)
        V = torch.zeros((P, 3, 3), dtype=F64, device=dev)
        n = self.obs.shape[0]
        Jc = torch.empty((n, 2, 9), dtype=F64, device=dev)
        Jp = torch.empty((n, 2, 3), dtype=F64, device=dev)
        cost = torch.zeros((), dtype=F64, device=dev)
        for b in self._blocks():
            ci, pi = self.ci[b], self.pi[b]
            r = project(cams[ci], pts[pi]) - self.obs[b]
            cost += 0.5 * torch.sum(r * r)
            Jc[b], Jp[b] = _jacobian(cams[ci], pts[pi], self.obs[b])
            gc.index_add_(0, ci, torch.einsum("nrk,nr->nk", Jc[b], r))
            gp.index_add_(0, pi, torch.einsum("nrk,nr->nk", Jp[b], r))
            U.index_add_(0, ci, torch.einsum("nri,nrj->nij", Jc[b], Jc[b]))
            V.index_add_(0, pi, torch.einsum("nri,nrj->nij", Jp[b], Jp[b]))
        W = torch.einsum("nri,nrj->nij", Jc, Jp)  # (O, 9, 3) camera-point blocks
        U = U + DAMPING * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))
        V = V + DAMPING * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2))
        Vinv = torch.linalg.inv(V)

        # S = U - sum over pairs (a, b) of one point of W_a V^-1 W_b'
        cells = torch.zeros((C * C, 81), dtype=F64, device=dev)
        for s in range(0, self.pair_a.shape[0], BLOCK):
            a, bb = self.pair_a[s:s + BLOCK], self.pair_b[s:s + BLOCK]
            Y = Vinv[self.pi[bb]] @ W[bb].transpose(1, 2)  # (B, 3, 9)
            cells.index_add_(0, self.ci[a] * C + self.ci[bb], (W[a] @ Y).reshape(-1, 81))
        S = -cells.reshape(C, C, 9, 9).permute(0, 2, 1, 3).reshape(9 * C, 9 * C)
        S += torch.block_diag(*U)
        # rhs = -g_c + sum_o W_o V^-1 g_p
        Vg = torch.einsum("pij,pj->pi", Vinv, gp)
        rhs = -gc.clone()
        rhs.index_add_(0, self.ci, torch.einsum("nij,nj->ni", W, Vg[self.pi]))
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:
            return float("inf")
        dc = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(C, 9)
        # d_p = V^-1 (-g_p - sum_o W_o' d_c)
        Wd = torch.zeros((P, 3), dtype=F64, device=dev)
        Wd.index_add_(0, self.pi, torch.einsum("nij,ni->nj", W, dc[self.ci]))
        dp = torch.einsum("pij,pj->pi", Vinv, -gp - Wd)
        Jd = (torch.einsum("nrk,nk->nr", Jc, dc[self.ci])
              + torch.einsum("nrk,nk->nr", Jp, dp[self.pi]))
        linear = torch.sum(gc * dc) + torch.sum(gp * dp)
        decrease = -(linear + 0.5 * torch.sum(Jd * Jd))
        return float(decrease / cost)
