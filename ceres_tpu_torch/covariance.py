"""Covariance of the parameters at a solution (port of
``ceres_tpu/covariance.py``, after ``include/ceres/covariance.h:247-470`` and
``internal/ceres/covariance_impl.cc``): blocks of inverse(J'J).

Three paths, chosen as the JAX package chooses them:

- **Schur marginals**, when the tangent space is large or every requested
  block is a camera of a problem with a Schur structure: the reduced camera
  system S = F'F - F'E (E'E)^-1 E'F is assembled on the card by the explicit
  plan (the segment-sum kernels), and inverted in float64 on the host;
- **matrix-free**, for a large tangent space otherwise: the requested columns
  of inverse(J'J) by Jacobi-preconditioned CG on the card, 8 columns at a
  time, each column stopping on its own test; on the card the 8-column
  solve is one CUDA graph, captured once per ``compute`` and replayed per
  chunk with one read of its results (``_ColumnSolves``);
- **DENSE_SVD** or the **SPARSE_QR** analog (one dense QR) of the dense
  Jacobian, in float64 numpy on the host.

Blocks come in tangent space, and lifted to ambient space through the
manifold's plus-Jacobian (covariance_impl.cc:129-277).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ceres_tpu_torch.linear.cg import CG_SUCCESS, conjugate_gradients_columns
from ceres_tpu_torch.types import CovarianceAlgorithmType
from ceres_tpu_torch.utils.cuda_graph import CapturedGraph, uncounted

# Above this tangent dimension the dense-J algorithms are infeasible and the
# scalable paths (Schur marginals, matrix-free CG) take over.
DENSE_COVARIANCE_MAX_TANGENT = 4096
# Columns of inverse(J'J) solved together on the matrix-free path.
COLUMNS_PER_SOLVE = 8


@dataclasses.dataclass
class CovarianceOptions:
    """Analog of Covariance::Options (covariance.h:247-360)."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.SPARSE_QR
    min_reciprocal_condition_number: float = 1e-14
    null_space_rank: int = 0
    apply_loss_function: bool = True

    def __post_init__(self):
        if isinstance(self.algorithm_type, str):
            self.algorithm_type = CovarianceAlgorithmType.from_string(self.algorithm_type)


class Covariance:
    """Analog of ceres::Covariance (covariance.h). After ``compute``,
    ``statistics`` holds the seconds of its parts (``jacobian_seconds``; on
    the Schur path ``structure_seconds``, ``assembly_seconds`` of S and
    ``inverse_seconds`` on the host) and, on the matrix-free path, the CG
    iterations of each column (``cg_iterations``), the seconds of the
    chunks' solves (``cg_seconds``) and of the CG's capture on the card
    (``graph_capture_seconds``)."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._reset()
        self._program = None
        self._problem = None

    def _reset(self) -> None:
        self._cov_tangent: Optional[np.ndarray] = None
        self._schur_cov: Optional[np.ndarray] = None
        self._schur_pos = None
        self._mf_Z: Optional[np.ndarray] = None  # matrix-free columns (n, k)
        self._mf_pos = None  # tangent coordinate -> column of _mf_Z
        self.statistics: dict = {}

    def compute(
        self,
        covariance_blocks: List[Tuple[int, int]],
        problem,
        device="cuda",
        evaluation_dtype=None,
    ) -> bool:
        """Compute the covariance of the requested block pairs at the
        problem's current values, on ``device`` (the card by default), in
        the program's evaluation dtype or ``evaluation_dtype``."""
        from ceres_tpu_torch.evaluator import Evaluator
        from ceres_tpu_torch.problem import cast_program

        self._reset()
        self._problem = problem
        program = problem.program(device)
        if evaluation_dtype is not None:
            cast_program(program, evaluation_dtype)
        self._program = program
        ev = Evaluator(program, apply_loss_function=self.options.apply_loss_function)
        x = torch.from_numpy(program.initial_ambient()).to(program.device, program.eval_dtype)
        t0 = _clock(program.device)
        full = ev.cost_gradient_jacobian(x)
        self.statistics["jacobian_seconds"] = _clock(program.device) - t0

        # A large problem, or only camera blocks of a Schur-structured one:
        # the exact marginal covariance of the f-blocks is S^-1.
        if program.num_tangent > DENSE_COVARIANCE_MAX_TANGENT or self._requested_schur(
            covariance_blocks, program
        ):
            ok = self._compute_schur_marginals(program, full)
            if ok is not None:
                return ok

        # Large and no Schur structure: the requested columns matrix-free
        # (the reference computes only the requested sparsity with sparse
        # QR, covariance_impl.cc:361,536-796).
        if (
            self.options.algorithm_type == CovarianceAlgorithmType.SPARSE_QR
            and covariance_blocks
            and program.num_tangent > DENSE_COVARIANCE_MAX_TANGENT
        ):
            ok = self._compute_matrix_free(covariance_blocks, program, full)
            if ok is not None:
                return ok

        J = full.jacobian_context.to_dense().to(torch.float64).cpu().numpy()
        opts = self.options
        if opts.algorithm_type == CovarianceAlgorithmType.DENSE_SVD:
            # covariance_impl.cc:705-760: invert the singular values above
            # the threshold, drop the null_space_rank smallest. Full
            # matrices, so that a wide or rank-deficient J shows its zero
            # singular values.
            _, s, vt = np.linalg.svd(J, full_matrices=True)
            n = vt.shape[0]
            if n == 0:
                return False
            s = np.concatenate([s, np.zeros(n - s.shape[0])])
            max_sv = s[0]
            eps = opts.min_reciprocal_condition_number
            inv_s2 = np.zeros_like(s)
            for i in range(n):
                if opts.null_space_rank < 0:
                    # -1: drop every singular value below the threshold.
                    keep = s[i] > np.sqrt(eps) * max_sv if max_sv > 0 else False
                    if not keep:
                        continue
                elif opts.null_space_rank == 0:
                    keep = s[i] > np.sqrt(eps) * max_sv if max_sv > 0 else False
                else:
                    keep = i < n - opts.null_space_rank
                if keep and s[i] > 0:
                    inv_s2[i] = 1.0 / (s[i] * s[i])
                elif opts.null_space_rank == 0 and s[i] <= np.sqrt(eps) * max_sv:
                    # Rank deficiency without null-space handling is an
                    # error in the reference.
                    return False
            self._cov_tangent = (vt.T * inv_s2) @ vt
            return True

        # SPARSE_QR analog: R of J, covariance = R^-1 R^-T.
        if J.shape[0] < J.shape[1]:
            # Underdetermined: J'J is singular (covariance_impl.cc:536-580).
            return False
        R = np.linalg.qr(J, mode="r")
        diag = np.abs(np.diag(R))
        if diag.size == 0 or np.min(diag) == 0.0:
            return False
        if np.min(diag) / np.max(diag) < opts.min_reciprocal_condition_number:
            return False
        Rinv = np.linalg.solve(R, np.eye(R.shape[0]))
        self._cov_tangent = Rinv @ Rinv.T
        return True

    @staticmethod
    def _tangent_offset(program, pid: int) -> Optional[int]:
        pid = int(pid)
        if not 0 <= pid < program.num_pids or not program.active[pid]:
            return None
        return int(program.tangent_offsets[pid])

    def _requested_schur(self, covariance_blocks, program) -> bool:
        """True when only non-eliminated (camera) blocks were requested of a
        problem that holds a Schur structure (``program.schur_structure``,
        left there by a Schur solve)."""
        ss = program.schur_structure
        if ss is None or not covariance_blocks:
            return False
        e_coords = set(ss.e_group.reshape(-1).tolist())
        for p1, p2 in covariance_blocks:
            for pid in (p1, p2):
                off = self._tangent_offset(program, pid)
                if off is None or off in e_coords:
                    return False
        return True

    def _compute_schur_marginals(self, program, full):
        """Camera-marginal covariance: the inverse of the damping-free
        S = F'F - F'E (E'E)^-1 E'F. True / False, or None for the dense
        path when the problem has no Schur structure."""
        from ceres_tpu_torch.linear.schur import (
            SchurOperator,
            build_schur_structure,
        )
        from ceres_tpu_torch.linear.schur_explicit import build_explicit_plan

        t0 = _clock(program.device)
        try:
            ss = program.schur_structure
            if ss is None:
                ss = build_schur_structure(program)
                program.schur_structure = ss
            if ss.explicit is None:
                ss.explicit = build_explicit_plan(program, ss)
        except ValueError:
            return None
        ctx = full.jacobian_context
        # 1e-150 is 0 in float32, as in the JAX package.
        tiny = torch.full((program.num_tangent,), 1e-150, dtype=ctx.dtype, device=program.device)
        t1 = _clock(program.device)
        S, _, f_idx = SchurOperator(ctx, tiny, ss).dense_reduced_system()
        S = S.to(torch.float64).cpu().numpy()
        t2 = time.perf_counter()
        self.statistics.update(structure_seconds=t1 - t0, assembly_seconds=t2 - t1)
        diag = np.abs(np.diag(S))
        if diag.size == 0 or np.min(diag) <= 0:
            return False
        try:
            # SPD gate: a gauge-deficient problem (BA's similarity freedom
            # not fixed) has a singular S, refused as the reference refuses
            # rank deficiency without null_space_rank.
            np.linalg.cholesky(S)
            if np.min(diag) / np.max(diag) < self.options.min_reciprocal_condition_number:
                return False
            S_inv = np.linalg.inv(S)
            # A numerically singular S shows in S S^-1 - I.
            err = np.linalg.norm(S @ S_inv - np.eye(S.shape[0]), ord=np.inf)
            if not np.isfinite(err) or err > 1e-4:
                return False
        except np.linalg.LinAlgError:
            return False
        self.statistics["inverse_seconds"] = time.perf_counter() - t2
        self._schur_cov = S_inv
        self._schur_pos = {int(c): i for i, c in enumerate(f_idx.cpu().numpy())}
        return True

    def _compute_matrix_free(self, covariance_blocks, program, full):
        """Columns of inverse(J'J) by Jacobi-preconditioned CG on J'J,
        without a dense J: O(nnz) memory. True / False."""
        ctx = full.jacobian_context
        n = program.num_tangent
        # The union of the coordinates of each pair's second block (the
        # columns of inverse(J'J) hold every row).
        cols, seen = [], set()
        for p1, p2 in covariance_blocks:
            s1, _ = self._tangent_slice(p1)
            s2, _ = self._tangent_slice(p2)
            if s1 is None or s2 is None:
                continue  # a constant block: zero covariance, no solve
            for c in range(s2.start, s2.stop):
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
        cols.sort()
        if not cols:
            self._mf_Z = np.zeros((n, 0))
            self._mf_pos = {}
            return True
        d = ctx.squared_column_norms().to(torch.float64).cpu().numpy()
        if not np.all(np.isfinite(d)) or np.any(d <= 0.0):
            # A zero column of J: J'J is singular (covariance_impl.cc:536).
            return False
        inv_d = torch.from_numpy(1.0 / d).to(program.device, ctx.dtype)[:, None]
        solves = _ColumnSolves(ctx, inv_d, cols, _captured(program.device))
        t0 = time.perf_counter()
        Z = np.zeros((n, len(cols)), dtype=np.float64)
        iterations = []
        for c in range(solves.num_chunks):
            chunk = cols[c * COLUMNS_PER_SOLVE : (c + 1) * COLUMNS_PER_SOLVE]
            x, its, terms = solves.solve(c)
            iterations.extend(its[: len(chunk)].tolist())
            if not np.all(terms[: len(chunk)] == CG_SUCCESS):
                # Breakdown, indefiniteness or no convergence: rank
                # deficiency, as the reference's QR failure.
                self.statistics["cg_iterations"] = iterations
                return False
            Z[:, c * COLUMNS_PER_SOLVE : c * COLUMNS_PER_SOLVE + len(chunk)] = x[:, : len(chunk)]
        self.statistics["cg_iterations"] = iterations
        self.statistics["cg_seconds"] = time.perf_counter() - t0
        self.statistics["graph_capture_seconds"] = solves.capture_seconds
        self._mf_Z = Z
        self._mf_pos = {c: i for i, c in enumerate(cols)}
        return True

    def _block_from_mf(self, s1, s2):
        pos = self._mf_pos
        i2 = [pos.get(c) for c in range(s2.start, s2.stop)]
        if all(i is not None for i in i2):
            return self._mf_Z[s1, :][:, i2].copy()
        # The transposed pair was requested.
        i1 = [pos.get(c) for c in range(s1.start, s1.stop)]
        if all(i is not None for i in i1):
            return self._mf_Z[s2, :][:, i1].T.copy()
        raise RuntimeError(
            "matrix-free covariance holds only block pairs passed to "
            "compute(); request this pair in covariance_blocks"
        )

    # -- block access --------------------------------------------------------

    def _tangent_slice(self, pid: int):
        """(tangent slice or None for a constant block, the block's chunk)."""
        chunk, _ = self._problem._locate(pid)
        off = self._tangent_offset(self._program, pid)
        if off is None:
            return None, chunk
        return slice(off, off + chunk.tangent_size), chunk

    def _block_from_schur(self, s1, s2):
        pos = self._schur_pos
        try:
            i1 = [pos[c] for c in range(s1.start, s1.stop)]
            i2 = [pos[c] for c in range(s2.start, s2.stop)]
        except KeyError:
            raise RuntimeError(
                "Schur-marginal covariance holds only non-eliminated "
                "(camera) blocks; request eliminated blocks with the "
                "dense algorithms"
            ) from None
        return self._schur_cov[np.ix_(i1, i2)].copy()

    def _computed(self) -> None:
        if self._cov_tangent is None and self._schur_cov is None and self._mf_Z is None:
            raise RuntimeError("call compute() first")

    def _tangent_block(self, s1, s2) -> np.ndarray:
        if self._cov_tangent is not None:
            return self._cov_tangent[s1, s2].copy()
        if self._schur_cov is not None:
            return self._block_from_schur(s1, s2)
        return self._block_from_mf(s1, s2)

    def get_covariance_block_in_tangent_space(self, pid1: int, pid2: int) -> np.ndarray:
        """covariance.h GetCovarianceBlockInTangentSpace."""
        self._computed()
        s1, c1 = self._tangent_slice(pid1)
        s2, c2 = self._tangent_slice(pid2)
        if s1 is None or s2 is None:
            return np.zeros((c1.tangent_size, c2.tangent_size))
        return self._tangent_block(s1, s2)

    def get_covariance_block(self, pid1: int, pid2: int) -> np.ndarray:
        """Ambient-space block J_plus C J_plus' (covariance_impl.cc:129)."""
        self._computed()
        s1, c1 = self._tangent_slice(pid1)
        s2, c2 = self._tangent_slice(pid2)
        if s1 is None or s2 is None:
            return np.zeros((c1.size, c2.size))
        C = self._tangent_block(s1, s2)

        def lift(pid, chunk):
            if chunk.manifold is None:
                return None
            x = torch.from_numpy(self._problem.parameter_block_value(pid))
            return chunk.manifold.plus_jacobian(x).to(torch.float64).numpy()

        J1, J2 = lift(pid1, c1), lift(pid2, c2)
        if J1 is not None:
            C = J1 @ C
        if J2 is not None:
            C = C @ J2.T
        return C


def _clock(device) -> float:
    """Host seconds once the device's queued work is done."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _captured(device: torch.device) -> bool:
    """Whether the matrix-free CG runs as a CUDA graph: on the card."""
    return device.type == "cuda"


class _ColumnSolves:
    """The matrix-free path's batched CG, COLUMNS_PER_SOLVE columns of
    inverse(J'J) a chunk, as the JAX package's jitted ``vmap`` of its CG:
    Jacobi-preconditioned, r_tolerance 1e-10, the residual refreshed every
    100 iterations, at most min(10 n, 20 000) iterations. The chunks' unit
    vectors come from a (chunks, K) device table of the columns (padded
    with n, a zero column, which is done at once), so that one solve reads
    its chunk from a static buffer. With ``captured`` (the card) the solve
    is captured once as a CUDA graph, its CG a WHILE node, and replayed per
    chunk; else it runs eagerly, one read per CG iteration. Either way
    :meth:`solve` then reads x, the counts and the terminations at once."""

    def __init__(self, ctx, inv_d: torch.Tensor, cols: List[int], captured: bool):
        n, K = ctx.num_tangent, COLUMNS_PER_SOLVE
        dev = inv_d.device
        self.num_chunks = -(-len(cols) // K)
        table = np.full((self.num_chunks, K), n, dtype=np.int64)
        table.reshape(-1)[: len(cols)] = cols
        self.table = torch.from_numpy(table).to(dev)
        self.ctx, self.inv_d, self.n = ctx, inv_d, n
        self.max_iters = int(min(10 * n, 20_000))
        self.chunk = self.table[0].clone()
        self.x = torch.zeros((n, K), dtype=ctx.dtype, device=dev)
        self.iterations = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.termination = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.graph = None
        self.capture_seconds = 0.0
        if captured:
            t0 = time.perf_counter()
            self.chunk.fill_(n)  # warm-up: zero columns, done before the loop
            with uncounted():
                self._solve()
            self.graph = CapturedGraph(self._solve, dev)
            self.capture_seconds = time.perf_counter() - t0

    def _solve(self) -> None:
        n = self.n
        # the chunk's unit vectors (a padding column n is zero)
        rows = torch.arange(n, device=self.x.device)
        E = (rows[:, None] == self.chunk[None, :]).to(self.x.dtype)
        inv_d = self.inv_d
        res = conjugate_gradients_columns(
            self.ctx.normal_matmat,
            E,
            preconditioner=lambda V: V * inv_d,
            max_num_iterations=self.max_iters,
            min_num_iterations=1,
            r_tolerance=1e-10,
            residual_reset_period=100,
        )
        self.x.copy_(res.x)
        self.iterations.copy_(res.num_iterations)
        self.termination.copy_(res.termination)

    def solve(self, c: int):
        """Chunk c: (x (n, K) float64, iterations (K,), terminations (K,)),
        numpy, in one read."""
        self.chunk.copy_(self.table[c])
        if self.graph is None:
            self._solve()
        else:
            self.graph.replay()
        host = torch.cat([self.x.to(torch.float64).reshape(-1),
                          self.iterations.to(torch.float64),
                          self.termination.to(torch.float64)]).cpu().numpy()
        K = COLUMNS_PER_SOLVE
        nk = self.n * K
        return (host[:nk].reshape(self.n, K), host[nk : nk + K].astype(np.int64),
                host[nk + K :].astype(np.int64))
