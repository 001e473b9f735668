"""Sparse direct factorization on the host (port of
``ceres_tpu/linear/sparse_cholesky.py``).

The counterpart of the reference's sparse direct stack:
``sparse_cholesky.h:71-112`` (factorize once, solve many), the CHOLMOD
wrapper ``suitesparse.h:306`` and the fill-reducing orderings of
``reorder_program.cc``. The card evaluates the block Jacobian; the normal
equations are factored on the host by the native core's simplicial
Cholesky (``utils/native.py``), whose symbolic analysis is kept per
sparsity pattern, so repeated LM iterations pay only the numeric
refactorization.

SPARSE_NORMAL_CHOLESKY solves (J'J + D^2) y = rhs exactly.
``dynamic_sparsity`` (solver.h:365-383) drops numerically zero Jacobian
entries and analyzes the pattern it then has.

Two kinds of caller: the host loop's SPARSE_NORMAL_CHOLESKY steps
(``trust_region._SparseNormalStep`` and DOGLEG's
``dogleg.SparseGaussNewton``), which assemble J'J from cells reduced on the
card (``inner_product.py``), and the fused loop's linear solve
(``ctt.fused_solve``, which runs it eagerly), which calls
:func:`solve_sparse_normal_cholesky`: the Jacobian goes to the host through
``evaluator.to_crs`` and is assembled there, what the JAX package computes
inside its graph through a host callback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ceres_tpu_torch.linear.cg import CG_FAILURE, CG_FATAL_ERROR, CG_SUCCESS
from ceres_tpu_torch.utils import native
from ceres_tpu_torch.utils.native import f32p, f64p, i32p, i64p


def nested_dissection_order(n: int, Ap: np.ndarray, Ai: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Nested-dissection elimination order (the NESDIS of reorder_program.cc):
    recursive bisection by BFS level-set separators, leaves in natural order.
    ``perm[k]`` is the column eliminated at step k (the parts first, their
    separator last, at every level)."""
    from scipy.sparse import csgraph

    if n == 0:
        return np.zeros(0, dtype=np.int32)
    U = sp.csc_matrix((np.ones(len(Ai), dtype=np.int8), Ai, Ap), shape=(n, n))
    A = ((U + U.T) > 0).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()

    # Explicit-stack recursion: a node set recurses; a ("sep", nodes) entry
    # emits a separator after both of its parts (pushed above it) are out.
    order: list = []
    stack: list = [np.arange(n, dtype=np.int64)]
    while stack:
        item = stack.pop()
        if isinstance(item, tuple):
            order.append(item[1])
            continue
        nodes = item
        if nodes.size == 0:
            continue
        if nodes.size <= leaf:
            order.append(nodes)
            continue
        S = A[nodes][:, nodes].tocsr()
        ncomp, labels = csgraph.connected_components(S, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                stack.append(nodes[labels == c])
            continue
        # pseudo-peripheral start: BFS from 0, restart from the farthest
        lvl = csgraph.breadth_first_order(S, 0, directed=False, return_predecessors=False)
        far = int(lvl[-1])
        dist = csgraph.shortest_path(S, method="BF", unweighted=True, indices=far)
        maxd = int(dist.max())
        if maxd < 2:
            order.append(nodes)  # near-clique: no useful separator
            continue
        mid = maxd // 2
        stack.append(("sep", nodes[dist == mid]))
        stack.append(nodes[dist > mid])
        stack.append(nodes[dist < mid])
    perm = np.concatenate(order) if order else np.zeros(0, np.int64)
    return perm.astype(np.int32)


def _etree_postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the elimination tree (CSparse's cs_post): children before
    parents, subtrees contiguous. ``parent[v]`` is v's parent, or outside
    [0, n) for a root."""
    n = len(parent)
    first_child = np.full(n, -1, dtype=np.int64)
    next_sib = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if 0 <= p < n:
            next_sib[v] = first_child[p]
            first_child[p] = v
    post = np.empty(n, dtype=np.int32)
    k = 0
    for root in range(n):
        if 0 <= parent[root] < n:
            continue
        stack = [root]  # iterative DFS emitting the postorder
        while stack:
            v = stack[-1]
            c = first_child[v]
            if c >= 0:
                first_child[v] = -1  # children consumed
                while c >= 0:
                    stack.append(int(c))
                    c = next_sib[c]
            else:
                post[k] = v
                k += 1
                stack.pop()
    if k != n:
        raise RuntimeError("elimination-tree postorder did not visit every node")
    return post


class SparseCholesky:
    """Simplicial LL' of a sparse SPD matrix with a fill-reducing ordering
    (sparse_cholesky.h:71-112).

    ``Ap`` / ``Ai`` are the UPPER-triangular CSC pattern (diagonal present,
    rows sorted). ``factorize(Ax)`` may be called again with new values on
    the same pattern. ``ordering``: AMD (the native core's minimum degree),
    NESDIS (:func:`nested_dissection_order`) or NATURAL;
    ``use_postordering`` post-orders the elimination tree
    (suitesparse.h). ``precision="single"`` factors in f32 (the
    RefinedSparseCholesky of sparse_cholesky.h:118, with
    :meth:`refined_solve`)."""

    def __init__(self, n: int, Ap: np.ndarray, Ai: np.ndarray, ordering: str = "AMD",
                 use_postordering: bool = False, precision: str = "double"):
        if precision not in ("double", "single"):
            raise ValueError(f"unknown precision {precision!r}")
        self._lib = native.get_lib()
        self._handle = None
        self.precision = precision
        self.n = int(n)
        self.Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self.Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        self.perm = np.empty(self.n, dtype=np.int32)
        if ordering == "AMD" and self.n > 0:
            if self._lib.mindeg_order(self.n, i64p(self.Ap), i32p(self.Ai), i32p(self.perm)) != 0:
                raise RuntimeError("mindeg_order failed")
        elif ordering == "NESDIS" and self.n > 0:
            self.perm = nested_dissection_order(self.n, self.Ap, self.Ai)
        else:  # NATURAL
            self.perm = np.arange(self.n, dtype=np.int32)
        self._build_symbolic()
        if use_postordering and self.n > 0:
            post = _etree_postorder(self.parent)
            if not np.array_equal(post, np.arange(self.n)):
                # step k now eliminates original column perm[post[k]]
                self._lib.sparse_chol_symbolic_free(self._handle)
                self._handle = None
                self.perm = self.perm[post]
                self._build_symbolic()
        self._factorized = False

    def _build_symbolic(self) -> None:
        self.parent = np.empty(self.n, dtype=np.int32)
        self.Lp = np.empty(self.n + 1, dtype=np.int64)
        # The native handle keeps the permuted pattern and the etree, so
        # factorize() is numeric only (cholmod_analyze / cholmod_factorize).
        self._handle = self._lib.sparse_chol_symbolic_new(
            self.n, i64p(self.Ap), i32p(self.Ai), i32p(self.perm), i32p(self.parent),
            i64p(self.Lp),
        )
        if not self._handle:
            raise RuntimeError("sparse_chol_symbolic_new failed")
        self.nnz_L = int(self._lib.sparse_chol_symbolic_nnz(self._handle))
        self.Li = np.empty(self.nnz_L, dtype=np.int32)
        self.Lx = np.empty(self.nnz_L, dtype=np.float64 if self.precision == "double"
                           else np.float32)
        self._factorized = False

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sparse_chol_symbolic_free(handle)
            self._handle = None

    def factorize(self, Ax: np.ndarray) -> int:
        """Numeric refactorization: 0 on success, k > 0 when the pivot of
        (permuted) column k-1 is not positive."""
        if self.precision == "single":
            Ax = np.ascontiguousarray(Ax, dtype=np.float32)
            rc = self._lib.sparse_chol_refactorize_f32(self._handle, f32p(Ax), i32p(self.Li),
                                                       f32p(self.Lx))
        else:
            Ax = np.ascontiguousarray(Ax, dtype=np.float64)
            rc = self._lib.sparse_chol_refactorize(self._handle, f64p(Ax), i32p(self.Li),
                                                   f64p(self.Lx))
        self._factorized = rc == 0
        return int(rc)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """A x = b for b of shape (n,) or (k, n); f64 out (a single-precision
        factor back-solves in f32: its result is a refinement correction)."""
        if not self._factorized:
            raise RuntimeError("factorize() has not succeeded")
        if self.precision == "single":
            b2 = np.ascontiguousarray(np.atleast_2d(np.asarray(b, dtype=np.float32)))
            x = np.empty_like(b2)
            self._lib.sparse_chol_solve_f32(self.n, i64p(self.Lp), i32p(self.Li), f32p(self.Lx),
                                            i32p(self.perm), b2.shape[0], f32p(b2), f32p(x))
            x = x.astype(np.float64)
        else:
            b2 = np.ascontiguousarray(np.atleast_2d(np.asarray(b, dtype=np.float64)))
            x = np.empty_like(b2)
            self._lib.sparse_chol_solve(self.n, i64p(self.Lp), i32p(self.Li), f64p(self.Lx),
                                        i32p(self.perm), b2.shape[0], f64p(b2), f64p(x))
        return x[0] if np.ndim(b) == 1 else x

    def refined_solve(self, H_upper, b: np.ndarray, num_refinement_iterations: int = 3):
        """Factor-precision solve with a fixed number of f64 iterative
        refinement steps (iterative_refiner.{h,cc}): x += A^-1 (b - A x),
        the residual from the f64 upper-CSC ``H_upper``."""
        b64 = np.asarray(b, dtype=np.float64)
        x = self.solve(b64)
        if num_refinement_iterations <= 0:
            return x
        Hfull = H_upper + sp.triu(H_upper, k=1, format="csc").T
        for _ in range(num_refinement_iterations):
            x = x + self.solve(b64 - Hfull @ x)
        return x


def cached_factor(chol_cache: dict, n: int, indptr: np.ndarray, indices: np.ndarray,
                  ordering: str = "AMD", use_postordering: bool = False,
                  single: bool = False) -> SparseCholesky:
    """The :class:`SparseCholesky` of this upper-CSC pattern kept in
    ``chol_cache`` per (ordering, postordering, precision): its symbolic
    analysis is made once and reused by every later factorization."""
    key = (ordering, use_postordering, single)
    chol = chol_cache.get(key)
    if chol is None:
        chol = chol_cache[key] = SparseCholesky(n, indptr, indices, ordering=ordering,
                                                use_postordering=use_postordering,
                                                precision="single" if single else "double")
    return chol


def factor_solve_csc(chol_cache: dict, n: int, indptr: np.ndarray, indices: np.ndarray,
                     data: np.ndarray, rhs: np.ndarray, ordering: str = "AMD",
                     use_postordering: bool = False, mixed_precision: bool = False,
                     num_refinement_iterations: int = 3) -> Tuple[np.ndarray, int]:
    """Factor and solve an assembled upper-CSC SPD system on the host.

    Keeps one :class:`SparseCholesky` per (ordering, postordering,
    precision) in ``chol_cache``. ``mixed_precision`` factors in f32 and
    refines in f64; a system the f32 factor cannot take (not positive
    definite at that precision) is solved by the f64 factor instead, so mixed
    precision never makes a solvable system fail. Returns (x f64,
    termination code of ``linear/cg.py``)."""
    chol = cached_factor(chol_cache, n, indptr, indices, ordering, use_postordering,
                         mixed_precision)
    rc = chol.factorize(data)
    if rc != 0 and mixed_precision:
        return factor_solve_csc(chol_cache, n, indptr, indices, data, rhs, ordering=ordering,
                                use_postordering=use_postordering, mixed_precision=False)
    if rc != 0:
        return np.zeros(n), int(CG_FAILURE)
    if mixed_precision:
        H = sp.csc_matrix((data, indices, indptr), shape=(n, n))
        x = chol.refined_solve(H, np.asarray(rhs, dtype=np.float64),
                               num_refinement_iterations=num_refinement_iterations)
    else:
        x = chol.solve(np.asarray(rhs, dtype=np.float64))
    if not np.all(np.isfinite(x)):
        return np.zeros(n), int(CG_FATAL_ERROR)
    return x, int(CG_SUCCESS)


# -- SPARSE_NORMAL_CHOLESKY with the Jacobian on the host -----------------------

# pattern -> {(ordering, postordering, precision): SparseCholesky}: the
# symbolic analysis is reused while the pattern of J'J stays the same (it
# changes every iteration only under dynamic sparsity). Keyed on the pattern's
# bytes, not a hash, so two patterns can never share an analysis.
_SYMBOLIC_CACHE: dict = {}
_CACHE_CAP = 32


def assemble_normal_equations(J, dynamic: bool, D: np.ndarray):
    """Upper triangle of J'J + diag(D^2) as sorted scipy CSC, from the
    Jacobian J as scipy CSR (``evaluator.to_crs``); ``dynamic`` drops its
    numerically zero entries first."""
    J = sp.csr_matrix(J, dtype=np.float64)
    if dynamic:
        J.eliminate_zeros()
    H = (J.T @ J).tocsc()
    H = (H + sp.diags(np.asarray(D, dtype=np.float64) ** 2)).tocsc()
    H = sp.triu(H, format="csc")
    H.sort_indices()
    return H


def host_sparse_normal_solve(J, dynamic: bool, D: np.ndarray, rhs: np.ndarray,
                             ordering: str = "AMD", use_postordering: bool = False,
                             mixed_precision: bool = False,
                             num_refinement_iterations: int = 3) -> Tuple[np.ndarray, int]:
    """Assemble, factor and solve (J'J + D^2) y = rhs on the host. Returns
    (y f64, termination code)."""
    H = assemble_normal_equations(J, dynamic, D)
    key = (H.shape[0], H.indptr.tobytes(), H.indices.tobytes())
    chol_cache = _SYMBOLIC_CACHE.get(key)
    if chol_cache is None:
        if len(_SYMBOLIC_CACHE) >= _CACHE_CAP:
            _SYMBOLIC_CACHE.clear()
        chol_cache = _SYMBOLIC_CACHE[key] = {}
    return factor_solve_csc(
        chol_cache, H.shape[0], H.indptr, H.indices, H.data, rhs, ordering=ordering,
        use_postordering=use_postordering, mixed_precision=mixed_precision,
        num_refinement_iterations=num_refinement_iterations,
    )


def solve_sparse_normal_cholesky(ctx, D: torch.Tensor, rhs: Optional[torch.Tensor] = None,
                                 dynamic: bool = False, ordering: str = "AMD",
                                 use_postordering: bool = False):
    """SPARSE_NORMAL_CHOLESKY for a caller holding (ctx, D): the Jacobian
    and the right-hand side (J'f when ``rhs`` is None) go to the host, the
    normal equations are factored there, and the step comes back to D's
    device in the right-hand side's dtype. Returns (y, linear iterations
    (1), termination), as ``trust_region._base_linear_solve``."""
    from ceres_tpu_torch.evaluator import to_crs

    b = ctx.gradient() if rhs is None else rhs
    y, term = host_sparse_normal_solve(
        to_crs(ctx), dynamic, D.detach().to(torch.float64).cpu().numpy(),
        b.detach().to(torch.float64).cpu().numpy(), ordering=ordering,
        use_postordering=use_postordering,
    )
    dev = D.device
    return (torch.from_numpy(y).to(dev, b.dtype), torch.ones((), dtype=torch.int32, device=dev),
            torch.full((), term, dtype=torch.int32, device=dev))
