"""ceres_tpu_torch: the PyTorch/CUDA port of ceres_tpu.

The fused Levenberg-Marquardt bundle-adjustment solve on an NVIDIA H100, on
an explicitly assembled reduced camera system: ITERATIVE_SCHUR with
SCHUR_JACOBI, and DENSE_SCHUR. The JAX package's Pallas kernels are
rewritten as CUDA kernels (``csrc/``): the sorted segment sum
(``ops/segment_sum.py``), the unsorted segment sum
(``ops/unsorted_segment_sum.py``) and the fused pair-outer segment sum
(``ops/outer_segment_sum.py``). Imports torch, never jax; ``ceres_tpu`` is
the reference the tests hold it to.

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal
    problem, _, _ = bal.build_problem(bal.synthesize_bal(seed=16))
    summary = ctt.fused_solve(bal.default_options(), problem)  # on the card
"""

from ceres_tpu_torch.fused_lm import fused_solve
from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions, SolverSummary, solve
from ceres_tpu_torch.types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "LinearSolverType",
    "MinimizerType",
    "PreconditionerType",
    "Problem",
    "SolverOptions",
    "SolverSummary",
    "TerminationType",
    "TrustRegionStrategyType",
    "fused_solve",
    "solve",
]
