"""ceres_tpu_torch: the PyTorch/CUDA port of ceres_tpu.

Nonlinear least squares on an NVIDIA H100 with the fused
Levenberg-Marquardt loop, or the host loop (DOGLEG, inner iterations,
gradient checks, bounds, callbacks), or the line-search minimizer (L-BFGS,
BFGS, nonlinear CG, steepest descent): robust loss functions, manifolds and
constant parameter blocks, solved with DENSE_QR, DENSE_NORMAL_CHOLESKY,
SPARSE_NORMAL_CHOLESKY, CGNR (IDENTITY, JACOBI, SUBSET), DENSE_SCHUR,
SPARSE_SCHUR or ITERATIVE_SCHUR (IDENTITY, JACOBI, SCHUR_JACOBI,
SCHUR_POWER_SERIES_EXPANSION, CLUSTER_JACOBI, CLUSTER_TRIDIAGONAL; on an
assembled reduced camera system up to 2048 camera coordinates, on the
implicit one above), with optional mixed-precision refinement and a user
elimination ordering (``OrderedGroups``); the sparse solvers factor on the
host through the native core (``native/ceres_tpu_core.cpp``, built with g++
at first use); and general minimization of f(x)
(``GradientProblem``, ``solve_gradient_problem``). The
JAX package's Pallas kernels are rewritten as CUDA kernels (``csrc/``): the
sorted segment sum (``ops/segment_sum.py``), the unsorted segment sum
(``ops/unsorted_segment_sum.py``) and the fused pair-outer segment sum
(``ops/outer_segment_sum.py``). Imports torch, never jax; ``ceres_tpu`` is
the reference the tests hold it to.

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal
    problem, _, _ = bal.build_problem(
        bal.synthesize_bal(seed=16), loss=ctt.loss.HuberLoss(1.0))
    summary = ctt.solve(bal.default_options(), problem)  # on the card
"""

from ceres_tpu_torch import cost_functions, loss, manifold, rotation
from ceres_tpu_torch.cost_functions import EvaluationCallback
from ceres_tpu_torch.fused_lm import fused_solve
from ceres_tpu_torch.gradient_problem import (
    GradientProblem,
    GradientProblemOptions,
    solve_gradient_problem,
)
from ceres_tpu_torch.loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from ceres_tpu_torch.manifold import (
    EigenQuaternionManifold,
    EuclideanManifold,
    LineManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)
from ceres_tpu_torch.ordered_groups import OrderedGroups
from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions, SolverSummary, solve
from ceres_tpu_torch.trust_region import IterationSummary
from ceres_tpu_torch.types import (
    CallbackReturnType,
    DoglegType,
    LinearSolverOrderingType,
    LinearSolverTerminationType,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    NonlinearConjugateGradientType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "ArctanLoss",
    "CallbackReturnType",
    "CauchyLoss",
    "ComposedLoss",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "EvaluationCallback",
    "GradientProblem",
    "GradientProblemOptions",
    "HuberLoss",
    "IterationSummary",
    "LineManifold",
    "LinearSolverOrderingType",
    "LinearSolverTerminationType",
    "LinearSolverType",
    "LineSearchDirectionType",
    "LineSearchInterpolationType",
    "LineSearchType",
    "LoggingType",
    "LossFunction",
    "LossFunctionWrapper",
    "Manifold",
    "MinimizerType",
    "NonlinearConjugateGradientType",
    "OrderedGroups",
    "PreconditionerType",
    "Problem",
    "ProductManifold",
    "QuaternionManifold",
    "ScaledLoss",
    "SoftLOneLoss",
    "SolverOptions",
    "SolverSummary",
    "SphereManifold",
    "SubsetManifold",
    "TerminationType",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "cost_functions",
    "fused_solve",
    "loss",
    "manifold",
    "rotation",
    "solve",
    "solve_gradient_problem",
]
