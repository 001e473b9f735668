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
(``GradientProblem``, ``solve_gradient_problem``); covariance at a solution
(``Covariance``: Schur marginals, matrix-free CG, dense SVD or QR); numeric
differentiation (``numeric_diff``); cubic interpolation of grids; a batched
dense LM for many small problems (``tiny_solve``); the flat C API
(``c_api``); and the NIST, libmv and denoising models. The
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
from ceres_tpu_torch.cost_functions import EvaluationCallback, analytic_cost
from ceres_tpu_torch.covariance import Covariance, CovarianceOptions
from ceres_tpu_torch.fused_lm import fused_solve
from ceres_tpu_torch.gradient_problem import (
    GradientProblem,
    GradientProblemOptions,
    solve_gradient_problem,
)
from ceres_tpu_torch.interpolation import (
    BiCubicInterpolator,
    CubicInterpolator,
    Grid1D,
    Grid2D,
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
from ceres_tpu_torch.numeric_diff import (
    NumericDiffOptions,
    numeric_diff,
    numeric_diff_jacobian,
)
from ceres_tpu_torch.ordered_groups import OrderedGroups
from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions, SolverSummary, solve
from ceres_tpu_torch.tiny_solver import TinySolver, tiny_solve
from ceres_tpu_torch.trust_region import IterationSummary
from ceres_tpu_torch.types import (
    CallbackReturnType,
    CovarianceAlgorithmType,
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
    NumericDiffMethodType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "ArctanLoss",
    "BiCubicInterpolator",
    "CallbackReturnType",
    "CauchyLoss",
    "ComposedLoss",
    "Covariance",
    "CovarianceAlgorithmType",
    "CovarianceOptions",
    "CubicInterpolator",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "EvaluationCallback",
    "GradientProblem",
    "GradientProblemOptions",
    "Grid1D",
    "Grid2D",
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
    "NumericDiffMethodType",
    "NumericDiffOptions",
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
    "TinySolver",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "analytic_cost",
    "cost_functions",
    "fused_solve",
    "loss",
    "manifold",
    "numeric_diff",
    "numeric_diff_jacobian",
    "rotation",
    "solve",
    "solve_gradient_problem",
    "tiny_solve",
]
