"""Carry solver state and modeling objects between the JAX package and the
port.

Both packages lay the live parameter blocks of a problem out in one flat
ambient vector, block after block in the order they were added, constant
blocks and blocks on a manifold included: the ambient layout does not depend
on either. A state vector from ``ceres_tpu`` (``Program.initial_ambient()``,
as numpy) loads into the port's problem with :func:`state_from_numpy`;
:func:`state_to_numpy` is the inverse. :func:`loss_from` and
:func:`manifold_from` rebuild a JAX-package loss or manifold as the port's,
from its class name and parameters (for the parity tests). No function here
imports the JAX package: the caller passes the other package's objects.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ceres_tpu_torch import loss as _loss
from ceres_tpu_torch import manifold as _manifold


def state_to_numpy(problem) -> np.ndarray:
    """The problem's parameter blocks as one flat f64 ambient vector."""
    return problem.state()


def state_from_numpy(
    problem,
    x_ambient: np.ndarray,
    ambient_offset: Optional[Mapping[int, int]] = None,
) -> None:
    """Load a flat ambient vector into the problem's parameter blocks.

    ``ambient_offset`` (pid -> offset, e.g. ``ceres_tpu``'s
    ``Program.ambient_offset``) is checked against the port's layout;
    a mismatch or a vector of the wrong length raises ValueError."""
    x = np.asarray(x_ambient, dtype=np.float64).reshape(-1)
    n = problem.num_parameters()
    if x.shape[0] != n:
        raise ValueError(f"state has {x.shape[0]} values, problem has {n}")
    if ambient_offset is not None and dict(ambient_offset) != problem.ambient_offsets():
        raise ValueError("the two packages lay out the parameter blocks differently")
    problem.write_back(x)


def loss_from(other):
    """The port's loss for a loss object of the JAX package (same class
    name, same parameters; ``FieldsOfExpertsLoss`` of the denoising model
    too); None stays None."""
    if other is None:
        return None
    name = type(other).__name__
    if name == "FieldsOfExpertsLoss":
        from ceres_tpu_torch.models.denoising import FieldsOfExpertsLoss

        return FieldsOfExpertsLoss(np.asarray(other.alpha))
    cls = getattr(_loss, name, None)
    if cls is None or not issubclass(cls, _loss.LossFunction):
        raise ValueError(f"no loss named {name} in ceres_tpu_torch.loss")
    if name in ("TrivialLoss",):
        return cls()
    if name == "TolerantLoss":
        return cls(np.asarray(other.a), np.asarray(other.b))
    if name == "ScaledLoss":
        return cls(loss_from(other.inner), np.asarray(other.a))
    if name == "ComposedLoss":
        return cls(loss_from(other.f), loss_from(other.g))
    if name == "LossFunctionWrapper":
        return cls(loss_from(other.inner))
    return cls(np.asarray(other.a))


def manifold_from(other, extra: Optional[Mapping[str, type]] = None):
    """The port's manifold for a manifold object of the JAX package (same
    class name, same sizes); None stays None. ``extra`` maps the names of
    manifold classes defined outside ``ceres_tpu_torch.manifold`` (a
    model's own) to the port's classes."""
    if other is None:
        return None
    name = type(other).__name__
    if extra and name in extra:
        return extra[name]()
    cls = getattr(_manifold, name, None)
    if cls is None or not issubclass(cls, _manifold.Manifold):
        raise ValueError(f"no manifold named {name} in ceres_tpu_torch.manifold")
    if name == "SubsetManifold":
        return cls(other.ambient_size, other.constant_indices)
    if name in ("QuaternionManifold", "EigenQuaternionManifold"):
        return cls()
    if name == "LineManifold":
        return cls(other.ambient_size // 2)
    if name == "ProductManifold":
        return cls(*(manifold_from(m, extra) for m in other.manifolds))
    return cls(other.ambient_size)  # Euclidean, Sphere
