"""Carry solver state between the JAX package and the port.

Both packages lay the parameter blocks of a problem out in one flat ambient
vector, block after block in the order they were added. A state vector
from ``ceres_tpu`` (``Program.initial_ambient()``, as numpy) loads into the
port's problem with :func:`state_from_numpy`; :func:`state_to_numpy` is the
inverse. Neither function imports the JAX package: the caller passes the
other package's block offsets when it wants them checked.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


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
    sizes = problem.block_sizes()
    n = int(sizes.sum())
    ours = dict(enumerate((np.cumsum(sizes) - sizes).tolist()))
    if x.shape[0] != n:
        raise ValueError(f"state has {x.shape[0]} values, problem has {n}")
    if ambient_offset is not None and dict(ambient_offset) != ours:
        raise ValueError("the two packages lay out the parameter blocks differently")
    problem.write_back(x)
