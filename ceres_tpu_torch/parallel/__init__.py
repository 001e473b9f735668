"""Sharding a solve over the ranks of a process group (port of
``ceres_tpu/parallel/``).

The reference's threading backend (``internal/ceres/thread_pool.h``,
``parallel_for.h:70-155``, ``context_impl.h``) fans residual blocks out to
CPU workers and guards every shared sum with locks. Here the residual
families' rows are shared out over the ranks of a ``torch.distributed``
process group, one process per rank, and every sum over rows the solve
takes (cost, gradient, J'J blocks, the reduced camera system or its
products) is finished by an explicit all-reduce.

The analog of ``Solver::Options::num_threads`` is ``SolverOptions.mesh``:
pass a mesh from :func:`make_mesh` on every rank and the solve shards.
"""

from ceres_tpu_torch.parallel.sharding import (
    bucket_program,
    make_mesh,
    make_mesh_2d,
    pad_family,
    replicate,
    shard_program,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "pad_family",
    "shard_program",
    "replicate",
]
