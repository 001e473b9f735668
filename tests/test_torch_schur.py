"""Schur elimination parity: ceres_tpu_torch.linear.schur / schur_explicit
against ceres_tpu.linear.schur / schur_explicit, f64, rtol 1e-10.

Covers the e-block ordering (against ceres_tpu's native ordering), the
implicit product ``SchurOperator.s_times`` called directly (below nf=2048
no solve runs it), the explicit S, the reduced rhs, the SCHUR_JACOBI
blocks, back-substitution and solve_schur's step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.linear import schur as jschur
from ceres_tpu.linear.schur_explicit import assemble_reduced_system as jax_assemble
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _config_from_options as jax_config
from ceres_tpu.utils import native
from ceres_tpu_torch.evaluator import _full_impl
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.linear.schur_explicit import assemble_reduced_system, build_explicit_plan
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import _config_from_options

RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def both():
    inst = jbal.synthesize_bal(num_cameras=6, num_points=900, num_observations=3300,
                               noise=2.0, perturb=0.7, seed=9)
    jp = jbal.build_problem(inst)[0]
    jprog = jp.program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    x0 = np.asarray(jprog.initial_ambient())
    _, _, ctx_j = jax_full(jnp.asarray(x0), jprog.families, True,
                           jprog.num_tangent, jprog.jnp_bd_groups())
    _, _, ctx_t = _full_impl(torch.tensor(x0), tprog.families, tprog.num_tangent,
                             tprog.groups)
    ss_j = jschur.build_schur_structure(jprog, with_explicit=True)
    ss_t = tschur.build_schur_structure(tprog)
    ss_t.explicit = build_explicit_plan(tprog, ss_t)
    D = np.random.default_rng(1).uniform(0.5, 3.0, tprog.num_tangent)
    op_j = jschur.SchurOperator(ctx_j, jnp.asarray(D), ss_j)
    op_t = tschur.SchurOperator(ctx_t, torch.tensor(D), ss_t)
    opts = jbal.default_options(iterative=True)
    topts = tbal.default_options(iterative=True)
    return dict(jprog=jprog, tprog=tprog, ctx_j=ctx_j, ctx_t=ctx_t, ss_j=ss_j,
                ss_t=ss_t, D=D, op_j=op_j, op_t=op_t,
                cfg_j=jax_config(opts, jprog), cfg_t=_config_from_options(topts))


def test_ordering_matches_native(both):
    assert native.get_lib() is not None  # the JAX package's ordering is native here
    expect = jschur.compute_schur_ordering(both["jprog"])
    assert tschur.compute_schur_ordering(both["tprog"]) == expect
    assert np.array_equal(both["ss_t"].e_group.numpy(), np.asarray(both["ss_j"].e_group))
    assert np.array_equal(both["ss_t"].f_idx.numpy(), np.asarray(both["ss_j"].f_idx))
    assert both["ss_t"].e_slice == both["ss_j"].e_slice[0]


def test_s_times_implicit(both):
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = rng.standard_normal(both["tprog"].num_tangent)
        _close(both["op_t"].s_times(torch.tensor(x)), both["op_j"].s_times(jnp.asarray(x)))


def test_explicit_s_and_rhs(both):
    S_t = assemble_reduced_system(both["op_t"], both["ss_t"].explicit)
    S_j = jax_assemble(both["op_j"], both["ss_j"].explicit)
    _close(S_t, S_j)
    _close(both["op_t"].rhs(), both["op_j"].rhs())
    S_tr, rhs_tr, f_idx = both["op_t"].dense_reduced_system()
    _close(S_tr, S_j)
    _close(rhs_tr, np.asarray(both["op_j"].rhs())[np.asarray(both["ss_j"].f_idx)])


def test_explicit_s_equals_implicit_columns(both):
    """The one-pass S against S e_i probes of the port's own s_times."""
    op, ss = both["op_t"], both["ss_t"]
    S = assemble_reduced_system(op, ss.explicit)
    f_idx = ss.f_idx
    nt = both["tprog"].num_tangent
    for i in (0, 7, 30):
        e = torch.zeros(nt, dtype=torch.float64)
        e[f_idx[i]] = 1.0
        _close(S[:, i], op.s_times(e)[f_idx])


def test_schur_jacobi_blocks(both):
    S_t = assemble_reduced_system(both["op_t"], both["ss_t"].explicit)
    S_j = jax_assemble(both["op_j"], both["ss_j"].explicit)
    M_t = both["op_t"].schur_jacobi_preconditioner_from_dense(S_t)
    M_j = both["op_j"].schur_jacobi_preconditioner_from_dense(S_j)
    v = np.random.default_rng(6).standard_normal(both["tprog"].num_tangent)
    _close(M_t(torch.tensor(v)), M_j(jnp.asarray(v)))


def test_back_substitute(both):
    x = np.random.default_rng(7).standard_normal(both["tprog"].num_tangent)
    _close(both["op_t"].back_substitute(torch.tensor(x)),
           both["op_j"].back_substitute(jnp.asarray(x)))


def test_solve_schur_step(both):
    y_t, it_t, term_t = tschur.solve_schur(both["ctx_t"], torch.tensor(both["D"]),
                                           both["cfg_t"], both["ss_t"])
    y_j, it_j, term_j = jschur.solve_schur(both["ctx_j"], jnp.asarray(both["D"]),
                                           both["jprog"], both["cfg_j"], ss=both["ss_j"])
    assert int(it_t) == int(it_j) and int(term_t) == int(term_j)
    _close(y_t, y_j)


def test_other_solvers_are_roadmap_items(both):
    from ceres_tpu_torch.types import LinearSolverType, PreconditionerType

    for change in (dict(linear_solver_type=LinearSolverType.SPARSE_SCHUR),
                   dict(preconditioner_type=PreconditionerType.JACOBI)):
        cfg = dataclasses.replace(both["cfg_t"], **change)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tschur.solve_schur(both["ctx_t"], torch.tensor(both["D"]), cfg, both["ss_t"])
