"""CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL in the port against ceres_tpu
(tests/test_cluster_tridiagonal.py's instance: 8 cameras / 60 points / 300
observations, seed 3): the camera clusters and their chains, the cluster
blocks (from probes of the implicit S in chunks, from the assembled S, and
the JAX package's vmapped probes: f64, rtol 1e-10), the chunked probes equal
to one chunk, both preconditioners' applications against JAX's and the
block-Thomas sweep against a dense solve, and solves with JAX's LM and CG
counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.evaluator import Evaluator as JaxEvaluator
from ceres_tpu.linear import schur as jschur
from ceres_tpu.models import bal as jbal
from ceres_tpu.trust_region import _build_solve_aux as jax_aux
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linear import schur as tschur
from ceres_tpu_torch.linear.schur_explicit import assemble_reduced_system
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.trust_region import _build_solve_aux

SIZES = dict(num_cameras=8, num_points=60, num_observations=300, seed=3)


def _close(a, b, rtol=1e-10):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()))


def _options(mod, pt, iterative=True):
    bm = jbal if mod is ct else tbal
    opts = bm.default_options(iterative=iterative)
    opts.preconditioner_type = mod.PreconditionerType[pt]
    return opts


@pytest.fixture(scope="module")
def both():
    """Both packages' structures with clusters and chains, contexts at the
    start, and Schur operators at a common damping."""
    inst = jbal.synthesize_bal(**SIZES)
    jprog = jbal.build_problem(inst)[0].program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    ss_j = jax_aux(_options(ct, "CLUSTER_TRIDIAGONAL"), jprog)["ss"]
    ss_t = _build_solve_aux(_options(ctt, "CLUSTER_TRIDIAGONAL"), tprog)["ss"]
    x = np.asarray(jprog.initial_ambient())
    ctx_j = JaxEvaluator(jprog).cost_gradient_jacobian(jnp.asarray(x)).jacobian_context
    ctx_t = Evaluator(tprog).cost_gradient_jacobian(torch.tensor(x)).jacobian_context
    D = np.random.default_rng(1).uniform(0.5, 3.0, tprog.num_tangent)
    return dict(jprog=jprog, tprog=tprog, ss_j=ss_j, ss_t=ss_t, ctx_t=ctx_t, D=D,
                op_j=jschur.SchurOperator(ctx_j, jnp.asarray(D), ss_j),
                op_t=tschur.SchurOperator(ctx_t, torch.tensor(D), ss_t))


def test_clusters_and_chains_equal_jax(both):
    ss_t, ss_j = both["ss_t"], both["ss_j"]
    assert np.array_equal(ss_t.cluster_groups.numpy(), np.asarray(ss_j.cluster_groups))
    assert np.array_equal(ss_t.chain_clusters.numpy(), np.asarray(ss_j.chain_clusters))
    C = ss_t.cluster_groups.shape[0]
    chains = ss_t.chain_clusters.numpy()
    assert sorted(chains[chains < C].tolist()) == list(range(C))  # each cluster once
    assert (chains[:, 1:] < C).any()  # a chain with a link


def test_cluster_blocks_equal_jax_probes(both):
    """[c, a, b] = S[coords_b, coords_a]: the JAX package's vmapped probes
    S e_i, from the port's chunked probes and from the assembled S."""
    op_j, op_t, ss_t = both["op_j"], both["op_t"], both["ss_t"]
    groups = ss_t.cluster_groups
    n = both["tprog"].num_tangent
    cols = jnp.stack([op_j.s_times(jnp.zeros((n,)).at[i].set(1.0)) for i in range(n)])
    cols = jnp.concatenate([cols, jnp.zeros((1, n))])  # the padding coordinate
    g = np.asarray(groups)
    dummy = g >= n
    want = np.stack([np.asarray(cols)[g[c]][:, np.minimum(g[c], n - 1)] for c in range(len(g))])
    want = np.where(dummy[:, :, None] | dummy[:, None, :], np.eye(g.shape[1]), want)
    probed = op_t.cluster_blocks(groups, chunk=5)
    _close(probed, want)
    ss_t.explicit = ss_t.explicit or tschur.build_explicit_plan(both["tprog"], ss_t)
    S = assemble_reduced_system(op_t, ss_t.explicit)
    _close(op_t.cluster_blocks(groups, S=0.5 * (S + S.T)), want)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_probes_equal_one_chunk(both, chunk):
    op_t, ss_t = both["op_t"], both["ss_t"]
    groups = ss_t.cluster_groups
    whole = op_t.cluster_blocks(groups, chunk=groups.numel())
    _close(op_t.cluster_blocks(groups, chunk=chunk), whole, rtol=1e-13)
    # the default chunk follows PROBE_CHUNK_BYTES
    _close(op_t.cluster_blocks(groups), whole, rtol=1e-13)


@pytest.mark.parametrize("pt", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_preconditioner_applications_equal_jax(both, pt):
    op_j, op_t, ss_t, ss_j = both["op_j"], both["op_t"], both["ss_t"], both["ss_j"]
    if pt == "CLUSTER_JACOBI":
        mj = op_j.clustered_preconditioner(ss_j.cluster_groups)
        mt = op_t.clustered_preconditioner(ss_t.cluster_groups)
    else:
        mj = op_j.cluster_tridiagonal_preconditioner(ss_j.cluster_groups, ss_j.chain_clusters)
        mt = op_t.cluster_tridiagonal_preconditioner(ss_t.cluster_groups, ss_t.chain_clusters)
    rng = np.random.default_rng(2)
    f_mask = ss_t.f_mask.numpy()
    for _ in range(3):
        v = rng.standard_normal(f_mask.shape[0]) * f_mask
        _close(mt(torch.tensor(v)), mj(jnp.asarray(v)), rtol=1e-9)


def test_block_thomas_matches_a_dense_tridiagonal_solve(both):
    """With strong damping the tridiagonal part of S is SPD, no guard fires,
    and the sweep equals a dense solve against that part."""
    ss, ctx = both["ss_t"], both["ctx_t"]
    n = ctx.num_tangent
    groups, chains = ss.cluster_groups.numpy(), ss.chain_clusters.numpy()
    C = groups.shape[0]
    f = np.nonzero(ss.f_mask.numpy() > 0)[0]
    op = tschur.SchurOperator(ctx, torch.full((n,), 10.0, dtype=torch.float64), ss)
    S = op.s_columns(torch.arange(n)).numpy().T  # rows: S e_i
    M = np.zeros((n, n))
    real = [g[g < n] for g in groups]
    for c in range(C):
        M[np.ix_(real[c], real[c])] = S[np.ix_(real[c], real[c])]
    for chain in chains:
        ids = chain[chain < C]
        for a, b in zip(ids[:-1], ids[1:]):
            M[np.ix_(real[a], real[b])] = S[np.ix_(real[a], real[b])]
            M[np.ix_(real[b], real[a])] = S[np.ix_(real[b], real[a])]
    assert np.linalg.eigvalsh(M[np.ix_(f, f)]).min() > 1e-8
    v = np.random.default_rng(0).standard_normal(n) * ss.f_mask.numpy()
    got = op.cluster_tridiagonal_preconditioner(ss.cluster_groups, ss.chain_clusters)(
        torch.tensor(v)).numpy()
    expect = np.zeros(n)
    expect[f] = np.linalg.solve(M[np.ix_(f, f)], v[f])
    np.testing.assert_allclose(got, expect, rtol=1e-7, atol=1e-8)
    # weakly damped: the guarded factorization stays finite and SPD
    weak = tschur.SchurOperator(ctx, torch.full((n,), 1e-2, dtype=torch.float64), ss)
    apply = weak.cluster_tridiagonal_preconditioner(ss.cluster_groups, ss.chain_clusters)
    out = apply(torch.tensor(v)).numpy()
    assert np.all(np.isfinite(out)) and float(v @ out) > 0.0


@pytest.mark.parametrize("pt", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_solve_matches_jax_lm_and_cg_counts(pt):
    """A BAL solve under each preconditioner: JAX's records, CG iterations
    per record and costs (f64, rtol 1e-10); nf = 72 assembles S, so the
    blocks come from S where JAX probes the implicit S."""
    out = []
    for mod in (ct, ctt):
        bm = jbal if mod is ct else tbal
        p = bm.build_problem(bm.synthesize_bal(**SIZES))[0]
        opts = _options(mod, pt)
        opts.max_num_iterations = 40
        out.append(mod.solve(opts, p, device="cpu") if mod is ctt else mod.solve(opts, p))
    sj, st = out
    assert st.preconditioner_type_used == ctt.PreconditionerType[pt]
    assert len(st.iterations) == len(sj.iterations) > 3
    assert [r.linear_solver_iterations for r in st.iterations] == [
        r.linear_solver_iterations for r in sj.iterations]
    for a, b in zip(st.iterations, sj.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_implicit_s_solve_uses_the_probes(monkeypatch):
    """Above nf = EXPLICIT_S_AUTO_MAX_NF no S is assembled and the blocks
    come from probes: with the threshold lowered to 0 the solve takes that
    branch and still gives JAX's records (which probe the implicit S too)."""
    calls = []
    real = tschur.SchurOperator.probe
    monkeypatch.setattr(tschur.SchurOperator, "probe",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    monkeypatch.setattr(tschur, "EXPLICIT_S_AUTO_MAX_NF", 0)
    import ceres_tpu_torch.trust_region as ttr

    monkeypatch.setattr(ttr, "EXPLICIT_S_AUTO_MAX_NF", 0)
    p = tbal.build_problem(tbal.synthesize_bal(**SIZES))[0]
    opts = _options(ctt, "CLUSTER_JACOBI")
    opts.max_num_iterations = 40
    st = ctt.solve(opts, p, device="cpu")
    jp = jbal.build_problem(jbal.synthesize_bal(**SIZES))[0]
    jopts = _options(ct, "CLUSTER_JACOBI")
    jopts.max_num_iterations = 40
    sj = ct.solve(jopts, jp)
    assert calls and len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(st.final_cost, sj.final_cost, rtol=1e-10)
