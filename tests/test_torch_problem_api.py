"""The modeling API: ceres_tpu_torch.problem against ceres_tpu.problem on a
problem built call for call in both packages, with blocks added one by one
and in batches, constant blocks, a Subset and a quaternion manifold, losses
(shared and per-block), data as an array and as a tuple, and removals.

Index structures (layouts, groups, positions, families) must be equal;
``evaluate`` is held at rtol 1e-11 (float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.problem import plus_apply as jax_plus_apply
from ceres_tpu_torch.problem import plus_apply


def _res_pair(lib):
    """The same three residual functions in jnp and in torch."""
    if lib == "jax":
        cat, sin = jnp.concatenate, jnp.sin
    else:
        cat, sin = torch.cat, torch.sin

    def link(a, b, data):  # two 3-blocks, data (2,)
        return cat([a[:2] - b[:2] * data[0:1], sin(a[2:3]) * b[2:3] - data[1:2]])

    def rot(q, p, data):  # quaternion (4) + 3-block, data = (w (3,), s ())
        w, s = data
        v = q[1:] * p - w
        return cat([v, (q[0:1] * s.reshape(1)) - p[0:1]])

    def prior(a):  # one 5-block
        return a * a - 1.0

    return link, rot, prior


def _build(lib):
    mod = ct if lib == "jax" else ctt
    link, rot, prior = _res_pair(lib)
    rng = np.random.default_rng(77)
    p = mod.Problem()
    pts = p.add_parameter_blocks(rng.standard_normal((6, 3)))
    fixed = p.add_parameter_blocks(rng.standard_normal((2, 3)), constant=True)
    q_vals = rng.standard_normal((3, 4))
    q_vals /= np.linalg.norm(q_vals, axis=1, keepdims=True)
    qman = mod.QuaternionManifold()  # one object: a family's blocks share it
    quats = [p.add_parameter_block(q, manifold=qman) for q in q_vals]
    sub = p.add_parameter_block(rng.standard_normal(5), manifold=mod.SubsetManifold(5, [0, 4]))
    extra = p.add_parameter_block(rng.standard_normal(3))
    lonely = p.add_parameter_block(rng.standard_normal(3))  # removed below
    p.set_parameter_block_constant(int(pts[4]))
    p.set_parameter_block_constant(quats[2])

    a = np.array([0, 1, 2, 3, 4, 6, 7, 5])
    b = np.array([1, 2, 3, 6, 7, 7, 6, 0])
    all3 = np.concatenate([pts, fixed])
    rid_link = p.add_residual_blocks(
        link, mod.loss.HuberLoss(0.5), [all3[a], all3[b]], data=rng.standard_normal((8, 2))
    )
    qa = np.array([quats[0], quats[1], quats[2], quats[0], quats[2]])
    pa = np.array([pts[0], pts[5], fixed[0], extra, pts[4]])
    p.add_residual_blocks(
        rot, mod.loss.CauchyLoss(1.5), [qa, pa],
        data=(rng.standard_normal((5, 3)), rng.standard_normal(5)),
    )
    p.add_residual_block(prior, None, [sub])
    # one by one, same structure, different Huber scales: one family
    singles = [
        p.add_residual_block(link, mod.loss.HuberLoss(s), [int(pts[i]), int(pts[j])],
                             data=rng.standard_normal(2))
        for s, i, j in ((0.5, 0, 5), (2.0, 2, 4), (1.0, 3, 1))
    ]
    gone = p.add_residual_block(link, None, [lonely, int(pts[0])], data=np.zeros(2))
    p.remove_residual_block(int(rid_link[2]))
    p.remove_parameter_block(lonely)  # takes `gone` with it
    return p, dict(pts=pts, fixed=fixed, quats=quats, sub=sub, singles=singles, gone=gone)


@pytest.fixture(scope="module")
def both():
    jp, jids = _build("jax")
    tp, tids = _build("torch")
    return jp, tp, jp.program(), tp.program("cpu"), jids, tids


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_ids_counts_and_layouts(both):
    jp, tp, jprog, tprog, jids, tids = both
    for k in ("pts", "fixed", "quats", "sub", "singles", "gone"):
        assert np.array_equal(np.asarray(jids[k]), np.asarray(tids[k]))
    assert tp.num_parameter_blocks() == jp.num_parameter_blocks()
    assert tp.num_parameters() == jp.num_parameters()
    assert tp.num_residual_blocks() == jp.num_residual_blocks()
    assert tp.parameter_block_ids() == jp.parameter_block_ids()
    assert (tprog.num_ambient, tprog.num_tangent) == (jprog.num_ambient, jprog.num_tangent)
    assert tprog.num_tangent < tprog.num_ambient
    assert tprog.ambient_offset == jprog.ambient_offset
    for pid, off in jprog.tangent_offset.items():
        assert tprog.tangent_offsets[pid] == off and tprog.active[pid]
    assert int(tprog.active.sum()) == len(jprog.tangent_offset)
    assert np.array_equal(tprog.initial_ambient(), np.asarray(jprog.initial_ambient()))
    assert tprog.num_residuals() == jprog.num_residuals()
    assert tprog.num_residual_blocks() == jprog.num_residual_blocks()
    assert tprog.num_residuals_reduced() == jprog.num_residuals_reduced()
    assert tprog.num_active_parameter_blocks() == jprog.num_active_parameter_blocks()


def test_tangent_and_ambient_groups(both):
    _, _, jprog, tprog, _, _ = both
    assert list(tprog.bd_groups) == list(jprog.bd_groups)
    for T, tab in jprog.bd_groups.items():
        assert np.array_equal(tprog.bd_groups[T], tab)
        assert np.array_equal(_np(tprog.groups[T]), tab)
    assert list(tprog.amb_groups) == list(jprog.amb_groups)
    for A, tab in jprog.amb_groups.items():
        assert np.array_equal(tprog.amb_groups[A], tab)
        sl = jprog.amb_slice_of[A]
        assert tprog.ambient_groups.slice_of(A) == (None if sl is None else sl[:2])
    jg = jprog.jnp_bd_groups()
    for T in jprog.bd_groups:
        assert tprog.groups.slice_of(T) == jg.slice_of(T)


def test_plus_struct_and_plus(both):
    _, _, jprog, tprog, _, _ = both
    jps, tps = jprog.plus_struct, tprog.plus_struct
    assert np.array_equal(_np(tps.eu_amb), np.asarray(jps.eu_amb))
    assert np.array_equal(_np(tps.eu_tan), np.asarray(jps.eu_tan))
    assert tps.eu_identity == jps.eu_identity is False
    assert [type(m).__name__ for m in tps.manifolds] == [type(m).__name__ for m in jps.manifolds]
    for (ta, tt), (ja, jt) in zip(tps.groups, jps.groups):
        assert np.array_equal(_np(ta), np.asarray(ja)) and np.array_equal(_np(tt), np.asarray(jt))
    rng = np.random.default_rng(1)
    x = np.asarray(jprog.initial_ambient())
    for scale in (0.0, 0.3):
        d = scale * rng.standard_normal(jprog.num_tangent)
        ours = plus_apply(tps, torch.from_numpy(x), torch.from_numpy(d))
        ref = jax_plus_apply(jps, jnp.asarray(x), jnp.asarray(d))
        np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(_np(tprog.plus(torch.from_numpy(x), torch.from_numpy(d))),
                                   np.asarray(ref), rtol=1e-13, atol=1e-13)


def test_families_split_and_fixed_cost(both):
    """Same families in the same order (blocks added one by one first), the
    rows whose blocks are all constant split off, and their cost."""
    _, _, jprog, tprog, _, _ = both
    assert len(tprog.families) == len(jprog.families) >= 4
    assert len(tprog.fixed_families) == len(jprog.fixed_families) >= 2
    for tf, jf in zip(tprog.families + tprog.fixed_families,
                      jprog.families + jprog.fixed_families):
        assert tf.batch == jf.batch
        assert np.array_equal(tf.block_ids, np.asarray(jf.block_ids))
        assert np.array_equal(tf.residual_ids, np.asarray(jf.residual_ids))
        ts, js = tf.structure, jf.structure
        assert (ts.residual_size, ts.block_sizes, ts.tangent_sizes, ts.has_data) == (
            js.residual_size, js.block_sizes, js.tangent_sizes, js.has_data)
        assert [type(m).__name__ for m in ts.manifolds] == [type(m).__name__ for m in js.manifolds]
        for j in range(tf.num_args):
            assert np.array_equal(_np(tf.bd_pos[j]), np.asarray(jf.bd_pos[j]))
            assert np.array_equal(_np(tf.amb_pos[j]), np.asarray(jf.amb_pos[j]))
            assert tf.reduce_plans[j].num_groups == jf.reduce_plans[j].num_groups
    np.testing.assert_allclose(tprog.fixed_cost, jprog.fixed_cost, rtol=1e-12)
    assert tprog.fixed_cost > 0
    # the one-by-one Huber blocks carry per-instance scales
    stacked = [f for f in tprog.families if isinstance(getattr(f.loss, "a", None), torch.Tensor)]
    assert len(stacked) == 1 and stacked[0].loss.a.tolist() == [0.5, 2.0, 1.0]


@pytest.mark.parametrize("apply_loss", [True, False], ids=["loss", "no_loss"])
def test_evaluate_matches_jax(both, apply_loss):
    jp, tp, _, _, _, _ = both
    ej = jp.evaluate(residuals=True, gradient=True, jacobian=True, apply_loss_function=apply_loss)
    et = tp.evaluate(residuals=True, gradient=True, jacobian=True,
                     apply_loss_function=apply_loss, device="cpu")
    np.testing.assert_allclose(et["cost"], ej["cost"], rtol=1e-11)
    for key in ("residuals", "gradient", "jacobian"):
        assert et[key].shape == ej[key].shape
        np.testing.assert_allclose(et[key], ej[key], rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(et["jacobian_crs"].toarray(), ej["jacobian_crs"].toarray(),
                               rtol=1e-11, atol=1e-11)
    assert set(tp.evaluate(device="cpu")) == {"cost"}


def test_evaluate_residual_block_matches_jax(both):
    jp, tp, _, _, jids, _ = both
    for rid in (0, 9, 13, jids["singles"][1]):
        for al in (True, False):
            ej = jp.evaluate_residual_block(int(rid), apply_loss_function=al)
            et = tp.evaluate_residual_block(int(rid), apply_loss_function=al, device="cpu")
            np.testing.assert_allclose(et["cost"], ej["cost"], rtol=1e-12)
            np.testing.assert_allclose(et["residuals"], ej["residuals"], rtol=1e-12, atol=1e-14)
            for a, b in zip(et["jacobians"], ej["jacobians"]):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    for p in (jp, tp):
        with pytest.raises(KeyError):
            p.evaluate_residual_block(2)  # removed
        with pytest.raises(KeyError):
            p.evaluate_residual_block(int(jids["gone"]))


def test_block_accessors_bounds_and_errors():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((4, 3))
    jp, tp = ct.Problem(), ctt.Problem()
    for p, mod in ((jp, ct), (tp, ctt)):
        ids = p.add_parameter_blocks(vals)
        p.set_manifold(int(ids[1]), mod.SubsetManifold(3, [1]))
        p.set_parameter_block_constant(ids[2:])
        p.set_parameter_block_variable(int(ids[3]))
        p.set_parameter_lower_bound(int(ids[0]), 1, -2.0)
        p.set_parameter_upper_bound(int(ids[3]), 2, 5.0)
        p.set_parameter_block_value(int(ids[0]), np.array([1.0, 0.5, -1.0]))
    for pid in range(4):
        assert tp.is_parameter_block_constant(pid) == jp.is_parameter_block_constant(pid)
        assert type(tp.get_manifold(pid)).__name__ == type(jp.get_manifold(pid)).__name__
        assert np.array_equal(tp.parameter_block_value(pid), jp.parameter_block_value(pid))
        for i in range(3):
            assert tp.get_parameter_lower_bound(pid, i) == jp.get_parameter_lower_bound(pid, i)
            assert tp.get_parameter_upper_bound(pid, i) == jp.get_parameter_upper_bound(pid, i)
    tprog, jprog = tp.program("cpu"), jp.program()
    assert tprog.has_bounds and jprog.has_bounds
    assert np.array_equal(tprog.lower, np.asarray(jprog.lower))
    assert np.array_equal(tprog.upper, np.asarray(jprog.upper))
    assert tprog.is_feasible() and jprog.is_feasible()
    assert tprog.num_tangent == jprog.num_tangent == 8
    tp.set_parameter_block_value(0, np.array([1.0, -3.0, -1.0]))
    assert not tp.program("cpu").is_feasible()
    with pytest.raises(ValueError):
        tp.set_parameter_lower_bound(0, 7, 0.0)
    with pytest.raises(ValueError):
        tp.set_manifold(0, ctt.SubsetManifold(4, []))
    with pytest.raises(ValueError):
        tp.add_parameter_block(np.zeros(3), manifold=ctt.QuaternionManifold())
    with pytest.raises(KeyError):
        tp.parameter_block_value(99)
    with pytest.raises(ValueError):
        tp.add_residual_block(lambda a, b: a - b, None, [0, 0])
    with pytest.raises(ValueError, match="manifolds"):
        tp.add_residual_blocks(lambda a: a, None, [np.array([0, 1])])


def test_batched_setup_makes_no_object_per_block():
    """100 000 blocks, 300 000 residual blocks, one constant block: the
    program builds from arrays in well under the time one Python object per
    block would take."""
    import time

    rng = np.random.default_rng(0)
    p = ctt.Problem()
    a = p.add_parameter_blocks(rng.standard_normal((100_000, 3)))
    b = p.add_parameter_blocks(rng.standard_normal((50, 9)))
    p.set_parameter_block_constant(int(b[0]))
    p.add_residual_blocks(
        lambda x, y, d: x[:2] * y[:2] - d, ctt.HuberLoss(1.0),
        [np.repeat(a, 3), b[rng.integers(0, 50, 300_000)]],
        data=rng.standard_normal((300_000, 2)),
    )
    t0 = time.perf_counter()
    prog = p.program("cpu")
    seconds = time.perf_counter() - t0
    assert prog.num_tangent == 300_000 + 49 * 9
    assert len(p._chunks) == 2
    assert seconds < 10.0, seconds  # a loose bound: the machine is shared
