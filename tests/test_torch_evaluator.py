"""Evaluator parity: ceres_tpu_torch.evaluator against ceres_tpu.evaluator
on one small BAL instance (f64, rtol 1e-10; f32, rtol 1e-4).

Covers cost, gradient, every Jacobian block, squared_column_norms, matvec
and rmatvec (with and without the Schur e-arg skipped), scale_columns and
the cost-only evaluation; then (second half) the same on a problem with
Huber and Cauchy losses, quaternion and Subset blocks and constant blocks:
corrected Jacobian blocks and residuals, to_dense, block_jtj, normal_matvec,
tangent_idx and the manifold plus_apply (f64 1e-10, f32 2e-4); the
Evaluator class; and (last part) the reverse mode's fixed-order gather
(``evaluator._RowGather`` over ``ops/reduce.build_gather_plan``): the
gradient of ``_cost_grad_impl`` against JAX's (f64 1e-12, f32 2e-4) and
against autograd's own backward of the index (f64 1e-13) on problems with
constant blocks, manifolds, padding rows and blocks shared by many rows;
each gather-plan kind's backward against the index's; and the plan rule,
which never gives a card ``scatter``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.evaluator import _cost_grad_impl as jax_cost_grad
from ceres_tpu.evaluator import _cost_impl as jax_cost
from ceres_tpu.evaluator import _full_impl as jax_full
from ceres_tpu.models import bal as jbal
from ceres_tpu.problem import PlusStructure as JaxPlusStructure
from ceres_tpu.problem import cast_program as jax_cast
from ceres_tpu.problem import plus_apply as jax_plus_apply
from ceres_tpu_torch import evaluator as tev
from ceres_tpu_torch.evaluator import _cost_grad_impl, _cost_impl, _full_impl
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops.reduce import build_gather_plan, choose_gather_plan_kind
from ceres_tpu_torch.problem import PlusStructure, cast_program, plus_apply

SIZES = dict(num_cameras=6, num_points=700, num_observations=2600, noise=2.0, perturb=0.7)


def _close(a, b, rtol):
    """Elementwise rtol, with an absolute floor of rtol x the array scale
    (entries that cancel to ~0 carry the rounding of their terms)."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module", params=[("float64", 1e-10), ("float32", 1e-4)],
                ids=["f64", "f32"])
def both(request):
    dtype, rtol = request.param
    inst = jbal.synthesize_bal(**SIZES, seed=5)
    jprog = jbal.build_problem(inst)[0].program()
    tprog = tbal.build_problem(inst)[0].program("cpu")
    jax_cast(jprog, dtype)
    cast_program(tprog, dtype)
    x0 = np.asarray(jprog.initial_ambient())
    xj = jnp.asarray(x0, dtype)
    xt = torch.tensor(x0, dtype=getattr(torch, dtype))
    j = jax_full(xj, jprog.families, True, jprog.num_tangent, jprog.jnp_bd_groups())
    t = _full_impl(xt, tprog.families, tprog.num_tangent, tprog.groups)
    return dict(j=j, t=t, jprog=jprog, tprog=tprog, xj=xj, xt=xt, rtol=rtol,
                dtype=getattr(torch, dtype))


def test_cost_and_gradient(both):
    (cj, gj, _), (ct_, gt, _) = both["j"], both["t"]
    assert ct_.dtype == torch.float64  # cost sums in f64 in both dtypes
    _close(ct_, cj, both["rtol"])
    assert gt.dtype == both["dtype"]
    _close(gt, gj, both["rtol"])


def test_every_jacobian_block_and_residual(both):
    ctx_j, ctx_t = both["j"][2], both["t"][2]
    _close(ctx_t.residuals[0], ctx_j.residuals[0], both["rtol"])
    for Jt, Jj in zip(ctx_t.jacs[0], ctx_j.jacs[0]):
        _close(Jt, Jj, both["rtol"])


def test_squared_column_norms(both):
    _close(both["t"][2].squared_column_norms(), both["j"][2].squared_column_norms(),
           both["rtol"])


@pytest.mark.parametrize("skip", [None, (1,)], ids=["full", "skip_points"])
def test_matvec_and_rmatvec(both, skip):
    ctx_j, ctx_t = both["j"][2], both["t"][2]
    rng = np.random.default_rng(11)
    v = rng.standard_normal(ctx_t.num_tangent)
    w = rng.standard_normal(tuple(ctx_t.residuals[0].shape))
    dt = both["dtype"]
    mv_t = ctx_t.matvec(torch.tensor(v, dtype=dt), skip=skip)
    mv_j = ctx_j.matvec(jnp.asarray(v, ctx_j.dtype), skip=skip)
    _close(mv_t[0], mv_j[0], both["rtol"])
    rv_t = ctx_t.rmatvec((torch.tensor(w, dtype=dt),), skip=skip)
    rv_j = ctx_j.rmatvec((jnp.asarray(w, ctx_j.dtype),), skip=skip)
    _close(rv_t, rv_j, both["rtol"])


def test_scale_columns(both):
    ctx_j, ctx_t = both["j"][2], both["t"][2]
    s = np.random.default_rng(2).uniform(0.5, 2.0, ctx_t.num_tangent)
    sj = ctx_j.scale_columns(jnp.asarray(s, ctx_j.dtype))
    st = ctx_t.scale_columns(torch.tensor(s, dtype=both["dtype"]))
    for Jt, Jj in zip(st.jacs[0], sj.jacs[0]):
        _close(Jt, Jj, both["rtol"])


def test_cost_only_evaluation(both):
    cj = jax_cost(both["xj"], both["jprog"].families, True)
    ct_ = _cost_impl(both["xt"], both["tprog"].families)
    assert ct_.dtype == torch.float64
    _close(ct_, cj, both["rtol"])


@pytest.mark.parametrize("identity", [True, False], ids=["identity", "indexed"])
def test_plus_apply(identity):
    """Both forms of the Euclidean plus against the JAX package's: the
    identity fast path, and the indexed path with a permuted layout."""
    rng = np.random.default_rng(3)
    n = 12
    x, delta = rng.standard_normal(n), rng.standard_normal(n)
    amb = np.arange(n) if identity else rng.permutation(n)
    tan = np.arange(n)
    ours = plus_apply(
        PlusStructure(torch.from_numpy(amb), torch.from_numpy(tan), identity),
        torch.tensor(x), torch.tensor(delta),
    )
    ref = jax_plus_apply(
        JaxPlusStructure(jnp.asarray(amb, jnp.int32), jnp.asarray(tan, jnp.int32),
                         (), (), identity),
        jnp.asarray(x), jnp.asarray(delta),
    )
    _close(ours, ref, 1e-15)


# -- loss, manifolds, constant blocks ---------------------------------------


@pytest.fixture(scope="module", params=[("float64", 1e-10), ("float32", 2e-4)],
                ids=["f64", "f32"])
def modeled(request):
    """The mixed problem of test_torch_problem_api (Huber and Cauchy losses,
    quaternion and Subset blocks, constant blocks) evaluated by both."""
    from test_torch_problem_api import _build

    dtype, rtol = request.param
    jprog = _build("jax")[0].program()
    tprog = _build("torch")[0].program("cpu")
    jax_cast(jprog, dtype)
    cast_program(tprog, dtype)
    x0 = np.asarray(jprog.initial_ambient())
    xj, xt = jnp.asarray(x0, dtype), torch.tensor(x0, dtype=getattr(torch, dtype))
    j = jax_full(xj, jprog.families, True, jprog.num_tangent, jprog.jnp_bd_groups())
    t = _full_impl(xt, tprog.families, tprog.num_tangent, tprog.groups)
    return dict(j=j, t=t, jprog=jprog, tprog=tprog, xj=xj, xt=xt, rtol=rtol,
                dtype=getattr(torch, dtype))


def test_corrected_cost_gradient_blocks(modeled):
    (cj, gj, ctx_j), (ct_, gt, ctx_t) = modeled["j"], modeled["t"]
    rtol = modeled["rtol"]
    assert ct_.dtype == torch.float64 and gt.dtype == modeled["dtype"]
    _close(ct_, cj, rtol)
    _close(gt, gj, rtol)
    assert len(ctx_t.jacs) == len(ctx_j.jacs)
    for fi in range(len(ctx_j.jacs)):
        _close(ctx_t.residuals[fi], ctx_j.residuals[fi], rtol)
        for Jt, Jj in zip(ctx_t.jacs[fi], ctx_j.jacs[fi]):
            assert Jt.dtype == modeled["dtype"]
            _close(Jt, Jj, rtol)
    _close(ctx_t.squared_column_norms(), ctx_j.squared_column_norms(), rtol)
    _close(_cost_impl(modeled["xt"], modeled["tprog"].families),
           jax_cost(modeled["xj"], modeled["jprog"].families, True), rtol)
    _close(_cost_impl(modeled["xt"], modeled["tprog"].families, False),
           jax_cost(modeled["xj"], modeled["jprog"].families, False), rtol)


def test_to_dense_block_jtj_normal_matvec(modeled):
    ctx_j, ctx_t = modeled["j"][2], modeled["t"][2]
    rtol, dt = modeled["rtol"], modeled["dtype"]
    _close(ctx_t.to_dense(), ctx_j.to_dense(), rtol)
    assert ctx_t.num_rows == ctx_j.num_rows
    _close(ctx_t.residual_vector(), ctx_j.residual_vector(), rtol)
    sizes = {T: tab.shape[0] for T, tab in modeled["jprog"].bd_groups.items()}
    bj, bt = ctx_j.block_jtj(sizes), ctx_t.block_jtj(sizes)
    assert set(bt) == set(bj)
    for T in bj:
        _close(bt[T], bj[T], rtol)
    v = np.random.default_rng(4).standard_normal(ctx_t.num_tangent)
    _close(ctx_t.normal_matvec(torch.tensor(v, dtype=dt)),
           ctx_j.normal_matvec(jnp.asarray(v, ctx_j.dtype)), rtol)
    # a constant block's columns are nowhere: J v ignores it, J' w drops it
    dense = ctx_t.to_dense().to(torch.float64)
    mv = torch.cat([m.reshape(-1) for m in ctx_t.matvec(torch.tensor(v, dtype=dt))])
    _close(mv, dense.numpy() @ v, max(rtol, 1e-5 if dt == torch.float32 else 0))
    for fi, fam in enumerate(ctx_t.families):
        for j in range(fam.num_args):
            _close(ctx_t.tangent_idx(fi, j), np.asarray(ctx_j.families[fi].tangent_idx[j]), 0)


def test_scaled_context_with_constant_blocks(modeled):
    ctx_j, ctx_t = modeled["j"][2], modeled["t"][2]
    s = np.random.default_rng(2).uniform(0.5, 2.0, ctx_t.num_tangent)
    sj = ctx_j.scale_columns(jnp.asarray(s, ctx_j.dtype))
    st = ctx_t.scale_columns(torch.tensor(s, dtype=modeled["dtype"]))
    for fi in range(len(sj.jacs)):
        for Jt, Jj in zip(st.jacs[fi], sj.jacs[fi]):
            _close(Jt, Jj, modeled["rtol"])
    _close(st.gradient(), sj.gradient(), modeled["rtol"])


def test_manifold_plus_apply_matches_jax():
    """plus_apply with manifold groups (quaternion blocks) against JAX's."""
    from test_torch_problem_api import _build

    jprog = _build("jax")[0].program()
    tprog = _build("torch")[0].program("cpu")
    x = np.asarray(jprog.initial_ambient())
    d = 0.2 * np.random.default_rng(6).standard_normal(jprog.num_tangent)
    ours = plus_apply(tprog.plus_struct, torch.from_numpy(x), torch.from_numpy(d))
    ref = jax_plus_apply(jprog.plus_struct, jnp.asarray(x), jnp.asarray(d))
    _close(ours, ref, 1e-13)
    f32 = plus_apply(tprog.plus_struct, torch.tensor(x, dtype=torch.float32), torch.from_numpy(d))
    assert f32.dtype == torch.float32


# -- the Evaluator class -----------------------------------------------------


def _evaluator_case(case):
    """(JAX problem, port problem) for the small robust BAL or a small pose
    graph (quaternion blocks on the Eigen-quaternion manifold)."""
    import ceres_tpu as ct
    import ceres_tpu_torch as ctt

    if case == "robust_bal":
        inst = jbal.synthesize_bal(num_cameras=8, num_points=500, num_observations=2000, seed=42)
        return (jbal.build_problem(inst, loss=ct.loss.HuberLoss(1.0))[0],
                tbal.build_problem(inst, loss=ctt.loss.HuberLoss(1.0))[0])
    from ceres_tpu.models import pose_graph as jpg
    from ceres_tpu_torch.models import pose_graph as tpg

    graph = tpg.synthesize_sphere(40, seed=1)[:3]  # one loop closure: cost > 0
    return jpg.build_problem_3d(*graph)[0], tpg.build_problem_3d(*graph)[0]


@pytest.fixture(scope="module",
                params=[(c, d) for c in ("robust_bal", "pose_graph") for d in ("float64", "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def evaluators(request):
    from ceres_tpu.evaluator import Evaluator as JaxEvaluator
    from ceres_tpu_torch.evaluator import Evaluator

    case, dtype = request.param
    jp, tp = _evaluator_case(case)
    jprog, tprog = jp.program(), tp.program("cpu")
    jax_cast(jprog, dtype)
    cast_program(tprog, dtype)
    x0 = np.asarray(jprog.initial_ambient())
    return dict(
        j=JaxEvaluator(jprog), t=Evaluator(tprog), jprog=jprog, tprog=tprog,
        xj=jnp.asarray(x0, dtype), xt=torch.tensor(x0, dtype=getattr(torch, dtype)),
        dtype=getattr(torch, dtype), rtol=1e-10 if dtype == "float64" else 2e-4,
    )


def test_evaluator_methods_match_jax(evaluators):
    e = evaluators
    ej, et, xj, xt, rtol = e["j"], e["t"], e["xj"], e["xt"], e["rtol"]
    _close(et.cost(xt), ej.cost(xj), rtol)
    r = et.residuals(xt)
    assert r.dtype == e["dtype"]
    _close(r, ej.residuals(xj), rtol)
    full_t, full_j = et.cost_gradient_jacobian(xt), ej.cost_gradient_jacobian(xj)
    _close(full_t.cost, full_j.cost, rtol)
    _close(full_t.gradient, full_j.gradient, rtol)
    for fi in range(len(full_j.jacobian_context.jacs)):
        _close(full_t.jacobian_context.residuals[fi], full_j.jacobian_context.residuals[fi], rtol)
    d = 0.01 * np.random.default_rng(8).standard_normal(e["tprog"].num_tangent)
    _close(et.plus(xt, torch.tensor(d, dtype=e["dtype"])), ej.plus(xj, jnp.asarray(d, xj.dtype)),
           rtol)
    assert et.statistics().calls == ej.statistics().calls == {
        "Evaluator::Residual": 2, "Evaluator::Jacobian": 1,
    }


def test_cost_and_gradient_by_reverse_mode(evaluators):
    """cost_and_gradient (autograd of cost(plus(x, delta)) at delta = 0)
    against the full evaluation's gradient J'r and JAX's _cost_grad_impl;
    the gradient comes out in the evaluation dtype, also under no_grad."""
    e = evaluators
    ej, et, xj, xt, rtol = e["j"], e["t"], e["xj"], e["xt"], e["rtol"]
    with torch.no_grad():
        cost, grad = et.cost_and_gradient(xt)
    assert grad.dtype == e["dtype"] and cost.dtype == torch.float64
    assert not grad.requires_grad and not cost.requires_grad
    cost_j, grad_j = ej.cost_and_gradient(xj)
    _close(cost, cost_j, rtol)
    _close(grad, grad_j, 1e-12 if e["dtype"] == torch.float64 else rtol)
    _close(grad, et.cost_gradient_jacobian(xt).gradient,
           1e-12 if e["dtype"] == torch.float64 else rtol)
    assert et.statistics().calls["Evaluator::Gradient"] >= 1


def test_evaluation_callback_hook_follows_point_identity():
    from ceres_tpu.evaluator import Evaluator as JaxEvaluator
    from ceres_tpu_torch.evaluator import Evaluator

    seqs = []
    jp, tp = _evaluator_case("pose_graph")
    for ev_cls, prog, as_x in ((JaxEvaluator, jp.program(), jnp.asarray),
                               (Evaluator, tp.program("cpu"), torch.tensor)):
        calls = []

        class Hook:
            def prepare_for_evaluation(self, new_point, jacobians):
                calls.append((new_point, jacobians))

        ev = ev_cls(prog, evaluation_callback=Hook())
        x = as_x(np.asarray(prog.initial_ambient()))
        y = as_x(np.asarray(prog.initial_ambient()) + 0.01)
        ev.cost(x)
        ev.cost_gradient_jacobian(x)
        ev.cost_and_gradient(y)
        ev.residuals(y)
        ev._notify(None, False)
        ev.cost(x)
        seqs.append(calls)
    assert seqs[0] == seqs[1] == [(True, False), (False, True), (True, False), (False, False),
                                  (True, False), (True, False)]


# -- the reverse mode's fixed-order gather -------------------------------------

# 300 cameras (G+1 > 288, ids in any order: the ``unsorted`` kind) and 4200
# points (G+1 > 4096: ``sorted``, through a row list, the constant points
# dropped), each shared by many rows.
GATHER_BAL = dict(num_cameras=300, num_points=4200, num_observations=12600, noise=2.0,
                  perturb=0.7, seed=3)


def _gather_case(case: str):
    """(JAX program, port program): ``mixed`` is test_torch_problem_api's
    problem (losses, quaternion and Subset blocks, constant blocks);
    ``bal`` a Huber BAL with 3 constant cameras and every 50th point
    constant; ``bal_padded`` the same with its family padded to 13 000 rows
    (``parallel.bucket_program``: padding rows repeat row 0)."""
    import ceres_tpu as ct
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.parallel import bucket_program

    if case == "mixed":
        from test_torch_problem_api import _build

        return _build("jax")[0].program(), _build("torch")[0].program("cpu")
    inst = jbal.synthesize_bal(**GATHER_BAL)
    progs = []
    for bm, mod, dev in ((jbal, ct, ()), (tbal, ctt, ("cpu",))):
        p, cams, pts = bm.build_problem(inst, loss=mod.loss.HuberLoss(1.0))
        p.set_parameter_block_constant(cams[:3])
        p.set_parameter_block_constant(pts[::50])
        progs.append(p.program(*dev))
    if case == "bal_padded":
        bucket_program(progs[1], 6500)
        assert progs[1].families[0].batch == 13000
    return tuple(progs)


GATHER_KINDS = {"mixed": {"onehot"}, "bal": {"unsorted", "sorted"},
                "bal_padded": {"unsorted", "sorted"}}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(GATHER_KINDS))
def test_fixed_order_gradient(case, dtype, monkeypatch):
    """``_cost_grad_impl``'s gradient, summed through the gather plans,
    against JAX's and against autograd's own backward of the index."""
    jprog, tprog = _gather_case(case)
    jax_cast(jprog, dtype)
    cast_program(tprog, dtype)
    fams = tprog.families
    assert {p.kind for f in fams for p in f.gather_plans} == GATHER_KINDS[case]
    if case.startswith("bal"):
        dropped = [p.rows for f in fams for p in f.gather_plans if p.kind == "sorted"]
        assert dropped[0] is not None and dropped[0].shape[0] < fams[0].batch
    x0 = np.asarray(jprog.initial_ambient())
    xt = torch.tensor(x0, dtype=getattr(torch, dtype))
    cost, grad = _cost_grad_impl(xt, fams, tprog.plus_struct, True, tprog.num_tangent)
    cost_j, grad_j = jax_cost_grad(jnp.asarray(x0, dtype), jprog.families, jprog.plus_struct,
                                   True, jprog.num_tangent)
    rtol = 1e-12 if dtype == "float64" else 2e-4
    assert grad.dtype == xt.dtype
    _close(cost, cost_j, rtol)
    _close(grad, grad_j, rtol)
    if dtype == "float64":
        monkeypatch.setattr(tev._RowGather, "apply",
                            staticmethod(lambda table, index, plan: table[index]))
        cost_a, grad_a = _cost_grad_impl(xt, fams, tprog.plus_struct, True, tprog.num_tangent)
        assert float(cost_a) == float(cost)
        _close(grad, grad_a, 1e-13)


def _ids(layout: str, B: int, G: int, rng) -> np.ndarray:
    """B row ids into G rows; ids G and -1 are rows whose gradient is
    dropped."""
    ids = rng.integers(0, G, B) if G else np.zeros(B, dtype=np.int64)
    if layout == "sorted":
        return np.sort(ids)
    if layout == "reversed":
        return np.sort(ids)[::-1].copy()
    if layout == "dropped":
        ids[::7] = G
        ids[3::11] = -1
        return ids
    if layout == "sorted_dropped_last":
        return np.concatenate([np.sort(ids[: B // 2]), np.full(B - B // 2, G)])
    if layout == "all_dropped":
        return np.full(B, G)
    return ids  # "random"


GATHER_LAYOUTS = ["sorted", "reversed", "dropped", "sorted_dropped_last", "all_dropped",
                  "random"]


@pytest.mark.parametrize("layout", GATHER_LAYOUTS)
def test_gather_plan_rule_never_gives_a_card_scatter(layout):
    """The rule (one for every device: a CPU plan is the card's) over id
    layouts, table sizes and row counts: never ``scatter``, whose atomics
    add in no fixed order on a card; above K3's range always K1."""
    rng = np.random.default_rng(1)
    for G in (1, 100, 287, 288, 300, 4095, 4096, 5000, 40000):
        for B in (0, 10, 5000):
            kind = choose_gather_plan_kind(_ids(layout, B, G, rng), G)
            assert kind in ("onehot", "sorted", "unsorted"), (layout, G, B, kind)
            if G + 1 > 4096:
                assert kind == "sorted"


# (layout, G, the kind, whether a sorted plan goes through a row list)
GATHER_PLANS = [("random", 100, "onehot", None), ("dropped", 200, "onehot", None),
                ("sorted", 2000, "sorted", False), ("sorted_dropped_last", 5000, "sorted", True),
                ("random", 1000, "unsorted", None), ("dropped", 1000, "unsorted", None),
                ("random", 6000, "sorted", True), ("dropped", 6000, "sorted", True)]


@pytest.mark.parametrize("layout,G,kind,listed", GATHER_PLANS)
def test_gather_backward_sums_like_the_index(layout, G, kind, listed):
    """Each kind's backward against autograd's backward of ``table[index]``
    with the dropped rows' gradients zeroed (f64, 1e-13)."""
    rng = np.random.default_rng(G)
    B = 6000
    ids = _ids(layout, B, G, rng)
    plan = build_gather_plan(ids, G, "cpu")
    assert plan.kind == kind
    if kind == "sorted":
        assert (plan.rows is not None) == listed
    index = torch.from_numpy(np.where((ids < 0) | (ids >= G), 0, ids))
    keep = torch.from_numpy((ids >= 0) & (ids < G)).to(torch.float64)[:, None]
    table = torch.tensor(rng.standard_normal((G, 3)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((B, 3)))
    (ours,) = torch.autograd.grad((tev._RowGather.apply(table, index, plan) * w).sum(), table)
    (ref,) = torch.autograd.grad((table[index] * (w * keep)).sum(), table)
    _close(ours, ref.numpy(), 1e-13)
