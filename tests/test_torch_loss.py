"""Loss parity: every loss of ceres_tpu_torch.loss against ceres_tpu.loss,
(rho0, rho1, rho2) and the three corrector functions, over squared norms
from 0 to 1e6 including each loss's switch point. float64: rtol 1e-12 (with
an absolute floor of 1e-12 x the array's scale); float32: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu import loss as jl
from ceres_tpu_torch import loss as tl
from ceres_tpu_torch.interop import loss_from

# (name, constructor arguments, switch points of rho)
CASES = {
    "trivial": (lambda m: m.TrivialLoss(), []),
    "huber": (lambda m: m.HuberLoss(1.5), [2.25]),
    "softlone": (lambda m: m.SoftLOneLoss(0.7), []),
    "cauchy": (lambda m: m.CauchyLoss(2.0), []),
    "arctan": (lambda m: m.ArctanLoss(1.3), []),
    "tolerant": (lambda m: m.TolerantLoss(3.0, 0.5), [3.0]),
    "tukey": (lambda m: m.TukeyLoss(2.0), [4.0]),
    "scaled": (lambda m: m.ScaledLoss(m.HuberLoss(1.0), 0.25), [1.0]),
    "scaled_none": (lambda m: m.ScaledLoss(None, 3.0), []),
    "composed": (lambda m: m.ComposedLoss(m.CauchyLoss(1.0), m.HuberLoss(2.0)), [4.0]),
    "wrapper": (lambda m: m.LossFunctionWrapper(m.SoftLOneLoss(1.1)), []),
    "wrapper_none": (lambda m: m.LossFunctionWrapper(None), []),
}
DTYPES = {"f64": ("float64", 1e-12), "f32": ("float32", 1e-5)}


def _squared_norms(switch):
    rng = np.random.default_rng(4)
    s = np.concatenate([
        [0.0, 1e-12, 1e-6, 0.5, 1.0, 10.0, 1e3, 1e6],
        10.0 ** rng.uniform(-6, 6, 200),
        [v * f for v in switch for f in (1.0 - 1e-9, 1.0, 1.0 + 1e-9, 0.5, 2.0)],
    ])
    return np.sort(s)


def _close(t, j, rtol):
    t, j = t.detach().cpu().numpy(), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    # (Tolerant in float32 overflows exp() in both packages alike: the
    # non-finite entries must agree, the scale is that of the finite ones.)
    finite = np.abs(j[np.isfinite(j)])
    scale = float(finite.max()) if finite.size else 0.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_rho_matches_jax(name, dtype):
    make, switch = CASES[name]
    dname, rtol = DTYPES[dtype]
    s = _squared_norms(switch).astype(dname)
    ref = make(jl).evaluate(jnp.asarray(s))
    if dname == "float32":
        # the JAX package casts a family's loss parameters with its data
        import jax

        cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), make(jl))
        ref = cast.evaluate(jnp.asarray(s))
    out = make(tl).evaluate(torch.from_numpy(s))
    for t, j in zip(out, ref):
        _close(t, j, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["huber", "cauchy", "arctan", "tukey", "tolerant"])
def test_corrector_matches_jax(name, dtype):
    """corrector_coefficients (both branches: Tukey and Arctan give
    rho2 < 0, Tolerant rho2 > 0), correct_residuals, correct_jacobian."""
    make, switch = CASES[name]
    dname, rtol = DTYPES[dtype]
    rng = np.random.default_rng(9)
    r = (rng.standard_normal((240, 3)) * 10.0 ** rng.uniform(-3, 2, (240, 1))).astype(dname)
    r[0] = 0.0  # s == 0: the trivial branch
    J = rng.standard_normal((240, 3, 5)).astype(dname)
    # one squared norm for both (alpha = 1 - sqrt(D) cancels, so an ulp of
    # difference between two summation orders would show a thousandfold)
    sq = np.sum(r * r, axis=-1)
    sq_j, sq_t = jnp.asarray(sq), torch.from_numpy(sq)
    _, j1, j2 = make(jl).evaluate(sq_j.astype(jnp.float64))
    j1, j2 = j1.astype(dname), j2.astype(dname)
    t1, t2 = torch.from_numpy(np.array(j1)), torch.from_numpy(np.array(j2))
    sc_j, al_j = jl.corrector_coefficients(sq_j, j1, j2)
    sc_t, al_t = tl.corrector_coefficients(sq_t, t1, t2)
    assert bool((np.asarray(j2) > 0).any()) == (name == "tolerant")
    _close(sc_t, sc_j, rtol)
    # alpha = 1 - sqrt(D) cancels where D is near 1: it is right to a few
    # eps absolutely, so alpha / s to a few eps / s (XLA contracts D's
    # multiply-add, torch does not).
    eps = np.finfo(dname).eps
    err = np.abs(al_t.numpy() - np.asarray(al_j))
    assert np.all(err <= rtol * np.abs(np.asarray(al_j)) + 8 * eps / np.maximum(sq, 1e-30))
    _close(tl.correct_residuals(torch.from_numpy(r), sc_t),
           jl.correct_residuals(jnp.asarray(r), sc_j), rtol)
    _close(
        tl.correct_jacobian(torch.from_numpy(J), torch.from_numpy(r), torch.sqrt(t1), al_t),
        jl.correct_jacobian(jnp.asarray(J), jnp.asarray(r), jnp.sqrt(j1), al_j),
        rtol,
    )


@pytest.mark.parametrize("name", CASES)
def test_loss_from_rebuilds_the_jax_object(name):
    make, switch = CASES[name]
    s = _squared_norms(switch)
    ours = loss_from(make(jl))
    assert tl.loss_structure(ours) == tl.loss_structure(make(tl))
    for t, j in zip(ours.evaluate(torch.from_numpy(s)), make(jl).evaluate(jnp.asarray(s))):
        _close(t, j, 1e-12)


def test_stacked_parameters_evaluate_per_instance():
    """Residual blocks added one by one with different Huber scales share a
    family whose loss carries (B,) parameters."""
    scales = [0.5, 1.0, 2.0, 4.0]
    s = np.asarray([0.1, 3.0, 3.0, 100.0])
    stacked = tl.stack_losses([tl.HuberLoss(a) for a in scales])
    assert isinstance(stacked.a, torch.Tensor) and stacked.a.shape == (4,)
    out = stacked.evaluate(torch.from_numpy(s))
    for i, a in enumerate(scales):
        ref = jl.HuberLoss(a).evaluate(jnp.asarray(s[i : i + 1]))
        for t, j in zip(out, ref):
            np.testing.assert_allclose(t[i].item(), float(j[0]), rtol=1e-12)
    same = tl.stack_losses([tl.HuberLoss(1.0), tl.HuberLoss(1.0)])
    assert isinstance(same.a, float)
    taken = tl.loss_take(stacked, torch.tensor([True, False, True, False]))
    assert taken.a.tolist() == [0.5, 2.0]
    assert tl.loss_to(stacked, "cpu", torch.float32).a.dtype == torch.float32
