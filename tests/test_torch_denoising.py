"""The port's Fields-of-Experts denoising model against ceres_tpu's: the
.pgm and .foe readers and writers on files written here, the loss, the
problem's structure (patch ids column-major, every argument's ids sorted),
and a small solve.

Tolerances: the loss rtol 1e-14; records' costs rtol 1e-10 (the CGNR
iterations equal); float32 within 1e-4 of float64; the denoised image 1e-8.
"""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu_torch import interop

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

jd = importlib.import_module("ceres_tpu.models.denoising")
td = importlib.import_module("ceres_tpu_torch.models.denoising")
SMALL = dict(height=24, width=30, experts=4, size=3)


def test_inputs_read_like_jax(tmp_path):
    pgm, foe = chip_smoke.write_denoising_inputs(tmp_path, **SMALL)
    np.testing.assert_array_equal(td.read_pgm(pgm), jd.read_pgm(pgm))
    assert td.read_pgm(pgm).shape == (SMALL["height"], SMALL["width"])
    j, t = jd.load_foe_file(foe), td.load_foe_file(foe)
    assert t.size == j.size == 3 and t.num_filters == j.num_filters == 4
    np.testing.assert_array_equal(t.alphas, j.alphas)
    np.testing.assert_array_equal(t.filters, j.filters)
    np.testing.assert_allclose(t.filters.sum(axis=1), 0.0, atol=1e-15)  # zero-mean filters


def test_pgm_formats(tmp_path):
    img = np.arange(12.0).reshape(3, 4) * 20.0
    td.write_pgm(tmp_path / "a.pgm", img)
    np.testing.assert_array_equal(td.read_pgm(tmp_path / "a.pgm"), img)
    (tmp_path / "b.pgm").write_bytes(b"P2\n# a comment\n4 3\n255\n" +
                                      " ".join(str(int(v)) for v in img.reshape(-1)).encode())
    np.testing.assert_array_equal(td.read_pgm(tmp_path / "b.pgm"), jd.read_pgm(tmp_path / "b.pgm"))
    (tmp_path / "c.pgm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="magic"):
        td.read_pgm(tmp_path / "c.pgm")


def test_loss_matches_jax_and_crosses_by_interop():
    s = np.array([0.0, 0.3, 2.0, 57.0])
    j = jd.FieldsOfExpertsLoss(1.7).evaluate(jnp.asarray(s))
    loss = interop.loss_from(jd.FieldsOfExpertsLoss(1.7))
    assert isinstance(loss, td.FieldsOfExpertsLoss)
    t = loss.evaluate(torch.tensor(s))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14)
    assert loss.evaluate(torch.tensor(s, dtype=torch.float32))[1].dtype == torch.float32


def test_structure(tmp_path):
    pgm, foe = chip_smoke.write_denoising_inputs(tmp_path, **SMALL)
    p, pix = td.build_problem(td.read_pgm(pgm), td.load_foe_file(foe))
    program = p.program("cpu")
    H, W, d = SMALL["height"], SMALL["width"], SMALL["size"]
    assert len(program.families) == 1 + SMALL["experts"]
    patches = (H - d + 1) * (W - d + 1)
    for fam in program.families[1:]:
        assert fam.batch == patches and fam.num_args == d * d
    # every argument's pixel ids rise with the patch, so on the card each
    # pixel-side reduction is a sorted segment sum (K1)
    for batch in p._residual_batches[1:]:
        assert np.all(np.diff(batch.cols, axis=0) >= 0)
    assert np.array_equal(p._residual_batches[1].cols[:, 1] - p._residual_batches[1].cols[:, 0],
                          np.full(patches, W))  # column-major: arg 1 is the next row
    jp, jpix = jd.build_problem(jd.read_pgm(pgm), jd.load_foe_file(foe))
    np.testing.assert_array_equal(pix, jpix)
    x = np.random.default_rng(0).uniform(0, 255, H * W)
    jp_prog = jp.program()
    assert jp_prog.num_residuals() == program.num_residuals() == H * W + SMALL["experts"] * patches
    from ceres_tpu.evaluator import Evaluator as JE
    from ceres_tpu_torch.evaluator import Evaluator as TE

    jc = JE(jp_prog).cost(jnp.asarray(x))
    tc = TE(program).cost(torch.tensor(x))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-12)


def test_solve_matches_jax(tmp_path):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import denoising_references

    two = dict(SMALL, experts=2)  # fewer families: fewer JAX compiles
    j = denoising_references(ct, tmp_path, **two)
    t = denoising_references(ctt, tmp_path, **two)
    t32 = denoising_references(ctt, tmp_path, dtype="float32", **two)
    assert len(t[0]) == len(j[0]) > 3 and t[2] == j[2]
    assert [r[1] for r in t[0]] == [r[1] for r in j[0]]
    np.testing.assert_allclose([r[0] for r in t[0]], [r[0] for r in j[0]], rtol=1e-10)
    np.testing.assert_allclose(t32[1], t[1], rtol=1e-4)


def test_solution_image_matches_jax(tmp_path):
    pgm, foe = chip_smoke.write_denoising_inputs(tmp_path, **SMALL)
    images = []
    for dn, mod, kw in ((jd, ct, {}), (td, ctt, dict(device="cpu"))):
        p, pix = dn.build_problem(dn.read_pgm(pgm), dn.load_foe_file(foe))
        opts = dn.default_options()
        opts.max_num_iterations = 3
        mod.solve(opts, p, **kw)
        images.append(dn.solution_image(p, pix))
    np.testing.assert_allclose(images[1], images[0], rtol=1e-8)
    assert not np.array_equal(images[1], td.read_pgm(pgm))
