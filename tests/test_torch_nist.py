"""The port's NIST model against ceres_tpu's: every model formula at the
same seeded parameters and data, the .dat parser on files written here, and
run_suite over three models of different difficulty.

Tolerances: formulas and their Jacobians rtol 1e-12; run_suite's final
costs rtol 1e-10 and LREs within 1e-6 with the same terminations. The
record counts are not compared: with tolerances of 1e-18 the stop comes
after the cost has settled, on a parameter step that rounding decides
(Thurber from its second start: 22 records in JAX, 342 in the port, both
ending "Parameter tolerance reached" at a relative step of ~1e-19, the cost
settled since record ~15 and equal to 1.6e-14).
"""

import importlib
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

jn = importlib.import_module("ceres_tpu.models.nist")
tn = importlib.import_module("ceres_tpu_torch.models.nist")
NUM_PARAMS = {"Bennett5": 3, "BoxBOD": 2, "Chwirut1": 3, "Chwirut2": 3, "DanWood": 2, "Gauss1": 8,
              "Gauss2": 8, "Gauss3": 8, "Lanczos1": 6, "Lanczos2": 6, "Lanczos3": 6, "Hahn1": 7,
              "Kirby2": 5, "MGH09": 4, "MGH10": 3, "MGH17": 5, "Misra1a": 2, "Misra1b": 2,
              "Misra1c": 2, "Misra1d": 2, "Roszman1": 4, "Rat42": 3, "Rat43": 4, "Thurber": 7,
              "ENSO": 9, "Eckerle4": 3, "Nelson": 3}


@pytest.mark.parametrize("name", sorted(NUM_PARAMS))
def test_model_and_jacobian_match_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    b = rng.uniform(0.5, 2.0, NUM_PARAMS[name])
    x = rng.uniform(1.0, 3.0, (9, 2) if name == "Nelson" else 9)
    jf = jn.MODELS[name]
    tf = tn.MODELS[name]
    jv = jf(jnp.asarray(b), jnp.asarray(x))
    tv = tf(torch.tensor(b), torch.tensor(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)
    jJ = jax.jacfwd(jf)(jnp.asarray(b), jnp.asarray(x))
    tJ = torch.func.jacfwd(tf)(torch.tensor(b), torch.tensor(x))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-12, atol=1e-14)
    f32 = torch.func.jacfwd(tf)(torch.tensor(b, dtype=torch.float32),
                                torch.tensor(x, dtype=torch.float32))
    assert f32.dtype == torch.float32


def test_parser_reads_the_written_files_like_jax(tmp_path):
    chip_smoke.write_nist_files(tmp_path)
    for name in chip_smoke.NIST_MODELS:
        j = jn.parse_nist_file(tmp_path / f"{name}.dat")
        t = tn.parse_nist_file(tmp_path / f"{name}.dat")
        assert t.name == j.name == name
        for field in ("starts", "certified", "x", "y"):
            np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
        assert t.certified_cost == j.certified_cost
        assert t.starts.shape == (2, len(chip_smoke.NIST_MODELS[name][2]))


def test_lre_matches_jax():
    cert = np.array([2.0, 0.0, -3.0])
    for est in (cert, cert + 1e-7, np.array([2.0, 1e-5, -3.0]), np.array([5.0, 0.0, 1.0])):
        assert tn.lre(est, cert) == jn.lre(est, cert)


def test_run_suite_matches_jax(tmp_path):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_references import nist_references

    j = nist_references(ct, tmp_path)
    t = nist_references(ctt, tmp_path)
    assert [r[:2] + r[5:] for r in t] == [r[:2] + r[5:] for r in j]
    assert len(t) == 6 and all(r[5] == "CONVERGENCE" for r in t)
    np.testing.assert_allclose([r[3] for r in t], [r[3] for r in j], rtol=1e-10)
    np.testing.assert_allclose([r[2] for r in t], [r[2] for r in j], atol=1e-6)
