"""The port's package boundary: importing ceres_tpu_torch loads neither jax
nor the JAX package. Checked in a subprocess, because this test process
has already imported jax (tests/conftest.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
def jaxy():
    return {m for m in sys.modules
            if m in ('jax', 'ceres_tpu') or m.startswith(('jax.', 'ceres_tpu.'))}
before = jaxy()  # whatever interpreter start-up loaded is not the port's doing
import {module}
from ceres_tpu_torch.ops import cuda_build
print(','.join(sorted(jaxy() - before)))
print(len(cuda_build._loaded))  # kernels build at first launch, not at import
"""


@pytest.mark.parametrize(
    "module",
    [
        "ceres_tpu_torch",
        "ceres_tpu_torch.models.bal",
        "ceres_tpu_torch.interop",
        "ceres_tpu_torch.ops.segment_sum",
        "ceres_tpu_torch.ops.unsorted_segment_sum",
        "ceres_tpu_torch.ops.outer_segment_sum",
        "ceres_tpu_torch.tools.sweep_kernels",
        "ceres_tpu_torch.tools.profile_solve",
    ],
)
def test_import_leaves_jax_out(module):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("{module}", module)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    leaked, built = out.stdout.split("\n")[:2]
    assert leaked == "", f"{module} imported {leaked}"
    assert built == "0"
