"""The harness's tests: on the CPU at tiny sizes, and (marked ``cuda``) on
the card. Run from the root of the repository:

    python -m pytest port_bench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Shapes small enough for the CPU: the configurations' own files with the
# scene's counts cut, everything else as it is.
TINY = {"num_cameras": 6, "num_points": 300, "num_observations": 1100}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda():
    """Skip the test where there is no CUDA device (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_root(tmp_path: Path, shapes=TINY) -> Path:
    """A benchmark root under ``tmp_path``: this repository's
    ``BENCHMARK.json`` and harness files, each configuration cut to
    ``shapes``."""
    root = tmp_path / "bench"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        config = json.loads(path.read_text())
        config.update(shapes)
        path.write_text(json.dumps(config))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
