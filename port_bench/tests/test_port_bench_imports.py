"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Checked in fresh processes, by
whole top-level module names (``ceres_tpu_torch`` is not ``ceres_tpu``)."""

import ast
import json
import subprocess
import sys

from conftest import ROOT, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "ceres_tpu"}


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_tiny_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    loaded = _run(
        "import json, sys, time\n"
        "from port_bench.harness import Bench, run_cell, forbidden_modules\n"
        f"r = run_cell(Bench({str(root)!r}), 'bal_dubrovnik_16.callback', 2**35, 0.3, False,"
        " 'cpu', time.perf_counter(), log=lambda line: None)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': r['correct'], 'tops': tops,"
        " 'forbidden': forbidden_modules()}))\n")
    assert loaded["correct"]
    assert "ceres_tpu_torch" in loaded["tops"]
    assert not FORBIDDEN & set(loaded["tops"]) and loaded["forbidden"] == []


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = _run(
        "import json, sys, types\n"
        "from port_bench.harness import forbidden_modules\n"
        "sys.modules['ceres_tpu_torch_x'] = types.ModuleType('ceres_tpu_torch_x')\n"
        "sys.modules['jaxtyping'] = types.ModuleType('jaxtyping')\n"
        "before = forbidden_modules()\n"
        "sys.modules['ceres_tpu.solver'] = types.ModuleType('ceres_tpu.solver')\n"
        "print(json.dumps({'before': before, 'after': forbidden_modules()}))\n")
    assert loaded == {"before": [], "after": ["ceres_tpu"]}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _run(
        "import json, sys\n"
        "import port_bench.reference, port_bench.check\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "ceres_tpu_torch" not in loaded and not FORBIDDEN & set(loaded)
    # and names none in its source, nor do the yardstick's modules it reads
    for name in ("reference.py", "scene.py", "check.py"):
        tree = ast.parse((ROOT / "port_bench" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= {"__future__", "dataclasses", "math", "numpy", "torch",
                            "port_bench"}, (name, tops)
