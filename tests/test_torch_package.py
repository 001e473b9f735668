"""The port's package boundary: importing ceres_tpu_torch loads neither jax
nor the JAX package (checked in a subprocess, because this test process has
already imported jax, tests/conftest.py; and in the sources, import by
import), and whatever the port does not do yet says which ROADMAP item
brings it."""

import ast
import os
import re
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
from ceres_tpu_torch.utils import native
assert native._lib is None  # nor the native core
"""


@pytest.mark.parametrize(
    "module",
    [
        "ceres_tpu_torch",
        "ceres_tpu_torch.models.bal",
        "ceres_tpu_torch.models.pose_graph",
        "ceres_tpu_torch.interop",
        "ceres_tpu_torch.loss",
        "ceres_tpu_torch.manifold",
        "ceres_tpu_torch.rotation",
        "ceres_tpu_torch.cost_functions",
        "ceres_tpu_torch.linear.cgnr",
        "ceres_tpu_torch.linear.dense",
        "ceres_tpu_torch.linear.preconditioners",
        "ceres_tpu_torch.ordered_groups",
        "ceres_tpu_torch.trust_region",
        "ceres_tpu_torch.host_loop_graphs",
        "ceres_tpu_torch.dogleg",
        "ceres_tpu_torch.inner_iterations",
        "ceres_tpu_torch.line_search",
        "ceres_tpu_torch.gradient_problem",
        "ceres_tpu_torch.gradient_checker",
        "ceres_tpu_torch.utils.observability",
        "ceres_tpu_torch.utils.native",
        "ceres_tpu_torch.linear.schur",
        "ceres_tpu_torch.linear.sparse_cholesky",
        "ceres_tpu_torch.linear.inner_product",
        "ceres_tpu_torch.linear.sparse_schur",
        "ceres_tpu_torch.ops.polynomial",
        "ceres_tpu_torch.ops.segment_sum",
        "ceres_tpu_torch.ops.unsorted_segment_sum",
        "ceres_tpu_torch.ops.outer_segment_sum",
        "ceres_tpu_torch.tools.sweep_kernels",
        "ceres_tpu_torch.tools.profile_solve",
        "ceres_tpu_torch.covariance",
        "ceres_tpu_torch.tiny_solver",
        "ceres_tpu_torch.numeric_diff",
        "ceres_tpu_torch.interpolation",
        "ceres_tpu_torch.c_api",
        "ceres_tpu_torch.models.nist",
        "ceres_tpu_torch.models.libmv",
        "ceres_tpu_torch.models.denoising",
        # the example programs, all in one interpreter
        ", ".join(f"ceres_tpu_torch.examples.{p.stem}"
                  for p in sorted((REPO / "ceres_tpu_torch" / "examples").glob("[!_]*.py"))),
    ],
    ids=lambda m: "ceres_tpu_torch.examples.*" if "," in m else m,
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


def _port_sources():
    files = sorted((REPO / "ceres_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 25
    return files


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "ceres_tpu", "flax"), f"{path}: imports {name}"


def _jax_package_exports():
    """The names ceres_tpu/__init__.py imports from its modules or lists in
    __all__ (read from the source: the port's test does not need them
    imported)."""
    tree = ast.parse((REPO / "ceres_tpu" / "__init__.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("ceres_tpu"):
            names.update(a.asname or a.name for a in node.names)
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__" for t in node.targets):
            names.update(e.value for e in node.value.elts)
    return names


def test_the_port_exports_every_name_of_the_jax_package():
    """Every public name of ceres_tpu's top level is the port's too, every
    module of the JAX package has a counterpart (parallel/ since item 19;
    ops/pallas_segment.py's kernels are csrc/*.cu), and so has every
    example program of examples/ in ceres_tpu_torch/examples/."""
    import ceres_tpu_torch as ctt

    names = _jax_package_exports()
    assert len(names) > 50
    assert sorted(n for n in names if not hasattr(ctt, n)) == []
    assert set(ctt.__all__) <= set(dir(ctt))
    jax_modules = {p.relative_to(REPO / "ceres_tpu").as_posix()
                   for p in (REPO / "ceres_tpu").rglob("*.py")}
    port_modules = {p.relative_to(REPO / "ceres_tpu_torch").as_posix()
                    for p in (REPO / "ceres_tpu_torch").rglob("*.py")}
    missing = sorted(m for m in jax_modules - port_modules if m != "ops/pallas_segment.py")
    assert missing == []
    programs = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert len(programs) == 26
    assert [p for p in programs if not (REPO / "ceres_tpu_torch" / "examples" / p).exists()] == []


def test_every_not_implemented_error_names_a_roadmap_item():
    """A ``raise NotImplementedError(...)`` with a message must carry the
    word ROADMAP, in the message or through a module-level constant (a bare
    raise marks an abstract method of a base class). Since item 19, the
    last module, none is left; one a later PR adds must follow the rule."""
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        constants = {
            t.id: node.value.value
            for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
            for t in node.targets if isinstance(t, ast.Name)
        }
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "") == "NotImplementedError"):
                continue
            texts = [n.value for n in ast.walk(node.exc)
                     if isinstance(n, ast.Constant) and isinstance(n.value, str)]
            texts += [constants.get(n.id, "") for n in ast.walk(node.exc) if isinstance(n, ast.Name)]
            assert any("ROADMAP" in t for t in texts), f"{path}:{node.lineno}"
    # any item a message names is in ROADMAP.md's Queue 1
    roadmap = (REPO / "ROADMAP.md").read_text()
    named = set()
    for path in _port_sources():
        named.update(re.findall(r"Queue 1 item (\d+[a-z]?)", path.read_text()))
    assert all(re.search(rf"^\*\*{n}\. ", roadmap, re.M) for n in named), named


def test_only_the_sparse_solvers_and_cluster_preconditioners_raise():
    """Every minimizer option, both sparse solvers, both cluster
    preconditioners (item 14b) and a sharded evaluation (item 19) pass the
    check: nothing raises."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.solver import check_supported

    runs = [
        dict(trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG),
        dict(minimizer_type=ctt.MinimizerType.LINE_SEARCH),
        dict(use_inner_iterations=True),
        dict(check_gradients=True),
        dict(minimizer_type=ctt.MinimizerType.LINE_SEARCH,
             linear_solver_type=ctt.LinearSolverType.SPARSE_SCHUR),
        dict(linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY),
        dict(linear_solver_type=ctt.LinearSolverType.SPARSE_SCHUR),
        dict(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
             preconditioner_type=ctt.PreconditionerType.CLUSTER_JACOBI),
        dict(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
             preconditioner_type=ctt.PreconditionerType.CLUSTER_TRIDIAGONAL),
        dict(num_threads=8),
    ]
    for changes in runs:
        opts = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.DENSE_QR)
        for k, v in changes.items():
            setattr(opts, k, v)
        check_supported(opts)
    check_supported(ctt.SolverOptions(mesh=object()))


def test_default_device_is_the_card_and_a_missing_card_raises():
    """No quiet move to the CPU: without a card a solve on the default
    device raises (run in a subprocess where CUDA is not available)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal, pose_graph

    problem = bal.build_problem(
        bal.synthesize_bal(num_cameras=3, num_points=20, num_observations=60, seed=1),
        loss=ctt.HuberLoss(1.0),
    )[0]
    for entry in (ctt.solve, ctt.fused_solve):
        with pytest.raises((RuntimeError, AssertionError)):
            entry(bal.default_options(), problem)
    graph = pose_graph.build_problem_3d(*pose_graph.synthesize_sphere(10, seed=0)[:3])[0]
    with pytest.raises((RuntimeError, AssertionError)):
        ctt.solve(pose_graph.default_options(), graph)
    with pytest.raises((RuntimeError, AssertionError)):
        problem.evaluate()
