"""The example programs that make their own data, run through both
packages on the same argv: ``examples.<name>.main`` (the JAX package) and
``ceres_tpu_torch.examples.<name>.main`` with ``--device cpu``.

Every summary that ``solve`` or ``solve_gradient_problem`` returns during a
run is recorded (``chip_smoke.recording_solves`` wraps both packages' entry
points and puts them back; neither package is edited), and the two runs are
held to each other by ``chip_smoke.held_to_example``, the check of the
examples phase on the card, with its tolerances: the same number of solves;
in each the same termination, the same number of records and the final
cost within EXAMPLE_COST_RTOL (f64); CGNR's final cost within
EXAMPLE_CGNR_RTOL; a line search's first 10 records and final cost within
EXAMPLE_LINE_SEARCH_RTOL (a line search amplifies last-bit differences;
ROADMAP "Facts about the reference"); costs below EXAMPLE_COST_ATOL are
rounding's. The printed output is compared by the kinds of its lines, not
by its digits.
"""

import importlib
import re
import sys
from pathlib import Path

import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
import chip_smoke
from ceres_tpu.models import nist as jnist
from ceres_tpu_torch.models import nist as tnist

REPO = Path(__file__).resolve().parent.parent

# tests/test_examples.py's FAST_EXAMPLES for these programs, and a small
# argv for libmv_homography, which that list lacks (50 points with 0.5 px
# of noise: its noise-free default ends at costs of 1e-23, rounding's).
CASES = [
    ("helloworld", []),
    ("helloworld_analytic_diff", []),
    ("helloworld_numeric_diff", []),
    ("rosenbrock", []),
    ("rosenbrock_analytic_diff", []),
    ("rosenbrock_numeric_diff", []),
    ("powell", []),
    ("curve_fitting", []),
    ("robust_curve_fitting", []),
    ("circle_fit", ["--num_points", "80", "--outliers", "8"]),
    ("sampled_function", []),
    ("bicubic_interpolation", []),
    ("bicubic_interpolation_analytic", []),
    ("robot_pose_mle", []),
    ("ellipse_approximation",
     ["--num_segments", "40", "--num_points", "60", "--max_iterations", "10"]),
    ("iteration_callback_example", []),
    ("evaluation_callback_example", []),
    ("more_garbow_hillstrom", ["--problem", "rosenbrock"]),
    ("more_garbow_hillstrom", ["--problem", "beale", "--minimizer", "line_search"]),
    ("libmv_homography", ["--num_points", "50", "--noise", "0.5"]),
]


# Rows of the full report that one package prints and the other does not:
# the JAX package counts its devices, the port names its device, and the
# port also prints the number of iterations.
ONE_PACKAGE_REPORT_ROWS = {"Devices", "Device cpu", "Iterations"}


def _kinds(text):
    """The kinds of the printed lines: each line with its numbers, arrays
    and the package's name taken out, in order of first appearance."""
    out = []
    text = text.replace("Ceres-TPU-torch", "Ceres-TPU").replace("ceres_tpu_torch", "ceres_tpu")
    for line in text.splitlines():
        kind = re.sub(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?|nan|inf", "#", line)
        kind = re.sub(r"[\s\[\]#,.()-]+", " ", kind).strip()
        if kind and kind not in out and kind not in ONE_PACKAGE_REPORT_ROWS:
            out.append(kind)
    return out


def run_both(monkeypatch, capsys, name, argv):
    """(chip_smoke.example_result, printed text) of the reference program
    and of the port's on the CPU, the same argv."""
    out = []
    for mod, nist_module in ((ct, jnist), (ctt, tnist)):
        with monkeypatch.context() as mp, \
                chip_smoke.recording_solves(mod, nist_module) as (summaries, suites):
            mp.setattr(sys, "argv", ["x"] + argv)
            if mod is ct:
                importlib.import_module(f"examples.{name}").main()
            else:
                importlib.import_module(f"ceres_tpu_torch.examples.{name}").main(
                    argv + ["--device", "cpu"])
        out.append((chip_smoke.example_result(summaries, suites), capsys.readouterr().out))
    return out


def held_to_reference(name, jax_run, port_run):
    (ref, jtext), (got, ttext) = jax_run, port_run
    assert len(ref) > 0, name
    chip_smoke.held_to_example(name, got, ref)
    assert _kinds(ttext) == _kinds(jtext), name


@pytest.mark.parametrize("name,argv", CASES, ids=[
    f"{n}{'-' + a[-1] if n == 'more_garbow_hillstrom' else ''}" for n, a in CASES])
def test_example_matches_the_jax_package(monkeypatch, capsys, name, argv):
    held_to_reference(name, *run_both(monkeypatch, capsys, name, argv))


def test_every_example_program_is_held_to_the_jax_package():
    """The two example test files run every program of examples/ (that each
    has a counterpart is tests/test_torch_package.py's check)."""
    ref = {p.stem for p in (REPO / "examples").glob("*.py")}
    covered = {n for n, _ in CASES}
    # the seven that read or synthesize a problem: test_torch_examples_inputs.py
    inputs = {"bundle_adjuster", "simple_bundle_adjuster", "pose_graph_2d", "pose_graph_3d",
              "nist", "libmv_bundle_adjuster", "denoising"}
    assert covered | inputs == ref and not covered & inputs


def test_the_default_device_is_the_card():
    """No quiet move to the CPU: without a card the programs raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from ceres_tpu_torch.examples import helloworld, rosenbrock

    for mod in (helloworld, rosenbrock):
        with pytest.raises((RuntimeError, AssertionError)):
            mod.main([])
