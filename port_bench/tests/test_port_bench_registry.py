"""BENCHMARK.json against the rules of its format, and the harness finding every
configuration, mix and metric by name, a new one added as files included."""

import json
import re
import time

import pytest
from conftest import ROOT

from port_bench.harness import Bench, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert spec["paths"] == ["port_bench"]
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_metrics_follow_the_format(spec):
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in layers and UNIT.match(m["unit"])
    cells = {w["name"] for w in spec["workloads"]}
    for w in cells:  # every cell reports setup_s, one more end-to-end and one per-layer metric
        e2e = [m for m in spec["end_to_end"] if w in m.get("workloads", cells)]
        assert len(e2e) >= 2
        assert any(w in m.get("workloads", cells) for m in spec["per_layer"])


def test_everything_is_found_by_name(spec):
    bench = Bench(ROOT)
    for w in spec["workloads"]:
        config = bench.config(w["config"])
        assert config["name"] == w["config"] and config["reduced"] == []
        assert {"cost_gap", "gn_decrease"} <= set(config["limits"])
        traffic = bench.traffic(w["traffic"])
        assert {"points_sigma", "translation_sigma", "iteration_callback"} <= set(traffic)
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_a_new_mix_metric_and_cell_are_files_and_entries(tiny_root):
    """A cell added as a new traffic file, a new metric file and new
    entries in BENCHMARK.json runs without an edit to any file that was
    there."""
    before = {p: p.read_bytes() for p in (tiny_root / "port_bench").rglob("*") if p.is_file()}
    (tiny_root / "port_bench/traffic/near.json").write_text(json.dumps(
        {"points_sigma": 0.07, "translation_sigma": 0.007, "iteration_callback": False}))
    (tiny_root / "port_bench/metrics/iterations_per_solve.py").write_text(
        "def read(records):\n"
        "    solves = records['solves']\n"
        "    return sum(s.iterations for s in solves) / len(solves) if solves else None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "bal_dubrovnik_16.near", "config": "bal_dubrovnik_16",
                              "traffic": "near", "chips": 1, "why": "starts near the answer"})
    spec["per_layer"].append({"name": "iterations_per_solve", "unit": "iters/solve",
                              "better": "lower", "source": "program_counter",
                              "layer": "LM loop", "moves": "solve_s",
                              "workloads": ["bal_dubrovnik_16.near"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny_root)
    result = run_cell(bench, "bal_dubrovnik_16.near", 2**40 + 3, 6.0, True, "cpu",
                      time.perf_counter(), log=lambda line: None)
    assert result["correct"] and result["attempted"] >= 1
    assert result["metrics"]["iterations_per_solve"]["value"] > 0
    assert "iterations_per_solve" not in [m["name"] for m in bench.metrics(
        "bal_dubrovnik_16.restarts", True)]
    after = {p: p.read_bytes() for p in before}
    assert after == before
