"""The seven example programs that read or synthesize a problem, run
through both packages on the same argv and the same input files (written
into tmp_path: chip_smoke.py's writers at the small sizes of the model
tests, a small BAL file, a small g2o SE2 graph), held to each other as in
test_torch_examples.py. NIST is held by its LREs and costs, not by its
record counts: at tolerances of 1e-18 rounding decides its stop (ROADMAP
"Facts about the reference", item 14)."""

import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ceres_tpu_torch.models import bal as tbal

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_examples import held_to_reference, run_both  # noqa: E402

LIBMV_TINY = dict(frames=12, tracks=40, window=6)  # tests/test_torch_libmv.py's
DENOISING_SMALL = dict(height=24, width=30, experts=4, size=3)  # test_torch_denoising.py's
BAL_SMALL = dict(num_cameras=3, num_points=40, num_observations=120, seed=2)
G2O_SMALL = dict(poses=60, edges=80, seed=1)


def write_bal_file(path, prob) -> None:
    """The BAL text format that bal.load_bal_file reads."""
    lines = [f"{prob.num_cameras} {prob.num_points} {prob.num_observations}"]
    lines += [f"{c} {p} {x!r} {y!r}" for c, p, (x, y) in zip(
        prob.camera_index.tolist(), prob.point_index.tolist(), prob.observations.tolist())]
    lines += [repr(v) for v in np.concatenate([prob.cameras.ravel(), prob.points.ravel()]).tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def _argv(name, d):
    """The argv of each program: tests/test_examples.py's FAST_EXAMPLES
    where it has one, with the inputs written into ``d``."""
    if name == "bundle_adjuster":
        return ["--num_cameras", "3", "--num_points", "40", "--num_observations", "120",
                "--num_iterations", "5"]
    if name == "simple_bundle_adjuster":
        write_bal_file(d / "small.bal", tbal.synthesize_bal(noise=2.0, perturb=0.3, **BAL_SMALL))
        return [str(d / "small.bal")]
    if name == "pose_graph_2d":
        chip_smoke.write_g2o_2d(d / "graph.g2o", **G2O_SMALL)
        return ["--input", str(d / "graph.g2o")]
    if name == "pose_graph_3d":
        return ["--num_poses", "40"]
    if name == "nist":
        chip_smoke.write_nist_files(d)
        return ["--nist_data_dir", str(d), "--names", "Misra1a", "--num_iterations", "200"]
    if name == "libmv_bundle_adjuster":
        chip_smoke.write_libmv_shot(d / "shot.bin", **LIBMV_TINY)
        return ["--input", str(d / "shot.bin"), "--num_iterations", "2"]
    assert name == "denoising"
    pgm, foe = chip_smoke.write_denoising_inputs(d, **DENOISING_SMALL)
    return ["--input", str(pgm), "--foe_file", str(foe), "--crop", "16", "--num_iterations", "2"]


@pytest.mark.parametrize("name", ["bundle_adjuster", "simple_bundle_adjuster", "pose_graph_2d",
                                  "pose_graph_3d", "libmv_bundle_adjuster", "denoising"])
def test_example_matches_the_jax_package(monkeypatch, capsys, tmp_path, name):
    held_to_reference(name, *run_both(monkeypatch, capsys, name, _argv(name, tmp_path)))


def test_nist_matches_the_jax_package(monkeypatch, capsys, tmp_path):
    """run_suite's results of both packages: the same problems and starts,
    final costs and LREs within chip_smoke's example tolerances; the
    records are not held."""
    (ref, jtext), (got, ttext) = run_both(monkeypatch, capsys, "nist", _argv("nist", tmp_path))
    assert len(got) == 2
    chip_smoke.held_to_example("nist", got, ref)
    assert "LRE" in ttext and "LRE" in jtext


def test_g2o_writer_round_trips_through_both_readers(tmp_path):
    from ceres_tpu.models import pose_graph as jpg
    from ceres_tpu_torch.models import pose_graph as tpg

    path = tmp_path / "graph.g2o"
    loops = chip_smoke.write_g2o_2d(path, **G2O_SMALL)
    assert loops == G2O_SMALL["edges"] - G2O_SMALL["poses"] + 1
    (jp, jc), (tp, tc) = jpg.read_g2o_2d(path), tpg.read_g2o_2d(path)
    assert sorted(tp) == sorted(jp) == list(range(G2O_SMALL["poses"]))
    assert len(tc) == len(jc) == G2O_SMALL["edges"]
    for a, b in zip(tc, jc):
        assert (a.id_begin, a.id_end) == (b.id_begin, b.id_end) and a.id_end - a.id_begin >= 1
        np.testing.assert_array_equal(a.information, b.information)
    # every loop closure joins two poses at least two steps apart
    assert all(c.id_end - c.id_begin > 1 for c in tc[G2O_SMALL["poses"] - 1:])


def test_mesh_is_a_roadmap_item():
    """--mesh runs on the ranks torch.distributed.run starts (item 19, done:
    tests/test_torch_parallel_minimizers.py runs it); started alone it says
    so."""
    from ceres_tpu_torch.examples import bundle_adjuster

    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 2"):
        bundle_adjuster.main(["--mesh", "2", "--device", "cpu"])
