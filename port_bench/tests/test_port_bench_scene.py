"""The scenes and the starts repeat for the same seed."""

import numpy as np

from port_bench import scene as scenes

SEED = 2**33 + 12345


def test_the_scene_repeats_and_has_its_counts():
    a = scenes.make_scene(6, 300, 1100, 2.0, SEED, "cpu")
    b = scenes.make_scene(6, 300, 1100, 2.0, SEED, "cpu")
    for f in ("cameras", "points", "camera_index", "point_index", "observations"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert (a.num_cameras, a.num_points, a.num_observations) == (6, 300, 1100)
    # every point seen by 3 or 4 distinct cameras, the first 200 by 4
    pairs = set(zip(a.point_index.tolist(), a.camera_index.tolist()))
    assert len(pairs) == 1100
    assert np.bincount(a.point_index).tolist() == [4] * 200 + [3] * 100
    c = scenes.make_scene(6, 300, 1100, 2.0, SEED + 1, "cpu")
    assert not np.array_equal(a.observations, c.observations)


def test_the_starts_repeat_per_request():
    sc = scenes.make_scene(6, 300, 1100, 2.0, SEED, "cpu")
    a = scenes.Starts(sc, 0.7, 0.07, SEED, "cpu")
    b = scenes.Starts(sc, 0.7, 0.07, SEED, "cpu")
    for k in (0, 1, scenes.Starts.BATCH + 3, 5):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a[0], a[1])
    x = np.concatenate([sc.cameras.reshape(-1), sc.points.reshape(-1)])  # the true state
    d = a[7] - x
    assert np.all(d[:6 * 9].reshape(6, 9)[:, [0, 1, 2, 6, 7, 8]] == 0)  # translations only
    assert 0.5 < np.std(d[6 * 9:]) < 0.9  # points + 0.7 N(0, 1)
    # the set-up's starts: a stream of their own, in batches of their own size
    setup = scenes.Starts(sc, 0.7, 0.07, SEED, "cpu", stream=scenes.Starts.SETUP, batch=3)
    again = scenes.Starts(sc, 0.7, 0.07, SEED, "cpu", stream=scenes.Starts.SETUP, batch=3)
    assert all(np.array_equal(setup[k], again[k]) for k in (0, 2, 1))
    assert not any(np.array_equal(setup[j], a[k]) for j in range(3) for k in range(4))


def test_stream_seeds_take_any_whole_seed():
    seeds = {scenes.stream_seed(s, 1, k) for s in (0, 2**31 + 5, 2**70) for k in (0, 1)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)
