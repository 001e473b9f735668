"""K3 (unsorted segment sum): the port's plain version against the JAX
package's Pallas kernel ``segment_sum_onehot`` in interpret mode, on the
inputs of tests/test_pallas_segment.py, and against numpy in f64.

The Pallas kernel accumulates in f32 in another order: rtol 2e-6, atol 1e-4
(the tolerance of the JAX package's own test). f64 against a numpy sum:
1e-12 of the output scale. The CUDA kernel itself is held to the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.ops import pallas_segment as ps
from ceres_tpu_torch.ops import reduce as tred
from ceres_tpu_torch.ops import unsorted_segment_sum as us


def _numpy_reference(contrib, seg, G):
    out = np.zeros((G + 1,) + contrib.shape[1:], np.float64)
    np.add.at(out, np.where((seg < 0) | (seg >= G), G, seg), contrib.astype(np.float64))
    return out


def _plain(contrib, seg, G):
    ids = torch.from_numpy(seg.astype(np.int32))
    return us.segment_sum_unsorted(torch.from_numpy(contrib), ids, G).numpy()


@pytest.mark.parametrize("B,G,d", [(8192, 500, 81), (5000, 4000, 9)])
def test_plain_matches_pallas_onehot_tiled(B, G, d):
    rng = np.random.default_rng(B + G + d)
    seg = rng.integers(0, G, B)  # unsorted
    contrib = rng.standard_normal((B, d)).astype(np.float32)
    tiles, Bp = ps.build_tiled_plan(seg, G, tile_b=512)
    ref = np.asarray(ps.segment_sum_onehot(
        jnp.asarray(contrib), jnp.asarray(tiles), G, Bp, tile_b=512, interpret=True,
    ))
    out = _plain(contrib, seg, G)
    assert out.shape == (G + 1, d) and out.dtype == np.float32
    np.testing.assert_allclose(out[:G], ref[:G], rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize(
    "B,G,tail",
    [(8192, 500, (81,)), (5000, 4000, (9,)), (3001, 464, (1,)), (2000, 300, (3, 3))],
)
def test_plain_matches_numpy_f64(B, G, tail):
    """f64, ids outside [0, G) (negative and >= G) land in the dummy row."""
    rng = np.random.default_rng(B + G)
    seg = rng.integers(-3, G + 5, B)
    contrib = rng.standard_normal((B,) + tail)
    ref = _numpy_reference(contrib, seg, G)
    np.testing.assert_allclose(
        _plain(contrib, seg, G), ref, rtol=0, atol=1e-12 * np.abs(ref).max()
    )


def test_unsorted_plan_on_cpu_tensors_takes_the_plain_version():
    """An 'unsorted' plan applied to CPU tensors reduces through K3's plain
    version and launches nothing; f64 against numpy at 1e-12."""
    rng = np.random.default_rng(5)
    B, G = 6000, 464
    seg = rng.integers(0, G, B)
    contrib = rng.standard_normal((B, 9))
    plan = tred.ReducePlan(
        kind="unsorted", num_groups=G, seg=torch.from_numpy(seg.astype(np.int32))
    )
    before = us.launches
    out = tred.apply_reduce(plan, torch.from_numpy(contrib)).numpy()
    assert us.launches == before
    ref = _numpy_reference(contrib, seg, G)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_wrapper_rejects_bad_plans():
    c = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="int32"):
        us.segment_sum_unsorted(c, torch.zeros(10, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="int32"):
        us.segment_sum_unsorted(c, torch.zeros(9, dtype=torch.int32), 5)
    on_meta = torch.empty((10, 3), device="meta")
    with pytest.raises(ValueError, match="plan on"):
        us.segment_sum_unsorted(on_meta, torch.zeros(10, dtype=torch.int32), 5)
    assert us.max_num_groups(torch.float64) >= tred.UNSORTED_MAX_GROUPS
