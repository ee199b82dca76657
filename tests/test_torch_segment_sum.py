"""The port's presorted segment sum against the JAX package's CPU branch
(jax.ops.segment_sum over keys clipped to [0, n_segments])."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.ops.hashgrid_sorted import (
    presorted_row_segment_sum as jax_psum,
)
from quadraturefields_tpu_torch.ops.hashgrid_sorted import (
    presorted_row_segment_sum,
)

torch.set_num_threads(1)


def _stream(m, n_seg, rw, seed, n_pad):
    """Sorted keys with empty segments, long runs and n_pad sentinel
    rows (key == n_seg) at the end."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_seg, size=m - n_pad))
    keys = np.concatenate([keys, np.full(n_pad, n_seg)]).astype(np.int32)
    vals = rng.normal(size=(m, rw)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("rw", [1, 2, 8])
@pytest.mark.parametrize("n_pad", [0, 100])
def test_segment_sum_matches_jax(rw, n_pad):
    """Within 1e-5: the same sums in another f32 order (runs of ~10
    normal values)."""
    keys, vals = _stream(4096, 400, rw, rw, n_pad)
    ref = np.asarray(jax_psum(jnp.asarray(keys), jnp.asarray(vals), 400))
    got = presorted_row_segment_sum(torch.as_tensor(keys),
                                    torch.as_tensor(vals), 400).numpy()
    assert got.shape == (400, rw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_segment_sum_drops_sentinels_and_keeps_empty_rows_zero():
    keys = np.array([1, 1, 3, 5, 5, 5], np.int32)     # 5 == n_seg
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = presorted_row_segment_sum(torch.as_tensor(keys),
                                    torch.as_tensor(vals), 5).numpy()
    want = np.zeros((5, 2), np.float32)
    want[1] = vals[0] + vals[1]
    want[3] = vals[2]
    np.testing.assert_array_equal(got, want)
