"""The port's presorted segment sum against the JAX package's CPU branch
(jax.ops.segment_sum over keys clipped to [0, n_segments])."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.ops.hashgrid_sorted import (
    presorted_row_segment_sum as jax_psum,
)
from quadraturefields_tpu_torch.ops.hashgrid_sorted import (
    presorted_row_segment_sum,
    segment_group,
    segment_sum_plain,
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


def _reference(keys, vals, n_seg):
    """JAX's presorted_row_segment_sum on the CPU; for a row width that
    does not divide 128 (which the JAX function asserts) its CPU branch's
    own expression, jax.ops.segment_sum over keys clipped to
    [0, n_seg]."""
    k, v = jnp.asarray(keys), jnp.asarray(vals)
    if 128 % vals.shape[1] == 0:
        return np.asarray(jax_psum(k, v, n_seg))
    return np.asarray(jax.ops.segment_sum(
        v, jnp.clip(k, 0, n_seg), num_segments=n_seg + 1,
        indices_are_sorted=True)[:n_seg])


def _edge_case(case, rw, rng):
    """(keys, vals, n_seg) of one edge case of the contract."""
    if case == "no_rows":
        keys, n_seg = np.zeros(0, np.int32), 6
    elif case == "one_segment":
        keys, n_seg = np.array([0, 0, 0, 1, 1], np.int32), 1
    elif case == "all_pads":
        keys, n_seg = np.full(9, 4, np.int32), 4
    elif case == "negative_keys":
        keys, n_seg = np.array([-7, -1, -1, 0, 2, 2, 5, 5], np.int32), 5
    elif case == "runs_of_one":
        keys, n_seg = np.array([0, 1, 2, 4, 7, 8, 9, 9], np.int32), 9
    else:  # "one_nonempty": every segment empty but one, then pads
        keys, n_seg = np.array([37] * 5 + [64] * 3, np.int32), 64
    vals = rng.normal(size=(keys.shape[0], rw)).astype(np.float32)
    return keys, vals, n_seg


@pytest.mark.parametrize("rw", range(1, 9))
@pytest.mark.parametrize("case", ["no_rows", "one_segment", "all_pads",
                                  "negative_keys", "runs_of_one",
                                  "one_nonempty"])
def test_segment_sum_edge_cases_match_jax(case, rw):
    """The contract's edge cases at every row width 1-8, the plain sum
    against the JAX package's within 1e-6 (sums of at most 5 normal
    values); segments without rows exactly 0."""
    keys, vals, n_seg = _edge_case(case, rw, np.random.default_rng(rw))
    ref = _reference(keys, vals, n_seg)
    got = segment_sum_plain(torch.as_tensor(keys), torch.as_tensor(vals),
                            n_seg).numpy()
    assert got.shape == (n_seg, rw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    rows = np.bincount(np.clip(keys, 0, n_seg), minlength=n_seg + 1)
    assert not got[rows[:n_seg] == 0].any()


@pytest.mark.parametrize("rows_a_segment", [0.6, 2.5, 8.0, 128.0])
def test_segment_sum_short_and_long_segments_match_jax(rows_a_segment):
    """The mean rows a segment of the paths (stage 4's 0.6 and 2.5, a
    stage-1 step's ~8) and of the uniform case (128), with pads, within
    1e-5 of the JAX package's sum."""
    rng = np.random.default_rng(int(rows_a_segment * 10))
    m, n_pad = 8192, 1024
    n_seg = round((m - n_pad) / rows_a_segment)
    keys = np.sort(rng.integers(0, n_seg, size=m - n_pad))
    keys = np.concatenate([keys, np.full(n_pad, n_seg)]).astype(np.int32)
    vals = rng.normal(size=(m, 8)).astype(np.float32)
    ref = _reference(keys, vals, n_seg)
    got = presorted_row_segment_sum(torch.as_tensor(keys),
                                    torch.as_tensor(vals), n_seg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_segment_group_follows_the_mean_rows_a_segment():
    """The card kernel's lanes a segment: the largest power of two at
    most M / n and 2^17 / n (a grid of at most 4096 warps), 1 to 16, so
    every lane count of the kernel is reached from some (M, n)."""
    assert segment_group(0, 7) == 1
    assert segment_group(163_840, 262_144) == 1      # stage 4, 0.6 a ray
    assert segment_group(2, 1) == 2
    assert segment_group(131_072, 46_336) == 2      # stage 4, 2.8 a ray
    assert segment_group(4 * 4096, 4096) == 4
    assert segment_group(15 * 4096, 4096) == 8
    assert segment_group(1 << 20, 8192) == 16        # 128 a segment
    assert segment_group(1 << 20, 32_768) == 4       # a cell step: 4096 warps
    assert segment_group(10**5, 1) == 16
    for n in (7, 5000, 40_000):
        for m in range(0, 300 * n, n // 7 + 1):
            g = segment_group(m, n)
            cap = min(m, 1 << 17) / n
            assert g & (g - 1) == 0 and 1 <= g <= 16
            assert g == 1 or g <= cap
            assert g == 16 or cap < 2 * g
