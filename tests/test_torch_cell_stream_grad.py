"""K6's and K7's stream interfaces (sorted_pair_grad, sorted_tet_factor_grad)
on the streams that the card tests of their CUDA entries hold apart
(tests/test_torch_kernels.py STREAM_CASES), against the JAX package on
the same seeded numpy inputs: JAX's K6 in Pallas interpret mode, its K7
through its CPU reference, as its own tests run them; the port runs the
plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.ops import hashgrid_sorted as jhs
from quadraturefields_tpu_torch.ops import hashgrid_sorted as ths

torch.set_num_threads(1)

CASES = ["one_row", "last_row", "out_of_range", "zeros", "mixed"]


def _stream(case, m, seed):
    """(rng, idx [m] int32, E) of a case: every contribution on one row,
    an odd E whose last row takes a quarter of the stream, only entries
    past the table (JAX's interfaces take no negative entry), zero values
    (the caller zeroes them) or uniform entries."""
    rng = np.random.default_rng(seed)
    e = 701 if case == "last_row" else 700
    idx = rng.integers(0, e, m)
    if case == "one_row":
        idx[:] = e // 2
    if case == "last_row":
        idx[: m // 4] = e - 1
    if case == "out_of_range":
        idx = idx + e
    return rng, idx.astype(np.int32), e


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pw", [2, 16])
def test_pair_stream_cases_match_jax(case, pw):
    """sorted_pair_grad against JAX's K6 (interpret mode) within 2e-5;
    exactly 0 where the stream adds nothing."""
    m = 1500
    rng, idx, e = _stream(case, m, pw)
    lo = rng.normal(0, 1, (m, pw)).astype(np.float32)
    hi = rng.normal(0, 1, (m, pw)).astype(np.float32)
    if case == "zeros":
        lo[:] = 0.0
        hi[:] = 0.0
    want = np.asarray(jhs.sorted_pair_grad(
        jnp.asarray(idx), jnp.asarray(lo), jnp.asarray(hi), e))
    got = ths.sorted_pair_grad(torch.tensor(idx), torch.tensor(lo),
                               torch.tensor(hi), e).numpy()
    assert got.shape == want.shape == (e, 2 * pw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if case in ("out_of_range", "zeros"):
        assert not got.any() and not want.any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F", [2, 4, 8, 16])
def test_factor_stream_cases_match_jax(case, F):
    """sorted_tet_factor_grad against JAX's K7 (its CPU reference)
    within 2e-5; exactly 0 where the stream adds nothing. (Slots outside
    0..7 are no part of JAX's interface: it packs each slot in 3 bits.)"""
    m = 1500
    rng, idx, e = _stream(case, m, F)
    wk = rng.normal(0, 1, (m, 4)).astype(np.float32)
    c1 = rng.integers(1, 7, m).astype(np.int32)
    c2 = ((c1 - 1 + rng.integers(1, 6, m)) % 6 + 1).astype(np.int32)
    g = rng.normal(0, 1, (m, F)).astype(np.float32)
    if case == "zeros":
        g[:] = 0.0
    want = np.asarray(jhs.sorted_tet_factor_grad(
        jnp.asarray(idx), jnp.asarray(wk), jnp.asarray(c1), jnp.asarray(c2),
        jnp.asarray(g), e))
    got = ths.sorted_tet_factor_grad(
        torch.tensor(idx), torch.tensor(wk), torch.tensor(c1),
        torch.tensor(c2), torch.tensor(g), e).numpy()
    assert got.shape == want.shape == (e, 8 * F)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if case in ("out_of_range", "zeros"):
        assert not got.any() and not want.any()


def test_empty_streams_give_zeros():
    """M = 0: a zero gradient of E rows from both interfaces."""
    idx = torch.zeros(0, dtype=torch.int32)
    z = torch.zeros((0, 4))
    assert not ths.sorted_pair_grad(idx, z, z, 9).any()
    c = torch.zeros(0, dtype=torch.int32)
    got = ths.sorted_tet_factor_grad(idx, z, c, c, torch.zeros((0, 2)), 9)
    assert got.shape == (9, 16) and not got.any()
