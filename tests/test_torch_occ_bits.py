"""The port's occupancy bitfield and bit lookup against the JAX package.

Bit-exact throughout: packing and lookups are integer arithmetic, and
the cell of a position comes from the same f32 operations in both.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.ops import grid as jgrid
from quadraturefields_tpu.ops import occ_bits as job
from quadraturefields_tpu_torch.ops import occ_bits as tob

torch.set_num_threads(1)

AABB = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


@pytest.mark.parametrize("res", [16, 32, 64])
def test_pack_bits_match_jax_bit_for_bit(res):
    """Equal int32 words, including words with bit 31 set, which both
    packages store as negative int32."""
    rng = np.random.default_rng(res)
    b = rng.random((res, res, res)) < 0.5
    b.reshape(-1)[31::32] = True          # every word has bit 31 set
    ref = np.asarray(job.pack_occupancy_bits(jnp.asarray(b)))
    got = tob.pack_occupancy_bits(torch.as_tensor(b)).numpy()
    assert got.dtype == np.int32 and (got < 0).all()
    np.testing.assert_array_equal(got, ref)


def test_bit_lookup_matches_jax_interpret_kernel():
    """The word gather + bit extract against the TPU kernel run in
    interpret mode, at 8 and 16 bitfield rows."""
    rng = np.random.default_rng(2)
    for rows in (8, 16):
        n_bits = rows * 128 * 32
        bits = rng.random(n_bits) < 0.5
        words = bits.reshape(-1, 32).astype(np.uint32)
        packed = (words * (np.uint32(1) << np.arange(32, dtype=np.uint32))
                  ).sum(axis=1, dtype=np.uint32)
        table = packed.astype(np.int32).reshape(rows, 128)
        idx = rng.integers(0, n_bits, size=3333).astype(np.int32)
        ref = np.asarray(job._bit_lookup(jnp.asarray(table),
                                         jnp.asarray(idx), 64, True))
        got = tob._bit_lookup(torch.as_tensor(table), torch.as_tensor(idx))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy() > 0, bits[idx])


@pytest.mark.parametrize("res", [16, 32])
def test_lookup_bits_matches_jax(res):
    """occupancy_lookup_bits equals the JAX bit path and the dense
    lookup, out-of-box positions included."""
    rng = np.random.default_rng(1)
    b = rng.random((res, res, res)) < 0.2
    x = rng.uniform(-2.0, 2.0, size=(40, 50, 3)).astype(np.float32)
    ja = jnp.asarray(AABB)
    ref_bits = np.asarray(job.occupancy_lookup_bits(jnp.asarray(b), ja,
                                                    jnp.asarray(x)))
    ref_dense = np.asarray(jgrid.occupancy_lookup(jnp.asarray(b), ja,
                                                  jnp.asarray(x)))
    got = tob.occupancy_lookup_bits(torch.as_tensor(b),
                                    torch.as_tensor(AABB),
                                    torch.as_tensor(x)).numpy()
    assert got.shape == (40, 50)
    np.testing.assert_array_equal(got, ref_bits)
    np.testing.assert_array_equal(got, ref_dense)


def test_applicability_gate_matches_jax_default():
    for res in (8, 16, 20, 32, 64, 128, 256):
        assert tob.bits_lookup_applicable(res) == \
            job.bits_lookup_applicable(res), res
