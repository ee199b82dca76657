"""The port's hash-grid encoding against the JAX package.

Same configs, same numpy inputs and tables through
quadraturefields_tpu.ops.hashgrid and quadraturefields_tpu_torch's
counterpart. On the CPU the port runs the encode kernel's plain
PyTorch version; the kernel itself is held against that on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.ops import hashgrid as jhg
from quadraturefields_tpu_torch.ops import hashgrid as thg

torch.set_num_threads(1)

CONFIG_GRID = [
    dict(n_levels=L, log2_hashmap_size=t, base_resolution=b,
         n_features=f, layout=lay)
    for L, t, b, f, lay in [
        (16, 19, 16, 2, "corner"),
        (4, 12, 16, 2, "corner"),
        (8, 15, 8, 4, "cell"),
        (5, 17, 16, 2, "corner"),
        (2, 10, 4, 1, "corner"),
    ]
]


@pytest.mark.parametrize("kw", CONFIG_GRID)
@pytest.mark.parametrize("max_res", [128, 2048, 4096])
def test_config_level_math_matches_jax(kw, max_res):
    """Exact equality: the level math is Python float/int arithmetic in
    both packages."""
    a = jhg.HashGridConfig.from_max_resolution(max_res, **kw)
    b = thg.HashGridConfig.from_max_resolution(max_res, **kw)
    assert a.level_scales == b.level_scales
    assert a.level_resolutions == b.level_resolutions
    assert a.level_sizes == b.level_sizes
    assert a.level_offsets == b.level_offsets
    assert a.total_entries == b.total_entries
    assert a.output_dim == b.output_dim
    assert a.corners == b.corners and a.row_width == b.row_width


def test_level_indices_match_jax_including_hash_wraparound():
    """Dense and hashed indices are equal element for element; coords up
    to 2^16 make the uint32 prime products wrap."""
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1 << 16, size=(4096, 3)).astype(np.int32)
    got = thg._level_indices(torch.as_tensor(coords), 1 << 16, 1 << 20)
    ref = jhg._level_indices(jnp.asarray(coords), 1 << 16, 1 << 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    small = coords % 16
    got = thg._level_indices(torch.as_tensor(small), 16, 4096)
    ref = jhg._level_indices(jnp.asarray(small), 16, 4096)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _points(n, seed):
    """Random points plus the edge cases: the cube's corners and faces
    (x = 0 and 1), coordinates outside [0, 1] (clipped), positions on
    grid knots (frac = 0) and fractional ties between axes, which the
    tet rank tie-break decides."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    edges = np.array(
        [[0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1], [0.5, 0.5, 0.5],
         [-0.2, 0.3, 1.4], [1e-7, 1 - 1e-7, 0.25]], np.float32)
    a = rng.random((64, 1)).astype(np.float32)
    b = rng.random((64, 1)).astype(np.float32)
    ties = np.concatenate([
        np.concatenate([a, a, b], 1), np.concatenate([a, b, a], 1),
        np.concatenate([b, a, a], 1), np.concatenate([a, a, a], 1),
    ])
    knots = (rng.integers(0, 16, size=(64, 3)) / 15.0).astype(np.float32)
    return np.concatenate([x, edges, ties, knots])


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("log2_t,base,max_res", [(12, 16, 256),
                                                 (10, 8, 64)])
def test_encode_matches_jax(interp, log2_t, base, max_res):
    """Encode within 1e-6: same indices and weights, the corner sum
    differs only in f32 summation order (values ~1)."""
    cfg_kw = dict(n_levels=4, n_features=2, log2_hashmap_size=log2_t,
                  base_resolution=base, interp=interp)
    jcfg = jhg.HashGridConfig.from_max_resolution(max_res, **cfg_kw)
    tcfg = thg.HashGridConfig.from_max_resolution(max_res, **cfg_kw)
    dense = [r**3 <= s for r, s in zip(tcfg.level_resolutions,
                                        tcfg.level_sizes)]
    assert any(dense) and not all(dense)   # both kinds of level
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (tcfg.total_entries, 2)).astype(np.float32)
    x = _points(1024, 2)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                         jnp.asarray(x), jcfg))
    got = thg.hashgrid_encode(torch.as_tensor(table), torch.as_tensor(x),
                              tcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("interp", ["cube", "tet"])
def test_corner_indices_weights_match_jax(interp):
    """Indices exactly, weights within 1e-7 (identical f32 ops)."""
    kw = dict(n_levels=3, log2_hashmap_size=11, interp=interp)
    jcfg = jhg.HashGridConfig.from_max_resolution(512, **kw)
    tcfg = thg.HashGridConfig.from_max_resolution(512, **kw)
    x = _points(512, 3).clip(0, 1)
    ji, jw = jhg._corner_indices_weights(jnp.asarray(x), jcfg)
    ti, tw = thg._corner_indices_weights(torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-7)


def test_encode_batched_matches_unbatched():
    """Chunking changes nothing: equal bit for bit."""
    cfg = thg.HashGridConfig(n_levels=2, log2_hashmap_size=10, interp="tet")
    g = torch.Generator().manual_seed(0)
    table = thg.hashgrid_init(g, cfg)
    assert table.shape == (cfg.total_entries, 2)
    assert float(table.abs().max()) <= 1e-4
    x = torch.rand((1000, 3), generator=g)
    full = thg.hashgrid_encode(table, x, cfg)
    chunked = thg.hashgrid_encode_batched(table, x, cfg, chunk=128)
    assert torch.equal(full, chunked)


def test_cell_layout_is_refused():
    cfg = thg.HashGridConfig(n_levels=2, log2_hashmap_size=10, layout="cell")
    with pytest.raises(NotImplementedError):
        thg.hashgrid_encode(torch.zeros((cfg.total_entries, 16)),
                            torch.zeros((4, 3)), cfg)
