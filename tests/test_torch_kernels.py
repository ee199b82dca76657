"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test builds its kernel from csrc/ (nvcc, sm_90a) and compares it
with the plain version on the same CUDA tensors, on the edge cases that
random main-path inputs rarely reach: the encode, its fused table
gradient (also in its stochastic form, on ray-ordered samples with a
padded budget, and both on
the stage-2 and stage-4 field tables, last rows included), the pair
segment sum and K8's one-launch value-layout interface (also on
ray-ordered streams whose lanes merge), the occupancy bits, the per-ray
segment sum (also at the stage-4 packed composite's shape and at a
baked chunk's adaptive cap), K2 and K1 at the stage-5 SG grid's bake
chunk and step, and the cell
layout's table gradients K5, K6 and K7 (from their streams and fused
from positions, alone and through the cell encode's backward); and the
stage-3 blur, whose convolutions must not take TF32 on the card. Without
a card every test skips: a CUDA kernel has no CPU mode. The file
imports no jax, so on a host without jax it runs without the repo's
conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""
import dataclasses

import pytest
import torch

from chip_smoke import knots_faces_ties, stochastic_ties
from quadraturefields_tpu_torch.ops import hashgrid as hg
from quadraturefields_tpu_torch.ops import hashgrid_backward as hb
from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
from quadraturefields_tpu_torch.ops import occ_bits as ob

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
def test_encode_kernel_matches_plain(dev, interp, n_features):
    """Within 1e-5: the same indices and weights (no FMA contraction of
    x*scale+0.5), f32 sums of up to 8 products of values <= 1."""
    cfg = hg.HashGridConfig.from_max_resolution(
        512, n_levels=6, n_features=n_features, log2_hashmap_size=14,
        interp=interp)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((cfg.total_entries, n_features), generator=g,
                       device=dev) * 2 - 1
    x = torch.rand((5000, 3), generator=g, device=dev)
    a = torch.rand((256, 1), generator=g, device=dev)
    b = torch.rand((256, 1), generator=g, device=dev)
    ties = torch.cat([torch.cat([a, a, b], 1), torch.cat([a, b, a], 1),
                      torch.cat([b, a, a], 1), torch.cat([a, a, a], 1)])
    edges = torch.tensor([[0, 0, 0], [1, 1, 1], [-0.5, 0.5, 1.5],
                          [1, 0, 1]], dtype=torch.float32, device=dev)
    x = torch.cat([x, ties, edges])
    before = hg.ENCODE_KERNEL.launches
    got = hg.hashgrid_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert hg.ENCODE_KERNEL.launches == before + 1
    want = hg.encode_plain(table, x, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _encode_tile(n_levels, n_features):
    """Points per block of the tet encode (csrc/hashgrid_encode.cu
    launch): ~2176 floats of padded [tile, L*F] output, a multiple of 32
    in [32, 256]."""
    v = min(n_features, 4)
    row = n_levels * n_features
    stride = row + v if (row // v) % 2 == 0 else row
    return max(32, min(256, 2176 // stride // 32 * 32))


def _runs(g, n, dev):
    """n points in runs of 1-40 equal points, as samples along a ray
    share positions on the coarse levels."""
    distinct = torch.rand((n, 3), generator=g, device=dev)
    lengths = torch.randint(1, 41, (n,), generator=g, device=dev)
    return distinct.repeat_interleave(lengths, dim=0)[:n].contiguous()


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
@pytest.mark.parametrize("n_levels", [1, 16, 32])
def test_encode_kernel_ragged_tiles(dev, interp, n_features, n_levels):
    """The encode (tet in level-major tiles, cube point-major) at ragged
    point counts (1, 33, one tet tile + 1) on uniform points and on runs
    of equal points: within
    1e-5 of encode_plain, and tet bit for bit against the plain corner
    rows and weights summed in the kernel's order (w_0 v_0 + w_1 v_1 +
    ..., corner by corner; encode_plain's own sum over corners takes
    another order where PyTorch vectorises it, at F = 1)."""
    cfg = hg.HashGridConfig(n_levels=n_levels, n_features=n_features,
                            log2_hashmap_size=12, base_resolution=4,
                            per_level_scale=1.25, interp=interp)
    assert cfg.level_resolutions[0] ** 3 <= cfg.level_sizes[0]
    g = torch.Generator(device=dev).manual_seed(n_levels * n_features)
    table = torch.rand((cfg.total_entries, n_features), generator=g,
                       device=dev) * 2 - 1
    for n in (1, 33, _encode_tile(n_levels, n_features) + 1):
        for x in (torch.rand((n, 3), generator=g, device=dev),
                  _runs(g, n, dev)):
            got = hg.encode_kernel(table, x, cfg)
            torch.testing.assert_close(got, hg.encode_plain(table, x, cfg),
                                       rtol=0, atol=1e-5)
            if interp == "tet":
                idx, w = hg._corner_indices_weights(x, cfg)
                rows = table[idx].reshape(n, n_levels, 4, n_features)
                w = w.reshape(n, n_levels, 4, 1)
                want = torch.zeros_like(rows[:, :, 0])
                for k in range(4):
                    want = want + rows[:, :, k] * w[:, :, k]
                assert torch.equal(got, want.reshape(n, -1)), n


def test_encode_kernel_checks_its_inputs(dev):
    cfg = hg.HashGridConfig(n_levels=2, log2_hashmap_size=10)
    table = torch.zeros((cfg.total_entries, 2), device=dev)
    with pytest.raises(TypeError):
        hg.hashgrid_encode(table, torch.zeros((4, 3), dtype=torch.float64,
                                              device=dev), cfg)
    with pytest.raises(ValueError):
        hg.hashgrid_encode(table, torch.zeros((3, 4), device=dev).T, cfg)
    with pytest.raises(ValueError):
        hg.hashgrid_encode(table, torch.zeros((4, 3)).to(dev)[:, :2], cfg)


@pytest.mark.parametrize("res", [16, 32, 64])
def test_bits_kernel_is_bit_exact(dev, res):
    """Bit-exact, including out-of-box, boundary and far-away positions
    (a missed ray's probes sit ~1e10 away) and words with bit 31 set."""
    g = torch.Generator(device=dev).manual_seed(res)
    binaries = torch.rand((res, res, res), generator=g, device=dev) < 0.3
    binaries.view(-1)[31::32] = True
    aabb = torch.tensor([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], device=dev)
    x = torch.rand((100000, 3), generator=g, device=dev) * 4 - 2
    cells = torch.arange(res + 1, device=dev, dtype=torch.float32)
    knots = (cells / res * 3 - 1.5)[:, None].expand(res + 1, 3)
    far = torch.tensor([[1e10, 0, 0], [-1e10, 3e9, -1e10]], device=dev)
    x = torch.cat([x, knots, far]).contiguous()
    table = ob.pack_occupancy_bits(binaries)
    got = ob.lookup_bits_kernel(table, aabb, x, res)
    want = ob.lookup_bits_plain(table, aabb, x, res)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got.sum()) > 0


def test_segment_sum_kernel_matches_plain(dev):
    """Relative 1e-5: empty segments, one run of 10^5 rows, sentinel
    rows, and row widths with and without 16-byte row loads. The
    reference is the plain version's sum in float64: the plain f32
    index_add_ adds with atomics in a varying order, and over a run of
    10^5 rows its own rounding reaches ~1e-5 of the sum."""
    g = torch.Generator(device=dev).manual_seed(1)
    n_seg = 3000
    keys = torch.randint(0, n_seg, (200000,), generator=g, device=dev)
    keys[:100000] = 7
    keys = torch.cat([keys.sort().values,
                      torch.full((5000,), n_seg, device=dev)]).int()
    for rw in (1, 3, 5, 8):
        vals = torch.randn((keys.shape[0], rw), generator=g, device=dev)
        got = hs.segment_sum_kernel(keys, vals, n_seg)
        want = hs.segment_sum_plain(keys, vals.double(), n_seg)
        torch.cuda.synchronize()
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) <= 1e-5, rw
        assert float(got[n_seg // 2:].abs().sum()) > 0


def _segment_stream(dev, m, n_seg, n_pad, seed):
    """Sorted uniform keys of m - n_pad rows over n_seg segments, then
    n_pad pad rows (key n_seg)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, n_seg, (m - n_pad,), generator=g, device=dev)
    return torch.cat([keys.sort().values,
                      torch.full((n_pad,), n_seg, device=dev)]).int()


def _check_segment_sum(keys, vals, n_seg):
    """The kernel within 1e-5 of max of the plain sum in float64, its
    segments without rows exactly 0, and a second launch bit for bit
    the first."""
    got = hs.segment_sum_kernel(keys, vals, n_seg)
    again = hs.segment_sum_kernel(keys, vals, n_seg)
    want = hs.segment_sum_plain(keys, vals.double(), n_seg)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    rows = torch.bincount(keys.long().clamp(0, n_seg), minlength=n_seg + 1)
    assert not got[rows[:n_seg] == 0].any()
    assert torch.equal(got, again)


@pytest.mark.parametrize("rw", range(1, 9))
@pytest.mark.parametrize("rows_a_segment,group", [
    (0.6, 1), (2.5, 2), (4.0, 2), (8.0, 4), (16.0, 8), (128.0, 16)])
def test_segment_sum_kernel_short_and_long_segments(dev, rows_a_segment,
                                                    group, rw):
    """K3 at the stage-4 pack cap (163,840 rows, 1/8 pads) at 0.6-128
    rows a segment, which take every lane count of the kernel (1-16:
    here 2^17 / n bounds it) and every row width 1-8."""
    m, n_pad = 163_840, 20_480
    n_seg = round((m - n_pad) / rows_a_segment)
    assert hs.segment_group(m, n_seg) == group
    keys = _segment_stream(dev, m, n_seg, n_pad, rw)
    vals = torch.randn((m, rw), device=dev)
    _check_segment_sum(keys, vals, n_seg)


@pytest.mark.parametrize("rows_a_segment", [0.6, 2.5, 8.0, 20.0])
def test_segment_sum_kernel_skewed_runs(dev, rows_a_segment):
    """Poisson run lengths with 1% of the segments 64-2000 rows long:
    the runs longer than 32 lanes-a-segment rows go to the whole warp,
    up to 32 of them in one warp."""
    g = torch.Generator(device=dev).manual_seed(int(rows_a_segment * 10))
    n_seg = 20_000
    lengths = torch.poisson(
        torch.full((n_seg,), rows_a_segment, device=dev), generator=g).long()
    tail = torch.rand((n_seg,), generator=g, device=dev) < 0.01
    tail[:32] = True  # a warp of long runs
    lengths[tail] = torch.randint(64, 2000, (int(tail.sum()),),
                                  generator=g, device=dev)
    keys = torch.repeat_interleave(
        torch.arange(n_seg, device=dev, dtype=torch.int32), lengths)
    keys = torch.cat([keys, torch.full((777,), n_seg, dtype=torch.int32,
                                       device=dev)])
    vals = torch.randn((keys.shape[0], 8), generator=g, device=dev)
    _check_segment_sum(keys, vals, n_seg)


@pytest.mark.parametrize("n_seg", [1000, 262_144])
def test_segment_sum_kernel_one_long_run(dev, n_seg):
    """A single run of 10^5 rows (key 5) among empty segments, summed by
    the whole warp whether the mean rows a segment give it 16 lanes
    (10^5 rows over 1000 segments) or one (over 262,144)."""
    m = 100_000
    keys = torch.full((m,), 5, dtype=torch.int32, device=dev)
    vals = torch.randn((m, 8), device=dev)
    _check_segment_sum(keys, vals, n_seg)
    got = hs.segment_sum_kernel(keys, vals, n_seg)
    assert float(got[5].abs().sum()) > 0 and not got[6:].any()


@pytest.mark.parametrize("rw", [3, 8])
def test_segment_sum_kernel_edge_cases(dev, rw):
    """No rows, one segment, all rows pads, negative keys (segment 0)
    and runs of one row."""
    cases = [
        ([], 6), ([0, 0, 0, 1, 1], 1), ([4] * 9, 4),
        ([-7, -1, -1, 0, 2, 2, 5, 5], 5), ([0, 1, 2, 4, 7, 8, 9, 9], 9),
    ]
    for keys, n_seg in cases:
        keys = torch.tensor(keys, dtype=torch.int32, device=dev)
        vals = torch.randn((keys.shape[0], rw), device=dev)
        got = hs.segment_sum_kernel(keys, vals, n_seg)
        want = hs.segment_sum_plain(keys, vals.double(), n_seg)
        torch.cuda.synchronize()
        assert got.shape == (n_seg, rw)
        assert float((got - want).abs().max()) <= 1e-6, keys


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
def test_table_grad_kernel_matches_plain(dev, interp, n_features):
    """The fused table gradient (K1) through hashgrid_encode's backward,
    on a grid with one dense level (16^3 rows) and one hashed level:
    within 1e-5 of max |want|, want being the plain version's sum in
    float64, since the atomics add in an order that changes from run to
    run."""
    cfg = hg.HashGridConfig.from_max_resolution(
        512, n_levels=2, n_features=n_features, log2_hashmap_size=14,
        interp=interp)
    res, sizes = cfg.level_resolutions, cfg.level_sizes
    assert res[0] ** 3 <= sizes[0] and res[1] ** 3 > sizes[1]
    g = torch.Generator(device=dev).manual_seed(2)
    table = (torch.rand((cfg.total_entries, n_features), generator=g,
                        device=dev) * 2 - 1).requires_grad_(True)
    x = torch.rand((20000, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((20000, cfg.output_dim), generator=g, device=dev)
    before = hg.ENCODE_BWD_KERNEL.launches
    (got,) = torch.autograd.grad(hg.hashgrid_encode(table, x, cfg), table,
                                 cot)
    torch.cuda.synchronize()
    assert hg.ENCODE_BWD_KERNEL.launches == before + 1
    want = hg.table_grad_plain(x, cot.double(), cfg)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _stochastic_inputs(inputs, n, cfg, dev, seed):
    """(x, cotangent) of the stochastic kernel's card test. "uniform":
    random points in and outside the cube, the cube's corners and faces
    and -0.0 coordinates; "ray_ordered": ray-ordered samples, a run of
    64 points inside one cell of the dense level 0 (its picks spread
    over the cell's corners, which neighbouring lanes share) and one of
    64 copies of a point. Both end in 500 zero-cotangent padding
    slots."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if inputs == "uniform":
        x = torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.1
        x[:6] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                              [-0.0, -0.0, -0.0], [-0.0, 0.5, 1.0],
                              [1.0, -0.0, 0.25], [-2.0, 3.0, -0.0]])
    else:
        x = _ray_samples(g, n, 500, dev)
        # level 0's cell 5 on each axis: pos = x * scale + 0.5 in [5, 6)
        s0 = cfg.level_scales[0]
        x[1000:1064] = (4.55 + 0.9 * torch.rand((64, 3), generator=g,
                                                 device=dev)) / s0
        x[2000:2064] = x[2000]
    cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
    cot[-500:] = 0.0
    return x, cot


@pytest.mark.parametrize("inputs,n_features,interp", [
    pytest.param(inputs, f, interp, id=(f"{f}-{interp}" if inputs == "uniform"
                                        else f"{inputs}-{f}-{interp}"))
    for inputs in ("uniform", "ray_ordered") for f in (1, 2, 4, 8)
    for interp in ("cube", "tet")])
def test_table_grad_stochastic_kernel_matches_plain(dev, inputs, n_features,
                                                    interp):
    """K1's stochastic form (grad_mode "stochastic") through
    hashgrid_encode's backward, on one dense and one hashed level, on
    _stochastic_inputs: uniform points, and ray-ordered ones whose lanes
    pick equal rows and merge before their atomics; both with
    zero-cotangent padding. It launches once and the exact K1 never; its
    picks equal the plain version's (tet: the same weights and running
    sums bit for bit; cube: but where u lies within 2 ulp of a
    cumulative weight, chip_smoke.stochastic_ties); its gradient within
    1e-5 of max of the float64 plain sum of the rows it picked."""
    cfg = hg.HashGridConfig.from_max_resolution(
        512, n_levels=2, n_features=n_features, log2_hashmap_size=14,
        interp=interp, grad_mode="stochastic")
    res, sizes = cfg.level_resolutions, cfg.level_sizes
    assert res[0] ** 3 <= sizes[0] and res[1] ** 3 > sizes[1]
    x, cot = _stochastic_inputs(inputs, 20000, cfg, dev, 3)
    table = torch.zeros((cfg.total_entries, n_features), device=dev,
                        requires_grad=True)
    exact = hg.ENCODE_BWD_KERNEL.launches
    before = hg.ENCODE_BWD_STOCHASTIC_KERNEL.launches
    (got,) = torch.autograd.grad(hg.hashgrid_encode(table, x, cfg), table,
                                 cot)
    torch.cuda.synchronize()
    assert hg.ENCODE_BWD_STOCHASTIC_KERNEL.launches == before + 1
    assert hg.ENCODE_BWD_KERNEL.launches == exact
    xc = x.clamp(0.0, 1.0)
    out, picks = hg.table_grad_stochastic_kernel(xc, cot, cfg,
                                                 with_picks=True)
    differ = picks != hg.stochastic_picks_plain(xc, cfg)
    if interp == "tet":
        assert not bool(differ.any())
    else:
        assert not bool((differ & ~stochastic_ties(torch, xc, cfg)).any())
        assert int(differ.sum()) <= 1e-3 * differ.numel()
    if inputs == "ray_ordered":
        # the run inside one level-0 cell: its lanes picked shared rows
        level0 = picks[1000:1064, 0]
        assert int(torch.unique(level0).numel()) < 64
    want = torch.zeros((cfg.total_entries, n_features), dtype=torch.float64,
                       device=dev)
    want.index_add_(0, picks.reshape(-1),
                    cot.double().reshape(-1, n_features))
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= 1e-5 * scale
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("interp", ["tet", "cube"])
def test_encode_and_table_grad_at_the_field_table(dev, interp):
    """K2 and the fused K1 on the stage-2 field's table
    (run_nerfsynthetic_field.sh: log2_T 30, L16 F2, a dense 256^3 top
    level, E = 39,601,112 rows, 317 MB, offsets up to 79.2M floats):
    2^18 points, uniform and on the cube's corners and upper faces,
    which reach the last rows. The encode tet bit for bit and cube within
    1e-5 of the plain version; K1 within 1e-5 of max of the plain sum in
    float64."""
    from quadraturefields_tpu_torch.models.field import FieldConfig

    cfg = dataclasses.replace(
        FieldConfig(scale=0.5, log2_hashmap_size=30).hashgrid, interp=interp)
    assert cfg.total_entries == 39_601_112
    g = torch.Generator(device=dev).manual_seed(7)
    n = 1 << 18
    x = torch.rand((n, 3), generator=g, device=dev)
    x[:4096] = x[:4096].round()              # the cube's 8 corners
    x[4096:8192, 0] = 1.0                    # an upper face
    table = (torch.rand((cfg.total_entries, 2), generator=g, device=dev)
             * 2 - 1).requires_grad_(True)
    before = hg.ENCODE_KERNEL.launches, hg.ENCODE_BWD_KERNEL.launches
    out = hg.hashgrid_encode(table, x, cfg)
    want = hg.encode_plain(table.detach(), x, cfg)
    err = float((out.detach() - want).abs().max())
    assert err == 0.0 if interp == "tet" else err <= 1e-5
    cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
    (got,) = torch.autograd.grad(out, table, cot)
    torch.cuda.synchronize()
    assert (hg.ENCODE_KERNEL.launches, hg.ENCODE_BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want = hg.table_grad_plain(x, cot.double(), cfg)
    assert bool(want[-1].abs().sum() > 0)  # the last row is reached
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("interp", ["tet", "cube"])
def test_encode_and_table_grad_at_the_deformation_table(dev, interp):
    """K2 and the fused K1 on the stage-4 deformation field's table
    (run_nerfsynthetic_finetune.sh, Stage4Config.field_config(): log2_T
    24, L16 F2, max_res 512 x 1.5, E = 101,626,144 rows, 813 MB), at a
    step's width: 2 x 163,840 points (the hits and their barycentric
    samples at the 2^17 budget's pack cap), uniform, on the cube's
    corners and upper faces, and 4 points whose top-level corner hashes
    to the last row. The encode tet
    bit for bit and cube within 1e-5 of the plain version; K1 within
    1e-5 of max of the plain sum in float64."""
    from quadraturefields_tpu_torch.train.stage4_finetune import (
        Stage4Config,
    )

    scfg = Stage4Config()
    cfg = dataclasses.replace(scfg.field_config().hashgrid, interp=interp)
    assert cfg.total_entries == 101_626_144
    g = torch.Generator(device=dev).manual_seed(8)
    n = 2 * int(scfg.pack_cap)
    assert n == 327_680
    x = torch.rand((n, 3), generator=g, device=dev)
    x[:4096] = x[:4096].round()              # the cube's 8 corners
    x[4096:8192, 2] = 1.0                    # an upper face
    # the top levels are hashed (768^3 > 2^24 rows): the last row is
    # reached by the points whose top-level corner hashes to it, ~1 in
    # 4M uniform points; find a few and put them in
    last = []
    while sum(p.shape[0] for p in last) < 4:
        cand = torch.rand((1 << 21, 3), generator=g, device=dev)
        idx, _ = hg._corner_indices_weights(cand, cfg)
        last.append(cand[(idx == cfg.total_entries - 1).any(dim=1)])
    x[8192:8192 + 4] = torch.cat(last)[:4]
    table = (torch.rand((cfg.total_entries, 2), generator=g, device=dev)
             * 2 - 1).requires_grad_(True)
    before = hg.ENCODE_KERNEL.launches, hg.ENCODE_BWD_KERNEL.launches
    out = hg.hashgrid_encode(table, x, cfg)
    want = hg.encode_plain(table.detach(), x, cfg)
    err = float((out.detach() - want).abs().max())
    assert err == 0.0 if interp == "tet" else err <= 1e-5
    cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
    (got,) = torch.autograd.grad(out, table, cot)
    torch.cuda.synchronize()
    assert (hg.ENCODE_KERNEL.launches, hg.ENCODE_BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want = hg.table_grad_plain(x, cot.double(), cfg)
    assert bool(want[-1].abs().sum() > 0)  # the last row is reached
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_segment_sum_at_the_stage4_composite(dev):
    """K3 through presorted_row_segment_sum_vjp at the stage-4 packed
    composite's shape: 163,840 rows (the pack cap at 2^17), 131,072 hits
    sorted by ray over 49,152 rays with 1-6 hits each and some rays
    without any, the rest pad rows with key = n (dropped); 8-wide rows
    whose last 3 columns are 0. The forward within 1e-5 of max of the
    plain sum in float64, the backward (a gather) exactly the plain
    version's, 0 on the pads."""
    g = torch.Generator(device=dev).manual_seed(9)
    m, hits, n = 163_840, 131_072, 49_152
    keys = torch.randint(0, n, (hits,), generator=g, device=dev)
    keys = torch.cat([keys.sort().values,
                      torch.full((m - hits,), n, device=dev)]).int()
    vals = torch.rand((m, 8), generator=g, device=dev)
    vals[:, 5:] = 0.0
    vals.requires_grad_(True)
    before = hs.SEGMENT_SUM_KERNEL.launches
    got = hs.presorted_row_segment_sum_vjp(keys, vals, n)
    torch.cuda.synchronize()
    assert hs.SEGMENT_SUM_KERNEL.launches == before + 1
    want = hs.segment_sum_plain(keys, vals.detach().double(), n)
    assert float((got.detach() - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())
    assert int((want[:, 3] == 0).sum()) > 0  # rays without hits
    cot = torch.randn((n, 8), generator=g, device=dev)
    (dv,) = torch.autograd.grad(got, vals, cot)
    k = keys.long().clamp(0, n - 1)
    want_dv = torch.where((keys < n)[:, None], cot[k], 0.0)
    assert torch.equal(dv, want_dv)
    assert not dv[hits:].any()


@pytest.mark.parametrize("coverage", [1.0, 0.02])
def test_segment_sum_at_a_baked_chunk(dev, coverage):
    """K3 as the baked renderer calls it (presorted_row_segment_sum, no
    autograd) on a chunk's packed stream: 8192 rays, a `coverage` share
    of them hit, with 1-25 hits each (the cast's max_hits), sorted by
    ray; the stream at the adaptive cap (BakedRenderer._pack_cap: the
    sqrt(2) bucket at or above the hits, at least the rays), pads with
    key = n at the tail; 8-wide rows whose last 3 columns are 0. Within
    1e-5 of max of the plain sum in float64, the empty rays exactly 0."""
    from quadraturefields_tpu_torch.baking.stage6 import BakedRenderer

    g = torch.Generator(device=dev).manual_seed(11)
    n = 8192
    hit = torch.rand((n,), generator=g, device=dev) < coverage
    per_ray = torch.randint(1, 26, (n,), generator=g, device=dev) * hit
    total = int(per_ray.sum())
    m = BakedRenderer._pack_cap(n, total, None)
    assert total <= m and n <= m
    keys = torch.repeat_interleave(torch.arange(n, device=dev), per_ray)
    keys = torch.cat([keys, torch.full((m - total,), n, device=dev)]).int()
    vals = torch.rand((m, 8), generator=g, device=dev)
    vals[:, 5:] = 0.0
    before = hs.SEGMENT_SUM_KERNEL.launches
    got = hs.presorted_row_segment_sum(keys, vals, n)
    torch.cuda.synchronize()
    assert hs.SEGMENT_SUM_KERNEL.launches == before + 1
    want = hs.segment_sum_plain(keys, vals.double(), n)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    empty = per_ray == 0
    assert not got[empty].any()
    assert bool(empty.any()) == (coverage < 1.0)


def _surface_points(g, n, dev):
    """n points in [0, 1]^3 near a sphere of radius 0.25 around the
    centre (hits and texels lie on a surface), a tenth of them
    uniform."""
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    r = 0.25 + 0.01 * torch.randn((n, 1), generator=g, device=dev)
    x = 0.5 + r * d
    k = n // 10
    x[:k] = torch.rand((k, 3), generator=g, device=dev)
    return x.clamp(0.0, 1.0)


@pytest.mark.parametrize("interp", ["tet", "cube"])
def test_encode_at_a_bake_chunk_of_the_sg_grid(dev, interp):
    """K2 on one bake chunk of the SG model's grid
    (run_nerfsynthetic_fit_sg.sh: corner L16 F2 T2^19, 6,299,960 rows):
    2^18 texel positions on a surface. Tet bit for bit, cube within
    1e-5 of the plain version."""
    from quadraturefields_tpu_torch.train.stage5_fit_sg import Stage5Config

    cfg = dataclasses.replace(Stage5Config().sg_config().hashgrid,
                              interp=interp)
    assert cfg.total_entries == 6_299_960
    g = torch.Generator(device=dev).manual_seed(12)
    x = _surface_points(g, 1 << 18, dev)
    table = torch.rand((cfg.total_entries, 2), generator=g,
                       device=dev) * 2 - 1
    before = hg.ENCODE_KERNEL.launches
    with torch.no_grad():
        got = hg.hashgrid_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert hg.ENCODE_KERNEL.launches == before + 1
    err = float((got - hg.encode_plain(table, x, cfg)).abs().max())
    assert err == 0.0 if interp == "tet" else err <= 1e-5


def test_table_grad_at_a_stage5_step(dev):
    """The fused K1 through the encode's backward on a stage-5 step of
    the SG grid (tet, 6,299,960 rows): 2^18 hit positions on a surface
    and a cotangent whose rows are 0 for the pads' fifth. Within 1e-5
    of max of the plain sum in float64; one launch."""
    from quadraturefields_tpu_torch.train.stage5_fit_sg import Stage5Config

    cfg = Stage5Config().sg_config().hashgrid
    g = torch.Generator(device=dev).manual_seed(13)
    n = 1 << 18
    x = _surface_points(g, n, dev)
    table = (torch.rand((cfg.total_entries, 2), generator=g, device=dev)
             * 2 - 1).requires_grad_(True)
    cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
    cot[-n // 5:] = 0.0
    before = hg.ENCODE_BWD_KERNEL.launches
    (got,) = torch.autograd.grad(hg.hashgrid_encode(table, x, cfg), table,
                                 cot)
    torch.cuda.synchronize()
    assert hg.ENCODE_BWD_KERNEL.launches == before + 1
    want = hg.table_grad_plain(x, cot.double(), cfg)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_stage3_blur_takes_no_tf32(dev, monkeypatch):
    """Stage 3's Gaussian blur on the card within 1e-6 of a float64 blur
    on the host, with cuDNN's TF32 switch at its default (on): TF32's
    10-bit mantissa would put ~1e-4 into a grid that sin(100 q) then
    reads near its level set."""
    import numpy as np
    import torch.nn.functional as F
    from quadraturefields_tpu_torch.geometry.extract import (
        gaussian_kernel_1d, gaussian_smooth_3d)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    g = torch.Generator().manual_seed(3)
    n = 96
    x = torch.rand((n, n, n), generator=g) * 2 - 1
    got = gaussian_smooth_3d(x.to(dev)).cpu()
    k = torch.as_tensor(gaussian_kernel_1d().astype(np.float64))
    want = x.double()
    for axis in range(3):
        p = F.pad(want.movedim(axis, -1), (2, 2))
        want = sum(k[j] * p[..., j:j + n] for j in range(5)).movedim(-1, axis)
    assert float((got - want).abs().max()) <= 1e-6


def _ray_samples(g, n, n_pad, dev):
    """n samples in ray order: runs of 8-48 samples along straight lines
    (1/512 to 1/64 apart, clipped to the unit cube), the last n_pad of
    them padding at one position, as a renderer's sample budget holds
    them."""
    parts, total = [], 0
    while total < n - n_pad:
        k = int(torch.randint(8, 49, (1,), generator=g, device=dev))
        o = torch.rand((1, 3), generator=g, device=dev)
        d = torch.randn((1, 3), generator=g, device=dev)
        step = 2.0 ** -float(torch.randint(6, 10, (1,), generator=g,
                                           device=dev))
        t = torch.arange(k, device=dev, dtype=torch.float32)[:, None] * step
        parts.append((o + t * d / d.norm()).clamp(0.0, 1.0))
        total += k
    x = torch.cat(parts)[:n - n_pad]
    pad = torch.full((n_pad, 3), 0.5, device=dev)
    return torch.cat([x, pad]).contiguous()


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
@pytest.mark.parametrize("n_levels", [1, 16, 32])
def test_table_grad_kernel_ray_ordered(dev, interp, n_features, n_levels):
    """K1 on ray-ordered samples (warps whose lanes share rows on the
    coarse levels, merged before their atomics) with a padded budget
    (zero cotangents at one position, skipped), rows with one nonzero
    cotangent value among zeros (never skipped), ragged point groups
    (n not a multiple of 32) and level counts that are not a multiple of
    the 8 warps of a block: within 1e-5 of max |want|, want the plain
    version's sum in float64."""
    cfg = hg.HashGridConfig(n_levels=n_levels, n_features=n_features,
                            log2_hashmap_size=12, base_resolution=4,
                            per_level_scale=1.25, interp=interp)
    g = torch.Generator(device=dev).manual_seed(n_levels + n_features)
    for n, n_pad in ((20001, 3001), (33, 0), (70, 40)):
        x = _ray_samples(g, n, n_pad, dev)
        cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
        cot[n - n_pad:] = 0.0
        one = cot[: n // 3].reshape(-1, n_levels, n_features)
        one[:, :, 1:] = 0.0
        before = hg.ENCODE_BWD_KERNEL.launches
        got = hg.table_grad_kernel(x, cot, cfg)
        _check_rel(got, hg.table_grad_plain(x, cot.double(), cfg))
        assert hg.ENCODE_BWD_KERNEL.launches == before + 1


@pytest.mark.parametrize("n_entries", [5000, 4_500_000])
def test_pairs_kernel_matches_plain(dev, n_entries):
    """The pair segment sum (K1's stream interface, on K8's kernel with
    rounding off): heavy duplicates (a thirty-second of the stream on 37
    entries, ~250 each: the load of a coarse dense level's rows at 2^18
    points, where neighbouring lanes repeat and merge), int32 and int64
    indices, a stream length that is not a multiple of the 256-thread
    block, and a small gradient and one of 36 MB (near the L2's size):
    within 1e-5 of max |want|, want being the plain version's sum in
    float64 (the atomics add in a varying order, and an f32 sum's
    rounding grows with the number of terms per entry)."""
    g = torch.Generator(device=dev).manual_seed(3)
    m = 300001
    idx = torch.randint(0, n_entries, (m,), generator=g, device=dev)
    idx[: m // 32] = torch.randint(0, 37, (m // 32,), generator=g,
                                   device=dev)
    v0 = torch.randn((m,), generator=g, device=dev)
    v1 = torch.randn((m,), generator=g, device=dev)
    want = hs.table_grad_pairs_plain(idx, v0.double(), v1.double(),
                                     n_entries)
    for ix in (idx, idx.int()):
        got = hs.sorted_table_grad(ix, v0, v1, n_entries)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
        assert float(got[:37].abs().min()) > 0


def _value_stream(g, m, n_rows, dev, ordered):
    """K8's (row, lane0, v0, v1) of m contributions into n_rows rows of
    the value layout: uniform, or in runs of 1-40 equal entries (the
    coarse levels' rows along rays, which a warp merges); a thirtieth of
    the pairs zero (skipped), 50 rows past the table and 50 negative
    (dropped)."""
    rows = torch.randint(0, n_rows, (m,), generator=g, device=dev)
    lane0 = torch.randint(0, 64, (m,), generator=g, device=dev) * 2
    if ordered:
        lengths = torch.randint(1, 41, (m,), generator=g, device=dev)
        rows = rows.repeat_interleave(lengths)[:m].contiguous()
        lane0 = lane0.repeat_interleave(lengths)[:m].contiguous()
    rows[100:150] = n_rows + 7
    rows[150:200] = -2
    v0 = torch.randn((m,), generator=g, device=dev)
    v1 = torch.randn((m,), generator=g, device=dev)
    v0[::30] = 0.0
    v1[::30] = 0.0
    return rows, lane0, v0, v1


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("total_values", [128 * 3000 + 64,
                                          128 * 80000 + 64])
def test_k8_kernel_matches_plain(dev, ordered, total_values):
    """K8's interface (hashgrid_backward.sorted_table_grad) is one launch
    of qf_table_grad_values, with int32, int64 and mixed ids, a stream
    length that is not a multiple of the 256-thread block and a value
    count that is not a multiple of 128, on uniform and ray-ordered
    streams, into a gradient of 1.5 MB and one of 41 MB: within 1e-5 of
    max |want|, want the plain
    version (entries, bf16 rounding, index_add_) summed in float64."""
    g = torch.Generator(device=dev).manual_seed(7 + ordered)
    m = 300001
    rows, lane0, v0, v1 = _value_stream(g, m, -(-total_values // 128), dev,
                                        ordered)
    want = hb.table_grad_values_plain(rows, lane0, v0.double(), v1.double(),
                                      total_values)
    for r, ln in ((rows, lane0), (rows.int(), lane0.int()),
                  (rows, lane0.int())):
        before = (hb.TABLE_GRAD_VALUES_KERNEL.launches,
                  hs.TABLE_GRAD_PAIRS_KERNEL.launches)
        got = hb.sorted_table_grad(r, ln, v0, v1, total_values)
        assert got.shape == (total_values,)
        _check_rel(got, want)
        assert (hb.TABLE_GRAD_VALUES_KERNEL.launches,
                hs.TABLE_GRAD_PAIRS_KERNEL.launches) == (before[0] + 1,
                                                         before[1])


def test_segment_sum_kernel_refuses_autograd(dev):
    """The forward kernel records no gradient, so it raises under
    autograd; the VJP wrapper launches it and its gather backward
    matches the plain path's."""
    keys = torch.arange(64, device=dev, dtype=torch.int32) // 4
    vals = torch.randn((64, 8), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError):
        hs.segment_sum_kernel(keys, vals, 16)
    before = hs.SEGMENT_SUM_KERNEL.launches
    out = hs.presorted_row_segment_sum_vjp(keys, vals, 16)
    cot = torch.randn_like(out)
    (dv,) = torch.autograd.grad(out, vals, cot)
    assert hs.SEGMENT_SUM_KERNEL.launches == before + 1
    assert torch.equal(dv, cot[keys.long()])


def _cell_stream(dev, m, n_entries, seed):
    """Entries with heavy duplicates (a thirty-second of the stream on 37
    rows) and 100 past the table, which the kernels and plain versions
    drop."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, n_entries, (m,), generator=g, device=dev)
    idx[: m // 32] = torch.randint(0, 37, (m // 32,), generator=g,
                                   device=dev)
    idx[m // 32:m // 32 + 100] = n_entries + 3
    return g, idx


def _f64(args):
    return [a.double() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]


def _check_rel(got, want):
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("rw", [8, 16, 32, 64, 128])
def test_cell_row_grad_kernel_matches_plain(dev, rw):
    """K5 through sorted_row_grad, int32 and int64 entries, with rows of
    zeros among them (skipped): within 1e-5 of max |want|, want the
    plain version's sum in float64 (the atomics add in a varying
    order)."""
    m, n_entries = 200001, 3000
    g, idx = _cell_stream(dev, m, n_entries, rw)
    vals = torch.randn((m, rw), generator=g, device=dev)
    vals[5000:6000] = 0.0
    want = hs.row_grad_plain(idx, vals.double(), n_entries)
    for ix in (idx, idx.int()):
        before = hs.CELL_ROW_GRAD_KERNEL.launches
        got = hs.sorted_row_grad(ix, vals, n_entries)
        _check_rel(got, want)
        assert hs.CELL_ROW_GRAD_KERNEL.launches == before + 1


# the streams of K6's and K7's stream entries: "mixed" (_cell_stream's);
# every contribution on one row (20001 of them: a float32 sum of 150001
# N(0, 1) values in any order is off by up to ~1.4e-5 of max, past the
# limit, so the case holds the kernels to the plain version and not
# float32 to float64); only entries outside [0, E); all-zero values;
# M = 0; an odd E whose last row takes a run of 1000
STREAM_CASES = ["mixed", "one_row", "out_of_range", "zeros", "empty",
                "last_row"]


def _stream_case(case, dev, seed):
    """(generator, idx, E) of a STREAM_CASES case; the values are the
    caller's (zero for "zeros")."""
    m, n_entries = 150001, 2000
    if case == "last_row":
        n_entries = 2001
    g, idx = _cell_stream(dev, m, n_entries, seed)
    if case == "last_row":
        idx[:1000] = n_entries - 1
    if case == "one_row":
        idx = idx[:20001]
        idx.fill_(n_entries // 2)
    if case == "out_of_range":
        idx = torch.where(idx % 2 == 0, idx + n_entries, -1 - idx)
    if case == "empty":
        idx = idx[:0]
    return g, idx, n_entries


def _check_case(case, got, want):
    """Within 1e-5 of max |want| (want in float64), exactly 0 where the
    stream adds nothing."""
    if case in ("out_of_range", "zeros", "empty"):
        torch.cuda.synchronize()
        assert float(want.abs().max()) == 0.0
        assert int(torch.count_nonzero(got)) == 0
    else:
        _check_rel(got, want)


@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("pw", [2, 8, 16, 64])
def test_cell_pair_grad_kernel_matches_plain(dev, pw, case):
    """K6 through sorted_pair_grad: each value rounded to bf16 in the
    kernel as in the plain version, column 2k from lo, 2k+1 from hi;
    int32 and int64 entries; one launch a call (none at M = 0)."""
    g, idx, n_entries = _stream_case(case, dev, pw)
    m = idx.shape[0]
    lo = torch.randn((m, pw), generator=g, device=dev)
    hi = torch.randn((m, pw), generator=g, device=dev)
    if case == "zeros":
        lo.zero_()
        hi.zero_()
    want = hs.pair_grad_plain(idx, lo.double(), hi.double(), n_entries)
    for ix in (idx, idx.int()):
        before = hs.CELL_PAIR_GRAD_KERNEL.launches
        got = hs.sorted_pair_grad(ix, lo, hi, n_entries)
        _check_case(case, got, want)
        assert hs.CELL_PAIR_GRAD_KERNEL.launches == before + (m > 0)


@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("n_features", [2, 4, 8, 16])
def test_cell_factor_grad_kernel_matches_plain(dev, n_features, case):
    """K7's stream entry through sorted_tet_factor_grad: factors and
    products rounded to bf16 as in the plain version, at the slots (0,
    c1, c2, 7); slots outside 0..7 add nothing; F = 2 included; heavy
    duplicates take the warp-aggregated path; int32 and int64 entries;
    one launch a call (none at M = 0)."""
    g, idx, n_entries = _stream_case(case, dev, n_features)
    m = idx.shape[0]
    wk = torch.rand((m, 4), generator=g, device=dev)
    c1 = torch.randint(1, 7, (m,), generator=g, device=dev)
    c2 = (c1 - 1 + torch.randint(1, 6, (m,), generator=g, device=dev)) % 6 + 1
    c1[-50:] = 9
    c2[-100:-50] = -1
    c1, c2 = c1.int(), c2.int()
    cot = torch.randn((m, n_features), generator=g, device=dev)
    if case == "zeros":
        cot.zero_()
    want = hs.tet_factor_grad_plain(idx, wk.double(), c1, c2, cot.double(),
                                    n_entries)
    for ix in (idx, idx.int()):
        before = hs.CELL_FACTOR_GRAD_KERNEL.launches
        got = hs.sorted_tet_factor_grad(ix, wk, c1, c2, cot, n_entries)
        _check_case(case, got, want)
        assert hs.CELL_FACTOR_GRAD_KERNEL.launches == before + (m > 0)


@pytest.mark.parametrize("n_features", [2, 4, 8, 16])
def test_cell_factor_grad_x_kernel_matches_plain(dev, n_features):
    """The fused K7 from positions through tet_factor_grad_x, on uniform
    points and on runs of equal points (warp-aggregated rows), with a
    ragged warp and zero cotangent rows (skipped), and on a few hundred
    knots, upper-face points and rank ties (the in-kernel cell math's
    floor, clamp, clip and tie-break, with few contributions per row, so
    that one wrong slot cannot hide under the limit), on one dense and
    two hashed levels: within 1e-5 of max |want|, want the plain
    version's sum in float64 (the atomics add in a varying order)."""
    cfg = hg.HashGridConfig.from_max_resolution(
        256, n_levels=3, n_features=n_features, log2_hashmap_size=12,
        interp="tet", layout="cell", grad_mode="sorted",
        grad_payload="bf16factor")
    dense = [(r - 1) ** 3 <= s for r, s in zip(cfg.level_resolutions,
                                               cfg.level_sizes)]
    assert dense == [True, False, False]
    g = torch.Generator(device=dev).manual_seed(n_features)
    n = 50001
    edges = knots_faces_ties(torch, cfg, g, dev)
    fracs = [frac for _, frac in hg._cell_levels(edges, cfg)]
    assert all(bool((f == 0).all(dim=1).any()) for f in fracs)
    assert all(bool((f == 1).any()) for f in fracs)
    for x in (torch.rand((n, 3), generator=g, device=dev),
              _runs(g, n, dev), edges):
        m = x.shape[0]
        cot = torch.randn((m, cfg.output_dim), generator=g, device=dev)
        cot[m // 50:m // 25] = 0.0
        before = hg.CELL_FACTOR_GRAD_X_KERNEL.launches
        got = hg.tet_factor_grad_x(x, cot, cfg)
        _check_rel(got, hg.tet_factor_grad_x_plain(x, cot.double(), cfg))
        assert hg.CELL_FACTOR_GRAD_X_KERNEL.launches == before + 1


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("payload", ["f32", "bf16sim"])
@pytest.mark.parametrize("n_features", [2, 4, 8, 16])
def test_cell_row_grad_x_kernel_matches_plain(dev, interp, payload,
                                              n_features):
    """K5's fused entry through cell_row_grad_x, tet and cube, f32
    products and products rounded to bf16, on uniform points, on runs of
    equal points (warp-aggregated rows; at F = 2 two cube slots share a
    float4 chunk), with a ragged warp and zero cotangent rows (skipped),
    and on knots, upper faces and rank ties, on one dense and two hashed
    levels: within 1e-5 of max |want|, want the plain version's sum in
    float64 of the same f32 (and bf16) products."""
    cfg = hg.HashGridConfig.from_max_resolution(
        256, n_levels=3, n_features=n_features, log2_hashmap_size=12,
        interp=interp, layout="cell", grad_mode="sorted",
        grad_payload=payload)
    g = torch.Generator(device=dev).manual_seed(n_features)
    n = 50001
    for x in (torch.rand((n, 3), generator=g, device=dev),
              _runs(g, n, dev), knots_faces_ties(torch, cfg, g, dev)):
        m = x.shape[0]
        cot = torch.randn((m, cfg.output_dim), generator=g, device=dev)
        cot[m // 50:m // 25] = 0.0
        before = hg.CELL_ROW_GRAD_X_KERNEL.launches
        got = hg.cell_row_grad_x(x, cot, cfg)
        _check_rel(got, hg.cell_row_grad_x_plain(x, cot.double(), cfg))
        assert hg.CELL_ROW_GRAD_X_KERNEL.launches == before + 1


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [2, 4, 8, 16])
def test_cell_pair_grad_x_kernel_matches_plain(dev, interp, n_features):
    """K6's fused entry through cell_pair_grad_x, tet and cube, every
    product rounded to bf16, on uniform points, on runs of equal points
    (warp-aggregated rows), with a ragged warp and zero cotangent rows
    (skipped), and on knots, upper faces and rank ties, on one dense and
    two hashed levels: within 1e-5 of max |want|, want the plain
    version's sum in float64 of the same bf16 products."""
    cfg = hg.HashGridConfig.from_max_resolution(
        256, n_levels=3, n_features=n_features, log2_hashmap_size=12,
        interp=interp, layout="cell", grad_mode="sorted",
        grad_payload="bf16pair")
    g = torch.Generator(device=dev).manual_seed(n_features + 40)
    n = 50001
    for x in (torch.rand((n, 3), generator=g, device=dev),
              _runs(g, n, dev), knots_faces_ties(torch, cfg, g, dev)):
        m = x.shape[0]
        cot = torch.randn((m, cfg.output_dim), generator=g, device=dev)
        cot[m // 50:m // 25] = 0.0
        before = hg.CELL_PAIR_GRAD_X_KERNEL.launches
        got = hg.cell_pair_grad_x(x, cot, cfg)
        _check_rel(got, hg.cell_pair_grad_x_plain(x, cot.double(), cfg))
        assert hg.CELL_PAIR_GRAD_X_KERNEL.launches == before + 1


def test_cell_backward_runs_the_fused_factor_kernel(dev, monkeypatch):
    """On the card the cell encode's backward on K7's route launches the
    fused entry once and builds no contribution stream: neither
    _cell_tet_levels nor the stream entry runs."""
    cfg = hg.HashGridConfig.from_max_resolution(
        512, n_levels=2, n_features=4, log2_hashmap_size=12, interp="tet",
        layout="cell", grad_mode="sorted", grad_payload="bf16factor")

    def no_stream(*a):
        raise AssertionError("the backward built K7's stream")

    monkeypatch.setattr(hg, "_cell_tet_levels", no_stream)
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.zeros((cfg.total_entries, 32), device=dev,
                        requires_grad=True)
    x = torch.rand((20000, 3), generator=g, device=dev)
    cot = torch.randn((20000, cfg.output_dim), generator=g, device=dev)
    fused, stream = hg.CELL_FACTOR_GRAD_X_KERNEL, hs.CELL_FACTOR_GRAD_KERNEL
    before = (fused.launches, stream.launches)
    (got,) = torch.autograd.grad(hg.hashgrid_encode(table, x, cfg), table,
                                 cot)
    assert (fused.launches, stream.launches) == (before[0] + 1, before[1])
    _check_rel(got, hg.tet_factor_grad_x_plain(x, cot.double(), cfg))


@pytest.mark.parametrize("mode,payload,n_features,name", [
    ("auto", "bf16factor", 4, "tet_factor_grad_x_kernel"),
    ("sorted", "bf16pair", 4, "cell_pair_grad_x_kernel"),
    ("sorted", "bf16pair", 2, "cell_pair_grad_x_kernel"),
    ("sorted", "f32", 4, "cell_row_grad_x_kernel"),
    ("exact", "bf16sim", 4, "cell_row_grad_x_kernel"),
    ("sorted", "bf16factor", 2, "cell_row_grad_x_kernel"),
    ("sorted", "f32", 1, "row_grad_kernel"),
])
def test_cell_encode_backward_launches_its_kernel(dev, mode, payload,
                                                  n_features, name,
                                                  monkeypatch):
    """The cell encode's table gradient on the card takes JAX's route
    (`auto` is sorted here: 3 * E < n * L) and launches exactly that one
    kernel (K7, K6 and K5 through their fused entries; K5's stream entry
    only for an F the fused entry does not take), whose output lies
    within 1e-5 of max |want| of the plain version summed in float64 on
    the inputs it was given."""
    cfg = hg.HashGridConfig.from_max_resolution(
        512, n_levels=2, n_features=n_features, log2_hashmap_size=12,
        interp="tet", layout="cell", grad_mode=mode, grad_payload=payload)
    n = 20000
    assert cfg.total_entries * 3 < n * cfg.n_levels
    g = torch.Generator(device=dev).manual_seed(4)
    table = (torch.rand((cfg.total_entries, 8 * n_features), generator=g,
                        device=dev) * 2 - 1).requires_grad_(True)
    x = torch.rand((n, 3), generator=g, device=dev)
    cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
    calls = []
    mod = hs if name == "row_grad_kernel" else hg
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(a) or real(*a))
    kernels = {"row_grad_kernel": hs.CELL_ROW_GRAD_KERNEL,
               "pair_grad_kernel": hs.CELL_PAIR_GRAD_KERNEL,
               "tet_factor_grad_x_kernel": hg.CELL_FACTOR_GRAD_X_KERNEL,
               "cell_row_grad_x_kernel": hg.CELL_ROW_GRAD_X_KERNEL,
               "cell_pair_grad_x_kernel": hg.CELL_PAIR_GRAD_X_KERNEL}
    before = {k: v.launches for k, v in kernels.items()}
    (got,) = torch.autograd.grad(hg.hashgrid_encode(table, x, cfg), table,
                                 cot)
    assert len(calls) == 1
    plain = {"tet_factor_grad_x_kernel": hg.tet_factor_grad_x_plain,
             "row_grad_kernel": hs.row_grad_plain,
             "cell_row_grad_x_kernel": hg.cell_row_grad_x_plain,
             "cell_pair_grad_x_kernel": hg.cell_pair_grad_x_plain}[name]
    _check_rel(got, plain(*_f64(calls[0])))
    launched = {k: v.launches - before[k] for k, v in kernels.items()}
    assert launched == {k: int(k == name) for k in kernels}


@pytest.mark.parametrize("layout,stream", [
    ("corner", "table_grad_pairs_kernel"),
    ("cell", "row_grad_kernel"),
])
def test_second_order_stream_matches_f64(dev, layout, stream, monkeypatch):
    """back_prop=True on the card: the field's eikonal-style loss through
    field_with_grad differentiates the encode's position gradient again,
    and its table gradient goes to K1's stream interface (corner) or K5's
    stream entry (cell), once; the kernel's output lies within 1e-5 of
    max of index_add_ of the same stream in float64."""
    from quadraturefields_tpu_torch.models import field as fm

    cfg = fm.FieldConfig(scale=0.5, log2_hashmap_size=14, n_levels=8,
                         max_resolution=128, hidden_size=16, interp="tet",
                         layout=layout, back_prop=True)
    g = torch.Generator(device=dev).manual_seed(6)
    params = fm.field_init(g, cfg, dev)
    params["table"] = (params["table"] * 1e3).requires_grad_(True)
    x = torch.rand((8192, 3), generator=g, device=dev) - 0.5
    calls = []
    real = getattr(hs, stream)

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(hs, stream, recording)
    _, grad = fm.field_with_grad(params, x, cfg)
    ((grad.norm(dim=1) - 1.0) ** 2).mean().backward()
    assert len(calls) == 1
    (idx, *vals, e), got = calls[0]
    vals = torch.stack(vals, 1) if len(vals) == 2 else vals[0]
    want = torch.zeros((e, vals.shape[1]), dtype=torch.float64, device=dev)
    want.index_add_(0, idx.long(), vals.double())
    assert float(want.abs().max()) > 0
    _check_rel(got, want)
