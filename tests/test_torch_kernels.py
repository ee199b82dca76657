"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test builds its kernel from csrc/ (nvcc, sm_90a) and compares it
with the plain version on the same CUDA tensors, on the edge cases that
random main-path inputs rarely reach: the encode, its fused table
gradient, the pair segment sum, the occupancy bits and the per-ray
segment sum. Without a card every test skips:
a CUDA kernel has no CPU mode. The file imports no jax, so on a host
without jax it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""
import pytest
import torch

from quadraturefields_tpu_torch.ops import hashgrid as hg
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


def test_pairs_kernel_matches_plain(dev):
    """The pair segment sum (K1's and K8's interface): heavy duplicates
    (a thirty-second of the stream on 37 entries, ~250 each: the load of
    a coarse dense level's rows at 2^18 points), int32 and int64
    indices, and a stream length that is not a multiple of the
    256-thread block: within 1e-5 of max |want|, want being the plain
    version's sum in float64 (the atomics add in a varying order, and
    an f32 sum's rounding grows with the number of terms per entry)."""
    g = torch.Generator(device=dev).manual_seed(3)
    m, n_entries = 300001, 5000
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
