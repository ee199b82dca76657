"""The port's table gradients against the JAX package's, on the same
seeded numpy inputs: the encode VJP (table and positions, also on
ray-ordered samples with a padded budget), K1's interface
(sorted_table_grad), K8's interface (the bf16 value-space
form), the stochastic corner gradient and the VJP of the presorted
segment sum. JAX runs on the CPU,
its Pallas kernels in interpret mode as its own tests run them; the
port runs each kernel's plain PyTorch version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.ops import hashgrid as jhg
from quadraturefields_tpu.ops import hashgrid_backward as jhb
from quadraturefields_tpu.ops import hashgrid_sorted as jhs
from quadraturefields_tpu_torch.ops import hashgrid as thg
from quadraturefields_tpu_torch.ops import hashgrid_backward as thb
from quadraturefields_tpu_torch.ops import hashgrid_sorted as ths

torch.set_num_threads(1)


def _grid_kw(interp, n_features, grad_mode):
    return dict(n_levels=4, n_features=n_features, log2_hashmap_size=10,
                base_resolution=4, per_level_scale=2.0, interp=interp,
                grad_mode=grad_mode)


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("n_features", [1, 2, 4])
def test_encode_vjp_matches_jax(interp, n_features):
    """d_table within rel 1e-5 of max |d_table| (f32 sums in another
    order) and d_x within atol 1e-4 of jax.vjp of the "exact" encode;
    the port's default "auto" mode gives the same function."""
    jcfg = jhg.HashGridConfig(**_grid_kw(interp, n_features, "exact"))
    tcfg = thg.HashGridConfig(**_grid_kw(interp, n_features, "auto"))
    rng = np.random.default_rng(n_features)
    table = rng.uniform(-1, 1, (jcfg.total_entries, n_features)) \
        .astype(np.float32)
    x = rng.uniform(0.02, 0.98, (700, 3)).astype(np.float32)
    g = rng.normal(size=(700, jcfg.output_dim)).astype(np.float32)

    out_j, pull = jax.vjp(lambda t, xx: jhg.hashgrid_encode(t, xx, jcfg),
                          jnp.asarray(table), jnp.asarray(x))
    dt_j, dx_j = (np.asarray(a) for a in pull(jnp.asarray(g)))

    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out_t = thg.hashgrid_encode(tt, tx, tcfg)
    dt_t, dx_t = torch.autograd.grad(out_t, (tt, tx), torch.tensor(g))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    scale = np.abs(dt_j).max()
    assert np.abs(dt_t.numpy() - dt_j).max() <= 1e-5 * scale
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["exact", "sorted"])
def test_grad_modes_share_one_function(mode):
    """"exact" and "sorted" give the "auto" gradient bit for bit."""
    kw = _grid_kw("tet", 2, "auto")
    rng = np.random.default_rng(3)
    cfg = thg.HashGridConfig(**kw)
    table = torch.tensor(
        rng.uniform(-1, 1, (cfg.total_entries, 2)).astype(np.float32),
        requires_grad=True)
    x = torch.tensor(rng.uniform(0, 1, (300, 3)).astype(np.float32))

    def grad(m):
        c = thg.HashGridConfig(**dict(kw, grad_mode=m))
        return torch.autograd.grad(
            (thg.hashgrid_encode(table, x, c) ** 2).sum(), table)[0]

    assert torch.equal(grad(mode), grad("auto"))


def test_hash_u01_matches_jax_bit_for_bit():
    """_hash_u01 of the clipped positions equals JAX's bit for bit, on
    random points inside and outside the unit cube and on 0, 1 and -0.0
    (torch.clamp keeps -0.0 where jnp.clip gives +0.0; _clip01 follows
    JAX)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.3, 1.3, (5000, 3)).astype(np.float32)
    x[:6] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-0.0, -0.0, -0.0],
             [-0.0, 0.5, 1.0], [1.0, -0.0, 0.25], [-2.0, 3.0, -0.0]]
    assert np.signbit(x[2]).all()
    want = np.asarray(jhg._hash_u01(jnp.clip(jnp.asarray(x), 0.0, 1.0), 16))
    got = thg._hash_u01(thg._clip01(torch.tensor(x)), 16).numpy()
    assert got.shape == want.shape == (16, 5000)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the raw bits too, -0.0 unclipped
    want = np.asarray(jhg._hash_u01(jnp.asarray(x), 5))
    got = thg._hash_u01(torch.tensor(x), 5).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _jax_picks(x, cfg):
    """JAX's stochastic pick (ops/hashgrid.py:791-812) with its own
    functions: the picked row [N, L], u [N, L] and the cumulative
    weights [N, L, C]."""
    n, L, C = x.shape[0], cfg.n_levels, cfg.corners
    xc = jnp.clip(jnp.asarray(x), 0.0, 1.0)
    idx, w = jhg._corner_indices_weights(xc, cfg)
    u = np.asarray(jhg._hash_u01(xc, L)).T
    cdf = np.asarray(jnp.cumsum(w.reshape(n, L, C), axis=2))
    sel = (u[:, :, None] >= cdf[:, :, :C - 1]).sum(axis=2)
    rows = np.take_along_axis(np.asarray(idx).reshape(n, L, C),
                              sel[:, :, None], axis=2)[:, :, 0]
    return rows, u, cdf


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("n_features", [2, 4])
def test_stochastic_grad_matches_jax(interp, n_features):
    """grad_mode "stochastic": the picks equal JAX's on every (point,
    level) but those where u lies within 2 ulp of a cumulative weight
    (f32 sums of JAX's cumsum and of the port's running sum may differ
    there); such ties are counted and must be rare. The table gradient
    within 1e-5 of max |d_table| of jax.vjp of the stochastic encode,
    d_x within 1e-4 (the exact pullback, as in JAX)."""
    jcfg = jhg.HashGridConfig(**_grid_kw(interp, n_features, "stochastic"))
    tcfg = thg.HashGridConfig(**_grid_kw(interp, n_features, "stochastic"))
    rng = np.random.default_rng(20 + n_features)
    n = 3000
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    table = rng.uniform(-1, 1, (jcfg.total_entries, n_features)) \
        .astype(np.float32)
    g = rng.normal(size=(n, jcfg.output_dim)).astype(np.float32)

    want, u, cdf = _jax_picks(x, jcfg)
    got = thg.stochastic_picks_plain(torch.tensor(x), tcfg).numpy()
    differ = got != want
    ulp = np.spacing(np.abs(cdf[:, :, :-1]).astype(np.float32))
    near = (np.abs(u[:, :, None] - cdf[:, :, :-1]) <= 2 * ulp).any(axis=2)
    assert not (differ & ~near).any()
    assert differ.sum() <= 1e-3 * differ.size, differ.sum()

    _, pull = jax.vjp(lambda t, xx: jhg.hashgrid_encode(t, xx, jcfg),
                      jnp.asarray(table), jnp.asarray(x))
    dt_j, dx_j = (np.asarray(a) for a in pull(jnp.asarray(g)))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    dt_t, dx_t = torch.autograd.grad(thg.hashgrid_encode(tt, tx, tcfg),
                                     (tt, tx), torch.tensor(g))
    # no tie falls among these points, so the sums hold the same picks
    assert np.abs(dt_t.numpy() - dt_j).max() <= 1e-5 * np.abs(dt_j).max()
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=0, atol=1e-4)
    # the same picks, summed: the plain stochastic sum of the picked rows
    ref = np.zeros_like(table, dtype=np.float64)
    np.add.at(ref, got.reshape(-1), g.reshape(-1, n_features))
    assert np.abs(dt_t.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_stochastic_grad_is_unbiased():
    """Averaged over many fresh point draws, the stochastic table
    gradient converges to the exact one (JAX's
    tests/test_hashgrid.py::test_grad_mode_stochastic_unbiased, at its
    sizes and bound)."""
    kw = dict(n_levels=3, log2_hashmap_size=6, base_resolution=4,
              per_level_scale=2.0, interp="tet")
    cfg_e = thg.HashGridConfig(grad_mode="exact", **kw)
    cfg_s = thg.HashGridConfig(grad_mode="stochastic", **kw)
    gen = torch.Generator().manual_seed(0)
    table = thg.hashgrid_init(gen, cfg_e).requires_grad_(True)
    acc_s = torch.zeros_like(table)
    acc_e = torch.zeros_like(table)
    for _ in range(150):
        xr = torch.rand((1024, 3), generator=gen)
        for cfg, acc in ((cfg_s, acc_s), (cfg_e, acc_e)):
            acc += torch.autograd.grad(
                thg.hashgrid_encode(table, xr, cfg).sum(), table)[0]
    rel = float(torch.linalg.norm(acc_s - acc_e) / torch.linalg.norm(acc_e))
    assert rel < 0.05, rel


def _ray_samples(rng, n, n_pad):
    """n samples in ray order: runs of 8-48 samples along straight lines
    (1/512 to 1/64 apart, clipped to the unit cube), the last n_pad of
    them padding at one position, as a renderer's sample budget holds
    them."""
    parts, total = [], 0
    while total < n - n_pad:
        k = int(rng.integers(8, 49))
        d = rng.normal(size=3)
        t = np.arange(k)[:, None] * 2.0 ** -int(rng.integers(6, 10))
        parts.append(np.clip(rng.random(3) + t * d / np.linalg.norm(d), 0, 1))
        total += k
    x = np.concatenate(parts)[:n - n_pad]
    return np.concatenate([x, np.full((n_pad, 3), 0.5)]).astype(np.float32)


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("n_features", [1, 2, 4])
def test_table_grad_ray_ordered_padded_matches_jax(interp, n_features):
    """The corner table gradient (K1's function) on the inputs its card
    kernel merges and skips: ray-ordered samples, a padded budget at one
    position with zero cotangents, and rows with a single nonzero
    cotangent value. The port's encode VJP (the plain sum on the CPU)
    within 1e-5 of max |d_table| of jax.vjp of the "exact" encode; the
    padding adds nothing, so the rows that only it touches stay zero."""
    jcfg = jhg.HashGridConfig(**_grid_kw(interp, n_features, "exact"))
    tcfg = thg.HashGridConfig(**_grid_kw(interp, n_features, "auto"))
    rng = np.random.default_rng(n_features + 10)
    n, n_pad = 1000, 200
    x = _ray_samples(rng, n, n_pad)
    g = rng.normal(size=(n, jcfg.output_dim)).astype(np.float32)
    g[n - n_pad:] = 0.0
    g[:n // 3].reshape(-1, 4, n_features)[:, :, 1:] = 0.0
    table = rng.uniform(-1, 1, (jcfg.total_entries, n_features)) \
        .astype(np.float32)
    _, pull = jax.vjp(lambda t: jhg.hashgrid_encode(t, jnp.asarray(x), jcfg),
                      jnp.asarray(table))
    (dt_j,) = (np.asarray(a) for a in pull(jnp.asarray(g)))
    tt = torch.tensor(table, requires_grad=True)
    (dt_t,) = torch.autograd.grad(
        thg.hashgrid_encode(tt, torch.tensor(x), tcfg), tt, torch.tensor(g))
    dt_t = dt_t.numpy()
    assert np.abs(dt_t - dt_j).max() <= 1e-5 * np.abs(dt_j).max()
    idx, _ = thg._corner_indices_weights(torch.tensor(x), tcfg)
    live = np.zeros(tcfg.total_entries, bool)
    live[idx[:n - n_pad].reshape(-1).numpy()] = True
    pad_only = np.setdiff1d(idx[n - n_pad:].reshape(-1).numpy(),
                            np.flatnonzero(live))
    assert pad_only.size > 0
    assert np.all(dt_t[pad_only] == 0.0) and np.all(dt_j[pad_only] == 0.0)


def _pairs_case(m, total_entries, seed, kind="uniform"):
    rng = np.random.default_rng(seed)
    W = jhs.W
    if kind == "uniform":
        idx = rng.integers(0, total_entries, m)
    elif kind == "spanning":
        lo = rng.integers(0, 64 * W // 2, m // 2)
        hi = rng.integers(64 * W * 7, 64 * W * 8, m - m // 2)
        idx = np.concatenate([lo, hi])
    else:  # duplicate-heavy
        idx = rng.integers(0, 37, m)
    idx = idx.astype(np.int32)
    v0 = rng.normal(size=m).astype(np.float32)
    v1 = rng.normal(size=m).astype(np.float32)
    return idx, v0, v1


@pytest.mark.parametrize(
    "m,total_entries,kind",
    [
        (jhs.TILE, 64 * jhs.W * 2, "uniform"),
        (jhs.TILE * 3 + 517, 64 * jhs.W * 5, "uniform"),
        (1000, 64 * 8, "uniform"),
        (2 * jhs.TILE, 64 * jhs.W * 8, "spanning"),
        (2 * jhs.TILE, 64 * jhs.W, "duplicates"),
        (jhs.TILE + 1, 64 * jhs.W + 77, "uniform"),
    ],
)
def test_sorted_table_grad_matches_jax_k1(m, total_entries, kind):
    """The port's K1 interface (plain: one index_add_) against JAX's K1
    in interpret mode, on the cases of tests/test_hashgrid_sorted.py and
    a tail that is not a multiple of the 8192-contribution tile: within
    1e-5 of max |want| (f32 sums in another order)."""
    idx, v0, v1 = _pairs_case(m, total_entries, m, kind)
    want = np.asarray(jhs.sorted_table_grad(
        jnp.asarray(idx), jnp.asarray(v0), jnp.asarray(v1), total_entries))
    got = ths.sorted_table_grad(torch.tensor(idx), torch.tensor(v0),
                                torch.tensor(v1), total_entries).numpy()
    assert got.shape == want.shape == (total_entries, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if kind == "spanning":
        assert np.all(got[64 * jhs.W:64 * jhs.W * 7] == 0.0)


@pytest.mark.parametrize(
    "m,total_values,clustered",
    [(4096, 128 * 2048, False), (4096, 128 * 2048, True),
     (1024, 128 * 65536, False), (1000, 128 * 512 + 64, False)],
)
def test_k8_matches_jax(m, total_values, clustered):
    """K8's interface against JAX's K8 in interpret mode: both round the
    values to bf16 and sum in f32, so within 1e-5 of max |want|."""
    rng = np.random.default_rng(m + clustered)
    n_rows = total_values // 128
    hi = max(n_rows // 64, 1) if clustered else n_rows
    rows = rng.integers(0, hi, m).astype(np.int32)
    lane0 = (rng.integers(0, 64, m) * 2).astype(np.int32)
    v0 = rng.normal(size=m).astype(np.float32)
    v1 = rng.normal(size=m).astype(np.float32)
    want = np.asarray(jhb.sorted_table_grad(
        jnp.asarray(rows), jnp.asarray(lane0), jnp.asarray(v0),
        jnp.asarray(v1), total_values, interpret=True))
    got = thb.sorted_table_grad(torch.tensor(rows), torch.tensor(lane0),
                                torch.tensor(v0), torch.tensor(v1),
                                total_values).numpy()
    assert got.shape == want.shape == (total_values,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _ray_ordered_values(rng, m, total_values):
    """A K8 stream in ray order: runs of 4-40 contributions on one entry
    (the coarse levels' rows along a ray), a tenth of the pairs zero
    (padded samples), 50 rows past the table and 50 negative (both
    dropped), lane0 even."""
    n_rows = -(-total_values // 128)
    rows, lane0 = [], []
    while len(rows) < m:
        k = int(rng.integers(4, 41))
        rows += [int(rng.integers(0, n_rows))] * k
        lane0 += [int(rng.integers(0, 64)) * 2] * k
    rows, lane0 = np.array(rows[:m]), np.array(lane0[:m])
    rows[100:150] = n_rows + 300
    rows[150:200] = -3
    v0 = rng.normal(size=m).astype(np.float32)
    v1 = rng.normal(size=m).astype(np.float32)
    zero = rng.random(m) < 0.1
    v0[zero] = v1[zero] = 0.0
    return rows, lane0, v0, v1


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("total_values", [128 * 2048, 128 * 512 + 64])
def test_k8_plain_matches_jax_on_ray_ordered_streams(index_dtype,
                                                     total_values):
    """K8's plain version (the function its one-launch kernel computes:
    entry (row * 128 + lane0) / 2, values rounded to bf16, rows outside
    the table dropped) against JAX's K8 in interpret mode on a
    ray-ordered stream with runs of equal entries, zero pairs and
    out-of-range rows, with int32 and int64 ids: within 1e-5 of max
    |want| (both round to bf16 and sum in f32, in another order)."""
    rng = np.random.default_rng(total_values % 1000)
    rows, lane0, v0, v1 = _ray_ordered_values(rng, 6000, total_values)
    want = np.asarray(jhb.sorted_table_grad(
        jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(lane0.astype(np.int32)), jnp.asarray(v0),
        jnp.asarray(v1), total_values, interpret=True))
    args = (torch.tensor(rows).to(index_dtype),
            torch.tensor(lane0).to(index_dtype), torch.tensor(v0),
            torch.tensor(v1), total_values)
    got = thb.table_grad_values_plain(*args)
    assert got.dtype == torch.float32
    assert torch.equal(thb.sorted_table_grad(*args), got)
    got = got.numpy()
    assert got.shape == want.shape == (total_values,)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_segment_sum_vjp_matches_jax():
    """presorted_row_segment_sum_vjp: the values' gradient is the
    gather g[keys] with sentinel rows zeroed, exactly as JAX's."""
    rng = np.random.default_rng(5)
    n_seg = 50
    keys = np.sort(rng.integers(0, n_seg, 900)).astype(np.int32)
    keys = np.concatenate([keys, np.full(124, n_seg, np.int32)])
    vals = rng.normal(size=(keys.shape[0], 8)).astype(np.float32)
    g = rng.normal(size=(n_seg, 8)).astype(np.float32)

    out_j, pull = jax.vjp(
        lambda v: jhs.presorted_row_segment_sum_vjp(jnp.asarray(keys), v,
                                                    n_seg),
        jnp.asarray(vals))
    (dv_j,) = pull(jnp.asarray(g))
    tv = torch.tensor(vals, requires_grad=True)
    out_t = ths.presorted_row_segment_sum_vjp(torch.tensor(keys), tv, n_seg)
    (dv_t,) = torch.autograd.grad(out_t, tv, torch.tensor(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dv_t.numpy(), np.asarray(dv_j))
    assert np.all(dv_t.numpy()[900:] == 0.0)
