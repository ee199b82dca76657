"""The port's cell-layout hash grid against the JAX package's, on the same
seeded numpy inputs: the cell indices and weights, the encode, the three
segment sums of the table gradient (K5 sorted_row_grad, K6
sorted_pair_grad, K7 sorted_tet_factor_grad), K5, K6 and K7 from
positions (cell_row_grad_x, cell_pair_grad_x, tet_factor_grad_x), the
encode's VJP on every route of `_cell_bwd`, the route rule itself, one
stage-1 training step, the CLI with run_nerfsynthetic_tpu_fast.sh's flags, save / load and
params_from_jax. JAX runs on the CPU, K5 and K6 in Pallas interpret
mode and K7 through its CPU reference, as its own tests run them; the
port runs each kernel's plain PyTorch version."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops import hashgrid as jhg
from quadraturefields_tpu.ops import hashgrid_sorted as jhs
from quadraturefields_tpu_torch.cli import train_ngp as tcli
from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.ops import hashgrid as thg
from quadraturefields_tpu_torch.ops import hashgrid_sorted as ths
from quadraturefields_tpu_torch.train import stage1_ngp as tst
from quadraturefields_tpu_torch.utils.convert import params_from_jax
from test_torch_hashgrid import _points
from test_torch_stage1_train import _trainers

torch.set_num_threads(1)


def _cfgs(**kw):
    """A small cell grid, the same in both packages: levels of 3^3 and
    7^3 cells are dense, the 15^3 level hashes into 2^9 rows."""
    base = dict(n_levels=3, n_features=2, log2_hashmap_size=9,
                base_resolution=4, per_level_scale=2.0, layout="cell")
    base.update(kw)
    return jhg.HashGridConfig(**base), thg.HashGridConfig(**base)


@pytest.mark.parametrize("interp", ["cube", "tet"])
def test_cell_indices_weights_match_jax(interp):
    """Row indices and tet slots exactly, weights within 1e-7 (the same
    f32 operations), on points with ties, knots and faces."""
    jcfg, tcfg = _cfgs(interp=interp)
    dense = [(r - 1) ** 3 <= s for r, s in zip(tcfg.level_resolutions,
                                               tcfg.level_sizes)]
    assert any(dense) and not all(dense)
    x = _points(512, 3).clip(0, 1)
    ji, jw = jhg._cell_indices_weights(jnp.asarray(x), jcfg)
    ti, tw = thg._cell_indices_weights(torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-7)
    if interp == "tet":
        jwk, js1, js2 = jhg._cell_tet_sparse(jnp.asarray(x), jcfg)
        twk, ts1, ts2 = thg._cell_tet_sparse(torch.as_tensor(x), tcfg)
        np.testing.assert_array_equal(ts1.numpy(), np.asarray(js1))
        np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
        np.testing.assert_allclose(twk.numpy(), np.asarray(jwk), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("interp", ["cube", "tet"])
@pytest.mark.parametrize("n_features", [2, 4])
def test_cell_encode_matches_jax(interp, n_features):
    """Within 1e-6: the same rows and weights, the corner sum in another
    f32 order (values ~1)."""
    jcfg, tcfg = _cfgs(interp=interp, n_features=n_features)
    rng = np.random.default_rng(n_features)
    table = rng.uniform(-1, 1, (tcfg.total_entries, 8 * n_features)) \
        .astype(np.float32)
    x = _points(1024, 2)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x),
                                         jcfg))
    got = thg.hashgrid_encode(torch.as_tensor(table), torch.as_tensor(x),
                              tcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "m,total_entries,rw",
    [(512, 8 * jhs.W * 2, 16), (512 * 3 + 117, 8 * jhs.W * 5, 16),
     (700, 64, 16), (513, 4 * jhs.W * 3, 32)],
)
def test_sorted_row_grad_matches_jax_k5(m, total_entries, rw):
    """K5's interface against JAX's K5 in interpret mode, the cases of
    tests/test_hashgrid_cell.py: within 2e-5 (f32 sums in another
    order)."""
    rng = np.random.default_rng(m + rw)
    idx = rng.integers(0, total_entries, m).astype(np.int32)
    vals = rng.normal(size=(m, rw)).astype(np.float32)
    want = np.asarray(jhs.sorted_row_grad(jnp.asarray(idx),
                                          jnp.asarray(vals), total_entries))
    got = ths.sorted_row_grad(torch.tensor(idx), torch.tensor(vals),
                              total_entries).numpy()
    assert got.shape == want.shape == (total_entries, rw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,total_entries,pw", [(4096, 1000, 8),
                                                (9999, 257, 8),
                                                (2048, 500, 16)])
def test_sorted_pair_grad_matches_jax_k6(m, total_entries, pw):
    """K6's interface against JAX's K6 in interpret mode: both round each
    value to bf16 and sum in f32, so within 2e-5."""
    rng = np.random.default_rng(m)
    idx = rng.integers(0, total_entries, m).astype(np.int32)
    lo = rng.normal(0, 1, (m, pw)).astype(np.float32)
    hi = rng.normal(0, 1, (m, pw)).astype(np.float32)
    want = np.asarray(jhs.sorted_pair_grad(
        jnp.asarray(idx), jnp.asarray(lo), jnp.asarray(hi), total_entries))
    got = ths.sorted_pair_grad(torch.tensor(idx), torch.tensor(lo),
                               torch.tensor(hi), total_entries).numpy()
    assert got.shape == want.shape == (total_entries, 2 * pw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,total_entries,F,out_of_range",
                         [(4096, 1000, 4, False), (9999, 257, 2, False),
                          (3000, 300, 4, True)])
def test_sorted_tet_factor_grad_matches_jax_k7(m, total_entries, F,
                                               out_of_range):
    """K7's interface against JAX's K7 through its CPU reference
    (_factor_grad_reference): the same bf16 roundings of factors and
    products, f32 sums in another order, so within 2e-5; entries past
    the table are dropped in both."""
    rng = np.random.default_rng(m + F)
    idx = rng.integers(0, total_entries, m).astype(np.int32)
    if out_of_range:
        idx[::7] = total_entries + rng.integers(0, 50, idx[::7].shape)
    wk = rng.normal(0, 1, (m, 4)).astype(np.float32)
    c1 = rng.integers(1, 7, m).astype(np.int32)
    c2 = ((c1 - 1 + rng.integers(1, 6, m)) % 6 + 1).astype(np.int32)
    g = rng.normal(0, 1, (m, F)).astype(np.float32)
    want = np.asarray(jhs.sorted_tet_factor_grad(
        jnp.asarray(idx), jnp.asarray(wk), jnp.asarray(c1), jnp.asarray(c2),
        jnp.asarray(g), total_entries))
    got = ths.sorted_tet_factor_grad(
        torch.tensor(idx), torch.tensor(wk), torch.tensor(c1),
        torch.tensor(c2), torch.tensor(g), total_entries).numpy()
    assert got.shape == want.shape == (total_entries, 8 * F)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _knots_and_faces(tcfg, seed):
    """Points on the grid knots of every level (pos = x * scale + 0.5
    an integer: frac 0, where the rank ties and the clip sit) and on the
    upper faces (x = 1 on some axes: the cell clips to n_axis - 1 and
    frac clips from above to 1)."""
    rng = np.random.default_rng(seed)
    knots = [(rng.integers(1, r, (64, 3)) - 0.5) / s
             for s, r in zip(tcfg.level_scales, tcfg.level_resolutions)]
    faces = rng.random((96, 3))
    faces[np.arange(96), np.arange(96) % 3] = 1.0
    faces[::4] = 1.0
    return np.concatenate([*knots, faces]).astype(np.float32)


@pytest.mark.parametrize("n_features", [2, 4, 8])
def test_tet_factor_grad_x_plain_equals_stream_route(n_features):
    """K7's plain version from positions, level by level, against the
    stream route it replaces in the backward (_cell_tet_levels, then the
    stream interface's plain version): bit for bit, on random points,
    grid knots and upper faces, with zero cotangent rows among them."""
    _, tcfg = _cfgs(interp="tet", n_features=n_features,
                    grad_payload="bf16factor")
    x = torch.tensor(np.concatenate([_points(256, 7).clip(0, 1),
                                     _knots_and_faces(tcfg, 7)]))
    n, L, F = x.shape[0], tcfg.n_levels, n_features
    fracs = [frac for _, frac in thg._cell_levels(x, tcfg)]
    assert all(bool((f == 0).any()) for f in fracs)
    assert all(bool((f == 1).any()) for f in fracs)
    rng = np.random.default_rng(F)
    g = rng.normal(size=(n, L * F)).astype(np.float32)
    g[::9] = 0.0
    g = torch.tensor(g)
    idx, wk, s1, s2 = thg._cell_tet_levels(x, tcfg)
    want = ths.sorted_tet_factor_grad(
        idx.reshape(-1), wk.reshape(n * L, 4), s1.reshape(-1),
        s2.reshape(-1), g.reshape(n * L, F), tcfg.total_entries)
    got = thg.tet_factor_grad_x_plain(x, g, tcfg)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(thg.tet_factor_grad_x(x, g, tcfg), want)


def test_tet_factor_grad_x_matches_jax_cell_bwd():
    """K7 from positions against JAX's `_cell_bwd` on its factor route
    (grad_mode "sorted", bf16factor, tet; on the CPU JAX runs K7 through
    _factor_grad_reference) at L4 F4, 2^10 seeded points and knots: the
    same bf16 roundings of factors and products, f32 sums in another
    order, so within 1e-5 of max |d_table|. Two dense levels (27 and
    343 cells), two hashed into 2^10 rows."""
    kw = dict(n_levels=4, n_features=4, log2_hashmap_size=10,
              base_resolution=4, per_level_scale=2.0, layout="cell",
              interp="tet", grad_mode="sorted", grad_payload="bf16factor")
    jcfg, tcfg = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.random((1 << 10, 3)).astype(np.float32),
                        _knots_and_faces(tcfg, 10)])
    g = rng.normal(size=(x.shape[0], jcfg.output_dim)).astype(np.float32)
    table = np.zeros((jcfg.total_entries, 32), np.float32)
    want, _ = jhg._cell_bwd(jcfg, (jnp.asarray(table), jnp.asarray(x)),
                            jnp.asarray(g))
    want = np.asarray(want)
    got = thg.tet_factor_grad_x_plain(torch.tensor(x), torch.tensor(g),
                                      tcfg).numpy()
    assert got.shape == want.shape == (tcfg.total_entries, 32)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cell_backward_builds_no_factor_stream(monkeypatch):
    """The cell encode's backward on K7's route goes through
    tet_factor_grad_x and never builds the contribution stream
    (_cell_tet_levels); its d_table equals the stream route's bit for
    bit."""
    _, tcfg = _cfgs(interp="tet", n_features=4, grad_mode="sorted",
                    grad_payload="bf16factor")
    assert thg._cell_grad_route(tcfg, 300, on_card=False) == "factor"
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((300, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(300, tcfg.output_dim))
                     .astype(np.float32))
    table = torch.zeros((tcfg.total_entries, 32), requires_grad=True)
    idx, wk, s1, s2 = thg._cell_tet_levels(x, tcfg)
    want = ths.sorted_tet_factor_grad(
        idx.reshape(-1), wk.reshape(-1, 4), s1.reshape(-1), s2.reshape(-1),
        g.reshape(-1, 4), tcfg.total_entries)

    def no_stream(*a):
        raise AssertionError("the backward built K7's stream")

    monkeypatch.setattr(thg, "_cell_tet_levels", no_stream)
    calls = []
    fused = thg.tet_factor_grad_x
    monkeypatch.setattr(thg, "tet_factor_grad_x",
                        lambda *a: calls.append(a) or fused(*a))
    (got,) = torch.autograd.grad(thg.hashgrid_encode(table, x, tcfg),
                                 table, g)
    assert len(calls) == 1
    assert torch.equal(got, want)


def _stream_rows_route(x, g, cfg):
    """K5's stream route: the [N*L, 8F] contribution rows of
    _cell_indices_weights (rounded to bf16 for bf16sim), then
    sorted_row_grad."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    idx, w8 = thg._cell_indices_weights(x, cfg)
    vals = (w8.reshape(n * L, 8, 1)
            * g.reshape(n * L, F)[:, None, :]).reshape(n * L, 8 * F)
    if cfg.grad_payload == "bf16sim":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return ths.sorted_row_grad(idx.reshape(-1), vals, cfg.total_entries)


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("payload", ["f32", "bf16sim"])
@pytest.mark.parametrize("n_features", [2, 4, 8])
def test_cell_row_grad_x_plain_equals_stream_route(interp, payload,
                                                   n_features):
    """K5's plain version from positions, level by level, against the
    stream route it replaces in the backward (_cell_indices_weights, the
    [N*L, 8F] rows, sorted_row_grad's plain version): bit for bit, on
    random points, grid knots and upper faces, with zero cotangent rows
    among them."""
    _, tcfg = _cfgs(interp=interp, n_features=n_features,
                    grad_payload=payload)
    x = torch.tensor(np.concatenate([_points(256, 11).clip(0, 1),
                                     _knots_and_faces(tcfg, 11)]))
    n, L, F = x.shape[0], tcfg.n_levels, n_features
    fracs = [frac for _, frac in thg._cell_levels(x, tcfg)]
    assert all(bool((f == 0).any()) for f in fracs)
    assert all(bool((f == 1).any()) for f in fracs)
    rng = np.random.default_rng(F + len(payload))
    g = rng.normal(size=(n, L * F)).astype(np.float32)
    g[::9] = 0.0
    g = torch.tensor(g)
    want = _stream_rows_route(x, g, tcfg)
    got = thg.cell_row_grad_x_plain(x, g, tcfg)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(thg.cell_row_grad_x(x, g, tcfg), want)


@pytest.mark.parametrize("mode,payload,interp,F", [
    ("exact", "f32", "cube", 4),
    ("sorted", "f32", "tet", 2),
    ("exact", "bf16sim", "tet", 4),
    ("sorted", "bf16sim", "cube", 2),
    ("sorted", "bf16factor", "cube", 4),
    ("exact", "bf16pair", "tet", 8),
])
def test_cell_row_grad_x_matches_jax_cell_bwd(mode, payload, interp, F):
    """K5 from positions against JAX's `_cell_bwd` on its rows routes (f32
    and bf16sim payloads, and the bf16factor / bf16pair requests that
    fall back to f32 rows; "sorted" runs JAX's K5 in Pallas interpret
    mode, "exact" its scatter) at L4, seeded points, knots and upper
    faces: the same products, f32 sums in another order, so within 1e-5
    of max |d_table|. Two dense levels (27 and 343 cells), two hashed
    into 2^10 rows."""
    kw = dict(n_levels=4, n_features=F, log2_hashmap_size=10,
              base_resolution=4, per_level_scale=2.0, layout="cell",
              interp=interp, grad_mode=mode, grad_payload=payload)
    jcfg, tcfg = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    rng = np.random.default_rng(F + len(payload))
    x = np.concatenate([rng.random((300, 3)).astype(np.float32),
                        _knots_and_faces(tcfg, F)])
    assert thg._cell_grad_route(tcfg, x.shape[0], on_card=False) == "rows"
    g = rng.normal(size=(x.shape[0], jcfg.output_dim)).astype(np.float32)
    table = np.zeros((jcfg.total_entries, 8 * F), np.float32)
    want, _ = jhg._cell_bwd(jcfg, (jnp.asarray(table), jnp.asarray(x)),
                            jnp.asarray(g))
    want = np.asarray(want)
    got = thg.cell_row_grad_x_plain(torch.tensor(x), torch.tensor(g),
                                    tcfg).numpy()
    assert got.shape == want.shape == (tcfg.total_entries, 8 * F)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("interp", ["tet", "cube"])
def test_cell_backward_rows_route_builds_no_stream(interp, monkeypatch):
    """The cell encode's backward on the rows route (d_table only: x does
    not require grad) goes through cell_row_grad_x once and never builds
    the [N*L, 8F] contribution stream (_cell_indices_weights, which the
    plain forward still calls); its d_table equals the stream route's
    bit for bit."""
    _, tcfg = _cfgs(interp=interp, n_features=4, grad_mode="exact")
    assert thg._cell_grad_route(tcfg, 300, on_card=False) == "rows"
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.random((300, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(300, tcfg.output_dim))
                     .astype(np.float32))
    table = torch.zeros((tcfg.total_entries, 32), requires_grad=True)
    want = _stream_rows_route(x, g, tcfg)
    # the plain forward gathers with _cell_indices_weights itself
    out = thg.hashgrid_encode(table, x, tcfg)

    def no_stream(*a):
        raise AssertionError("the backward built K5's stream")

    monkeypatch.setattr(thg, "_cell_indices_weights", no_stream)
    calls = []
    fused = thg.cell_row_grad_x
    monkeypatch.setattr(thg, "cell_row_grad_x",
                        lambda *a: calls.append(a) or fused(*a))
    (got,) = torch.autograd.grad(out, table, g)
    assert len(calls) == 1
    assert torch.equal(got, want)


def _stream_pair_route(x, g, cfg):
    """K6's stream route: the [N*L, 4F] lo and hi pair streams of
    _cell_indices_weights (lane c*F/2 + p: w8[c] * g[2p] and
    w8[c] * g[2p + 1]), then sorted_pair_grad."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    idx, w8 = thg._cell_indices_weights(x, cfg)
    w8, g2 = w8.reshape(n * L, 8, 1), g.reshape(n * L, F)
    lo = (w8 * g2[:, None, 0::2]).reshape(n * L, 4 * F)
    hi = (w8 * g2[:, None, 1::2]).reshape(n * L, 4 * F)
    return ths.sorted_pair_grad(idx.reshape(-1), lo, hi, cfg.total_entries)


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("n_features", [2, 4, 8])
def test_cell_pair_grad_x_plain_equals_stream_route(interp, n_features):
    """K6's plain version from positions, level by level, against the
    lo/hi stream route it replaces in the backward
    (_cell_indices_weights, the pair streams, sorted_pair_grad's plain
    version): bit for bit, on random points, grid knots and upper faces,
    with zero cotangent rows among them."""
    _, tcfg = _cfgs(interp=interp, n_features=n_features,
                    grad_mode="sorted", grad_payload="bf16pair")
    x = torch.tensor(np.concatenate([_points(256, 13).clip(0, 1),
                                     _knots_and_faces(tcfg, 13)]))
    n, L, F = x.shape[0], tcfg.n_levels, n_features
    fracs = [frac for _, frac in thg._cell_levels(x, tcfg)]
    assert all(bool((f == 0).any()) for f in fracs)
    assert all(bool((f == 1).any()) for f in fracs)
    rng = np.random.default_rng(F + 20)
    g = rng.normal(size=(n, L * F)).astype(np.float32)
    g[::9] = 0.0
    g = torch.tensor(g)
    want = _stream_pair_route(x, g, tcfg)
    got = thg.cell_pair_grad_x_plain(x, g, tcfg)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(thg.cell_pair_grad_x(x, g, tcfg), want)


@pytest.mark.parametrize("interp", ["tet", "cube"])
@pytest.mark.parametrize("n_features", [2, 4])
def test_cell_pair_grad_x_matches_jax_cell_bwd(interp, n_features):
    """K6 from positions against JAX's `_cell_bwd` on its pair branch
    (grad_mode "sorted", bf16pair: JAX builds the lo/hi streams and runs
    K6 in Pallas interpret mode) at L4, seeded points, knots and upper
    faces: the same bf16-rounded products, f32 sums in another order, so
    within 1e-5 of max |d_table|. Two dense levels (27 and 343 cells),
    two hashed into 2^10 rows."""
    F = n_features
    kw = dict(n_levels=4, n_features=F, log2_hashmap_size=10,
              base_resolution=4, per_level_scale=2.0, layout="cell",
              interp=interp, grad_mode="sorted", grad_payload="bf16pair")
    jcfg, tcfg = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    rng = np.random.default_rng(F + 30)
    x = np.concatenate([rng.random((300, 3)).astype(np.float32),
                        _knots_and_faces(tcfg, F + 30)])
    assert thg._cell_grad_route(tcfg, x.shape[0], on_card=False) == "pair"
    g = rng.normal(size=(x.shape[0], jcfg.output_dim)).astype(np.float32)
    table = np.zeros((jcfg.total_entries, 8 * F), np.float32)
    want, _ = jhg._cell_bwd(jcfg, (jnp.asarray(table), jnp.asarray(x)),
                            jnp.asarray(g))
    want = np.asarray(want)
    got = thg.cell_pair_grad_x_plain(torch.tensor(x), torch.tensor(g),
                                     tcfg).numpy()
    assert got.shape == want.shape == (tcfg.total_entries, 8 * F)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("interp", ["tet", "cube"])
def test_cell_backward_pair_route_builds_no_stream(interp, monkeypatch):
    """The cell encode's backward on the pair route (sorted bf16pair,
    d_table only) goes through cell_pair_grad_x once and never builds
    the lo/hi pair streams (_cell_indices_weights, which the plain
    forward still calls); its d_table equals the stream route's bit for
    bit."""
    _, tcfg = _cfgs(interp=interp, n_features=4, grad_mode="sorted",
                    grad_payload="bf16pair")
    assert thg._cell_grad_route(tcfg, 300, on_card=False) == "pair"
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.random((300, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(300, tcfg.output_dim))
                     .astype(np.float32))
    table = torch.zeros((tcfg.total_entries, 32), requires_grad=True)
    want = _stream_pair_route(x, g, tcfg)
    # the plain forward gathers with _cell_indices_weights itself
    out = thg.hashgrid_encode(table, x, tcfg)

    def no_stream(*a):
        raise AssertionError("the backward built K6's stream")

    monkeypatch.setattr(thg, "_cell_indices_weights", no_stream)
    calls = []
    fused = thg.cell_pair_grad_x
    monkeypatch.setattr(thg, "cell_pair_grad_x",
                        lambda *a: calls.append(a) or fused(*a))
    (got,) = torch.autograd.grad(out, table, g)
    assert len(calls) == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_features", [1, 2, 3, 4, 8, 16])
def test_cell_rows_route_takes_the_fused_entry_by_f(n_features,
                                                    monkeypatch):
    """_cell_table_grad's rule on the rows route: F in
    CELL_GRAD_X_FEATURES (2, 4, 8, 16) takes K5's fused entry
    (cell_row_grad_x), any other F K5's stream entry (sorted_row_grad),
    on the CPU as on the card; both give the same gradient."""
    _, tcfg = _cfgs(interp="tet", n_features=n_features)
    assert thg._cell_grad_route(tcfg, 100, on_card=False) == "rows"
    rng = np.random.default_rng(n_features)
    x = torch.tensor(rng.random((100, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(100, tcfg.output_dim))
                     .astype(np.float32))
    calls = []
    for mod, name in ((thg, "cell_row_grad_x"), (ths, "sorted_row_grad")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    got = thg._cell_table_grad(x, g, tcfg)
    fused = n_features in thg.CELL_GRAD_X_FEATURES
    assert fused == (n_features in (2, 4, 8, 16))
    assert calls == ["cell_row_grad_x" if fused else "sorted_row_grad"]
    assert torch.equal(got, thg.cell_row_grad_x_plain(x, g, tcfg))


# (grad_mode, grad_payload, interp, F, the port's route on the CPU)
VJP_ROUTES = [
    ("exact", "f32", "tet", 2, "rows"),
    ("exact", "f32", "cube", 4, "rows"),
    ("sorted", "f32", "cube", 2, "rows"),
    ("sorted", "bf16sim", "tet", 2, "rows"),
    ("exact", "bf16sim", "cube", 2, "rows"),
    ("sorted", "bf16pair", "cube", 2, "pair"),
    ("sorted", "bf16pair", "tet", 4, "pair"),
    ("exact", "bf16pair", "tet", 2, "rows"),
    ("sorted", "bf16factor", "tet", 4, "factor"),
    ("sorted", "bf16factor", "tet", 2, "rows"),
    ("sorted", "bf16factor", "cube", 4, "rows"),
    ("stochastic", "f32", "tet", 2, "rows"),
    ("auto", "bf16factor", "tet", 4, "rows"),
]


@pytest.mark.parametrize("mode,payload,interp,F,route", VJP_ROUTES)
def test_cell_vjp_matches_jax(mode, payload, interp, F, route):
    """The encode's VJP against jax.vjp with the same explicit grad_mode
    and payload, on the same table, points and a fixed numpy cotangent,
    so the bf16 roundings see identical inputs: d_table within 1e-5 of
    max |d_table|, d_x within 1e-4 (random points, off the knots where
    the clip-tie gradients differ). One dense level (7^3 cells) and one
    hashed (15^3 cells into 2^9 rows)."""
    kw = dict(n_levels=2, n_features=F, log2_hashmap_size=9,
              base_resolution=8, per_level_scale=2.0, layout="cell",
              interp=interp, grad_mode=mode, grad_payload=payload)
    jcfg, tcfg = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    n = 300
    assert thg._cell_grad_route(tcfg, n, on_card=False) == route
    rng = np.random.default_rng(F + len(payload))
    table = rng.uniform(-1, 1, (jcfg.total_entries, 8 * F)).astype(np.float32)
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, jcfg.output_dim)).astype(np.float32)

    _, pull = jax.vjp(lambda t, xx: jhg.hashgrid_encode(t, xx, jcfg),
                      jnp.asarray(table), jnp.asarray(x))
    dt_j, dx_j = (np.asarray(a) for a in pull(jnp.asarray(g)))
    tt = torch.tensor(table, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    dt_t, dx_t = torch.autograd.grad(thg.hashgrid_encode(tt, tx, tcfg),
                                     (tt, tx), torch.tensor(g))
    assert np.abs(dt_t.numpy() - dt_j).max() <= 1e-5 * np.abs(dt_j).max()
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=0, atol=1e-4)


def test_cell_grad_route_follows_jax():
    """The rule of JAX's _cell_bwd, at the run_nerfsynthetic_tpu_fast.sh
    grid (E = 439,472 cell rows): "auto" takes the sorted factor route
    on the card from n = 164,802 points (3 * E = n * L) up, the f32 rows
    below it and always on the CPU; explicit modes ignore the device."""
    fast = thg.HashGridConfig.from_max_resolution(
        4096, n_levels=8, n_features=4, log2_hashmap_size=16, interp="tet",
        layout="cell", grad_payload="bf16factor")
    assert fast.total_entries == 439_472
    route = thg._cell_grad_route
    assert route(fast, 1 << 20, on_card=True) == "factor"
    assert route(fast, 164_802, on_card=True) == "factor"
    assert route(fast, 164_801, on_card=True) == "rows"
    assert route(fast, 1 << 20, on_card=False) == "rows"

    def r(**kw):
        return route(thg.HashGridConfig(layout="cell", **kw), 10,
                     on_card=False)

    for mode in ("exact", "stochastic"):
        for payload in ("f32", "bf16sim", "bf16pair", "bf16factor"):
            assert r(grad_mode=mode, grad_payload=payload, interp="tet",
                     n_features=4) == "rows"
    assert r(grad_mode="sorted", grad_payload="bf16factor", interp="tet",
             n_features=4) == "factor"
    assert r(grad_mode="sorted", grad_payload="bf16factor", interp="tet",
             n_features=8) == "factor"
    assert r(grad_mode="sorted", grad_payload="bf16factor", interp="tet",
             n_features=2) == "rows"
    assert r(grad_mode="sorted", grad_payload="bf16factor", interp="cube",
             n_features=4) == "rows"
    assert r(grad_mode="sorted", grad_payload="bf16pair", interp="cube",
             n_features=2) == "pair"
    assert r(grad_mode="sorted", grad_payload="bf16pair", interp="tet",
             n_features=1) == "rows"
    assert r(grad_mode="sorted", grad_payload="bf16sim", interp="tet",
             n_features=4) == "rows"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from quadraturefields_tpu.data.fixture import write_fixture_dataset as w

    root = str(tmp_path_factory.mktemp("data"))
    w(root, res=32, n_train=2, n_test=1)
    return root


def test_cell_training_step_matches_jax(fixture_root):
    """One stage-1 step at a small cell config (L4 F4 tet, bf16factor,
    grad_mode "sorted" so both take the K7 route, the mlp head): loss
    within 1e-3 relative of the JAX trainer's, every gradient with
    cosine >= 0.999 and norm within 1%, on the same weights, batch and
    jitter."""
    jtr, ttr, (o, d, px, bkgd) = _trainers(
        "synthetic", fixture_root, layout="cell", n_features=4,
        grad_payload="bf16factor", grad_mode="sorted", num_lobes=0)
    assert ttr.ngp_cfg.hashgrid.row_width == 32
    key = jax.random.PRNGKey(5)
    (lj, auxj), gj = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        jtr.params, jtr.occ_state, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(px), jnp.asarray(bkgd), key)
    u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    n_budget = ttr.rcfg.max_samples_total
    assert thg._cell_grad_route(ttr.ngp_cfg.hashgrid, n_budget,
                                on_card=False) == "factor"
    lt, auxt = ttr._loss_fn(ttr.params, ttr.occ_state, torch.tensor(o),
                            torch.tensor(d), torch.tensor(px),
                            torch.tensor(bkgd), torch.tensor(u))
    lt.backward()
    assert int(auxt["num_valid"]) == int(auxj["num_valid"]) > 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves(gj)
    tleaves = [p.grad for p in tst._leaves(ttr.params)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0
        assert a @ b / (na * nb) >= 0.999
        assert abs(na / nb - 1.0) <= 0.01


# run_nerfsynthetic_tpu_fast.sh's flags, at 4 levels and a 2^12 budget
FAST_FLAGS = ["--num_lobes", "0", "--num_layers", "2",
              "--log2_hashmap_size", "12", "--batch_size", "12",
              "--scale", "1.5", "--reg_type", "occ", "--occ_thres", "0.01",
              "--layout", "cell", "--grad_payload", "bf16factor",
              "--n_levels", "4", "--n_features", "4"]


def test_cli_trains_the_fast_cell_config(tmp_path, monkeypatch):
    """The CLI with the script's flags for a few steps on the CPU: the
    cell table [E, 32] trains (on the CPU "auto" takes the f32 rows, as
    JAX's does, through K5's fused entry), then the final evaluation,
    args.json and log.json."""
    monkeypatch.setattr(tcli, "Stage1Config", functools.partial(
        tst.Stage1Config, grid_resolution=32, eval_chunk=256))
    calls = []
    rows = thg.cell_row_grad_x
    monkeypatch.setattr(thg, "cell_row_grad_x",
                        lambda *a: calls.append(a[2]) or rows(*a))
    write_fixture_dataset(str(tmp_path / "data"), res=16, n_train=2,
                          n_test=1)
    argv = ["--scene", "fixture", "--data_root", str(tmp_path / "data"),
            "--root", str(tmp_path / "runs"), "--exp_name", "nerf",
            "--max_steps", "2", *FAST_FLAGS]
    metrics = tcli.main(argv, device="cpu")
    assert np.isfinite(metrics["psnr"])
    assert len(calls) == 3 and all(c.row_width == 32 for c in calls)
    args = json.loads((tmp_path / "runs" / "results" / "fixture" / "nerf"
                       / "args.json").read_text())
    assert (args["layout"], args["grad_payload"], args["n_features"],
            args["num_lobes"]) == ("cell", "bf16factor", 4, 0)


def test_cell_trainer_save_load(tmp_path):
    """A cell-layout trainer (sorted factor route) takes two steps; save
    and load carry the [E, 32] table, the Adam state and the step."""
    write_fixture_dataset(str(tmp_path / "data"), res=16, n_train=2,
                          n_test=1)
    cfg = tst.Stage1Config(
        scene="fixture", data_root=str(tmp_path / "data"),
        root=str(tmp_path / "runs"), max_steps=10, init_batch_size=128,
        batch_size_log2=12, grid_resolution=32, n_levels=4, n_features=4,
        log2_hashmap_size=12, layout="cell", grad_payload="bf16factor",
        grad_mode="sorted", num_lobes=0)
    tr = tst.Stage1Trainer(cfg, device="cpu")
    table0 = tr.params["table"].detach().clone()
    for _ in range(2):
        loss, _ = tr.train_one_step()
        assert np.isfinite(float(loss))
    assert tr.params["table"].shape == (cfg.ngp_config().hashgrid
                                        .total_entries, 32)
    assert not torch.equal(tr.params["table"], table0)
    path = str(tmp_path / "ngp.pt")
    tr.save(path)
    other = tst.Stage1Trainer(cfg, device="cpu")
    other.load(path)
    assert other.step == tr.step == 2
    assert torch.equal(other.params["table"], tr.params["table"])
    a = tr.optimizer.state_dict()["state"][0]["exp_avg_sq"]
    assert torch.equal(other.optimizer.state_dict()["state"][0]
                       ["exp_avg_sq"], a)


def test_cell_params_from_jax_and_forward():
    """params_from_jax carries a JAX cell tree across unchanged (row
    c*F + f in both), and ngp_forward through the cell encode matches
    JAX's within 1e-5 in f32; the port's ngp_init builds the same tree."""
    kw = dict(n_levels=2, n_features=4, log2_hashmap_size=12,
              max_resolution=256, interp="tet", layout="cell", head="mlp",
              compute_dtype="float32")
    jcfg, tcfg = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    params = jngp.ngp_init(jax.random.PRNGKey(0), jcfg)
    params["table"] = params["table"] * 1e4
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    tparams = params_from_jax(np_tree)
    assert tparams["table"].shape == (jcfg.hashgrid.total_entries, 32)
    np.testing.assert_array_equal(tparams["table"].numpy(), np_tree["table"])
    init = tngp.ngp_init(torch.Generator().manual_seed(0), tcfg)
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), init)
            == jax.tree_util.tree_map(lambda a: a.shape, np_tree))

    rng = np.random.default_rng(0)
    x = rng.uniform(-1.7, 1.7, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    aabb = np.array([-1.5] * 3 + [1.5] * 3, np.float32)
    rgb_j, dens_j = jngp.ngp_forward(params, jnp.asarray(x), jnp.asarray(d),
                                     jnp.asarray(aabb), jcfg)
    rgb_t, dens_t = tngp.ngp_forward(tparams, torch.as_tensor(x),
                                     torch.as_tensor(d),
                                     torch.as_tensor(aabb), tcfg)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                               rtol=1e-5, atol=1e-5)
