"""The port's quadrature field (models/field.py) against the JAX package's,
on the same seeded numpy inputs and carried-across weights: the field and
its position gradient (tet and cube corner grids, the cell grid), the
gradient of the stage-2 loss through the position gradient in the table
and the decoder, the second derivative, the two regularising losses, the
SIREN field, the delta field and the sinusoidal encoding; with
back_prop=True (the encode's position gradient in the graph) the loss's
gradient and the second derivative, and the second-order table
gradient's stream against a float64 index_add_. JAX runs on the CPU; the
port takes each kernel's plain version there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.models import field as jf
from quadraturefields_tpu.models import mlp_nerf as jmn
from quadraturefields_tpu_torch.models import field as tf
from quadraturefields_tpu_torch.models import mlp_nerf as tmn
from quadraturefields_tpu_torch.ops import hashgrid as thg
from quadraturefields_tpu_torch.utils.convert import field_params_from_jax

torch.set_num_threads(1)

# a small field: 4 levels from 16 to 32 points an axis (max_res * scale),
# 2^12 rows a level, so the top levels hash
_SMALL = dict(scale=0.5, log2_hashmap_size=12, n_levels=4,
              max_resolution=64, hidden_size=16)
_GRIDS = {
    "tet": dict(interp="tet"),
    "cube": dict(interp="cube"),
    "cell": dict(interp="tet", layout="cell"),
}


def _field(grid="tet", seed=0, **kw):
    """The same FieldConfig in both packages, JAX's init carried across;
    the table scaled by 1e3 so that the encode's features matter."""
    cfg = dict(_SMALL, **_GRIDS[grid], **kw)
    jcfg, tcfg = jf.FieldConfig(**cfg), tf.FieldConfig(**cfg)
    jp = jf.field_init(jax.random.PRNGKey(seed), jcfg)
    jp["table"] = jp["table"] * 1e3
    tp = field_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _x(n=300, seed=1, scale=0.5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_field_config_matches_jax():
    """The grid of Stage2Config's field (scale 0.5, log2_T 30, L16,
    max_res 512) and of its cell layout, level for level."""
    for layout in ("corner", "cell"):
        kw = dict(scale=0.5, log2_hashmap_size=30, hidden_size=16,
                  layout=layout)
        jh, th = jf.FieldConfig(**kw).hashgrid, tf.FieldConfig(**kw).hashgrid
        assert th.per_level_scale == jh.per_level_scale
        assert th.log2_hashmap_size == jh.log2_hashmap_size
        assert th.level_offsets == jh.level_offsets
    assert tf.FieldConfig(scale=0.5, log2_hashmap_size=30) \
        .hashgrid.total_entries == 39_601_112


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_field_apply_and_with_grad_match_jax(grid):
    """The field and its position gradient within 1e-5 relative to max."""
    jcfg, tcfg, jp, tp = _field(grid)
    x = _x()
    jv = jax.jit(lambda p, x: jf.field_apply(p, x, jcfg))(jp, jnp.asarray(x))
    jfield, jgrad = jax.jit(lambda p, x: jf.field_with_grad(p, x, jcfg))(
        jp, jnp.asarray(x))
    tv = tf.field_apply(tp, torch.as_tensor(x), tcfg)
    tfield, tgrad = tf.field_with_grad(tp, torch.as_tensor(x), tcfg)
    assert tv.shape == (300, 1) and tgrad.shape == (300, 3)
    assert _rel_max(tv.detach(), jv) <= 1e-5
    assert _rel_max(tfield.detach(), jfield) <= 1e-5
    assert _rel_max(tgrad.detach(), jgrad) <= 1e-5
    # the export's form: detached, the same values
    ef, eg = tf.field_with_grad(tp, torch.as_tensor(x), tcfg,
                                create_graph=False)
    assert not ef.requires_grad and not eg.requires_grad
    assert torch.equal(eg, tgrad.detach())


def _port_loss_grads(tp, tcfg, x, w, w_rev, dirs, mask):
    """(loss, {leaf name: grad}) of the port's stage-2 loss through
    field_with_grad, on fresh leaves of tp."""
    leaves = {"table": tp["table"].detach().clone().requires_grad_(True)}
    layers = []
    for i, layer in enumerate(tp["decoder"]["layers"]):
        layers.append({})
        for k, v in layer.items():
            leaves[f"{i}.{k}"] = layers[-1][k] = \
                v.detach().clone().requires_grad_(True)
    params = {"table": leaves["table"], "decoder": {"layers": layers}}
    _, g = tf.field_with_grad(params, torch.as_tensor(x), tcfg)
    lt = tf.field_loss(torch.as_tensor(w), torch.as_tensor(w_rev), g,
                       torch.as_tensor(dirs), mask=torch.as_tensor(mask))
    lt.backward()
    return float(lt.detach()), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("back_prop", [False, True])
@pytest.mark.parametrize("grid", list(_GRIDS))
def test_field_loss_gradient_matches_jax(grid, back_prop):
    """The stage-2 loss through field_with_grad, masked as the trainer
    masks padding: the value within 1e-5 relative, the gradient of every
    leaf (table and decoder) within 1e-4 of its max. The decoder's output
    bias moves the field and not its gradient: its gradient is 0 in JAX,
    and autograd leaves it unset. With back_prop the position gradient
    goes through the encode and the loss differentiates it again: that
    second-order term moves the table's gradient by about its own size
    against back_prop=False's."""
    jcfg, tcfg, jp, tp = _field(grid, back_prop=back_prop)
    rng = np.random.default_rng(3)
    x = _x(seed=2)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    w = rng.uniform(0, 0.2, 300).astype(np.float32)
    w_rev = rng.uniform(0, 0.2, 300).astype(np.float32)
    mask = rng.uniform(size=300) < 0.8

    def jloss(p):
        _, g = jf.field_with_grad(p, jnp.asarray(x), jcfg)
        return jf.field_loss(jnp.asarray(w), jnp.asarray(w_rev), g,
                             jnp.asarray(dirs), mask=jnp.asarray(mask))

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    lt, grads = _port_loss_grads(tp, tcfg, x, w, w_rev, dirs, mask)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    want = {"table": gj["table"]}
    for i, layer in enumerate(gj["decoder"]["layers"]):
        for k, v in layer.items():
            want[f"{i}.{k}"] = v
    assert set(want) == set(grads)
    last_b = f"{len(gj['decoder']['layers']) - 1}.b"
    for name, grad in grads.items():
        if name == last_b:
            assert grad is None
            assert not np.asarray(want[name]).any()
            continue
        assert np.abs(np.asarray(want[name])).max() > 0, name
        assert _rel_max(grad, want[name]) <= 1e-4, name
    if back_prop:
        _, first = _port_loss_grads(
            tp, dataclasses.replace(tcfg, back_prop=False), x, w, w_rev,
            dirs, mask)
        assert _rel_max(grads["table"], first["table"]) > 0.1


@pytest.mark.parametrize("grid,back_prop", [("tet", False), ("tet", True),
                                            ("cube", True)])
def test_field_double_grad_and_losses_match_jax(grid, back_prop):
    """The [N, 3, 3] second derivative within 1e-4 of max, and the two
    regularising losses within 1e-5 relative. With back_prop it holds
    the encode's second derivative in x: zero almost everywhere for tet
    weights, not for cube (trilinear) ones."""
    jcfg, tcfg, jp, tp = _field(grid, back_prop=back_prop)
    x = _x(64, seed=4)
    jh = jax.jit(lambda p, x: jf.field_double_grad(p, x, jcfg))(
        jp, jnp.asarray(x))
    th = tf.field_double_grad(tp, torch.as_tensor(x), tcfg)
    assert th.shape == (64, 3, 3)
    assert _rel_max(th.detach(), jh) <= 1e-4
    _, jg = jf.field_with_grad(jp, jnp.asarray(x), jcfg)
    _, tg = tf.field_with_grad(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(float(tf.compute_abs_loss(tg.detach())),
                               float(jf.compute_abs_loss(jg)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tf.compute_double_field_loss(th)),
        float(jf.compute_double_field_loss(jh)), rtol=1e-5)


@pytest.mark.parametrize("grid,back_prop", [("cube", False), ("tet", True),
                                            ("cube", True), ("cell", True)])
def test_double_field_loss_gradient_matches_jax(grid, back_prop):
    """The params gradient of compute_double_field_loss(field_double_grad)
    within 1e-4 of max of jax.grad's, leaf by leaf. With back_prop it
    takes the encode's third derivative: the second order's own
    gradients (ops/hashgrid.py _HashGridEncodeGrad) differentiated
    again."""
    jcfg, tcfg, jp, tp = _field(grid, back_prop=back_prop)
    x = _x(64, seed=5)
    table = tp["table"].detach().clone().requires_grad_(True)
    layers = [{k: v.detach().clone().requires_grad_(True)
               for k, v in layer.items()}
              for layer in tp["decoder"]["layers"]]
    params = {"table": table, "decoder": {"layers": layers}}
    loss = tf.compute_double_field_loss(
        tf.field_double_grad(params, torch.as_tensor(x), tcfg))
    loss.backward()
    lj, gj = jax.value_and_grad(lambda p: jf.compute_double_field_loss(
        jf.field_double_grad(p, jnp.asarray(x), jcfg)))(jp)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    assert np.abs(np.asarray(gj["table"])).max() > 0
    assert _rel_max(table.grad, gj["table"]) <= 1e-4
    for layer, jlayer in zip(layers, gj["decoder"]["layers"]):
        for k, v in layer.items():
            if np.abs(np.asarray(jlayer[k])).max() > 0:
                assert _rel_max(v.grad, jlayer[k]) <= 1e-4, k


@pytest.mark.parametrize("grid,n_features", [("tet", 2), ("cube", 4),
                                             ("cell", 2)])
def test_second_order_table_grad_stream_matches_f64(grid, n_features):
    """The table gradient of the position gradient (back_prop=True's
    second-order term), taken by autograd through hashgrid_encode: the
    stream of s[l, c] * g[l, f] at the corner rows, s = (dw/dx) u by
    forward-mode autograd, through its route's plain version (K1's
    stream interface over feature pairs, K5's stream entry in the cell
    layout), within 1e-5 of max of the same stream summed by index_add_
    in float64."""
    cfg = thg.HashGridConfig(n_levels=4, n_features=n_features,
                             log2_hashmap_size=10, per_level_scale=1.5,
                             **_GRIDS[grid])
    rng = np.random.default_rng(7)
    n, L, F = 2000, cfg.n_levels, n_features
    x = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(n, L * F)).astype(np.float32))
    table = torch.as_tensor(rng.normal(size=(cfg.total_entries,
                                             cfg.row_width))
                            .astype(np.float32)).requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    (d_x,) = torch.autograd.grad((thg.hashgrid_encode(table, xx, cfg)
                                  * g).sum(), xx, create_graph=True)
    (got,) = torch.autograd.grad((d_x * u).sum(), table)

    def weights(xx):
        idx, w = thg._indices_weights(xx, cfg)
        return w, idx

    _, s, idx = torch.func.jvp(weights, (x,), (u,), has_aux=True)
    vals = (s.double().reshape(n, L, -1, 1)
            * g.double().reshape(n, L, 1, F))
    want = torch.zeros((cfg.total_entries, cfg.row_width),
                       dtype=torch.float64)
    want.index_add_(0, idx.reshape(-1),
                    vals.reshape(idx.numel(), cfg.row_width))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(want.abs().max()) > 0
    assert _rel_max(got, want) <= 1e-5


def test_sinusoidal_encode_matches_jax():
    x = _x(50, seed=6) * 4
    for lo, hi, ident in ((0, 3, True), (2, 6, False), (1, 1, True)):
        want = jmn.sinusoidal_encode(jnp.asarray(x), lo, hi, ident)
        got = tmn.sinusoidal_encode(torch.as_tensor(x), lo, hi, ident)
        assert got.shape[-1] == tmn.sinusoidal_dim(3, lo, hi, ident) \
            or lo == hi
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_field_mlp_matches_jax():
    """The SIREN field and its position gradient on JAX's weights within
    1e-5 relative to max; the port's own init has JAX's shapes and
    bounds."""
    cfg = dict(hidden_size=32, num_layers=3)
    jcfg, tcfg = jf.FieldMLPConfig(**cfg), tf.FieldMLPConfig(**cfg)
    jp = jf.field_mlp_init(jax.random.PRNGKey(2), jcfg)
    tp = field_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = _x(200, seed=7, scale=1.5)
    jv, jg = jf.field_mlp_with_grad(jp, jnp.asarray(x), jcfg)
    tv, tg = tf.field_mlp_with_grad(tp, torch.as_tensor(x), tcfg)
    assert _rel_max(tv.detach(), jv) <= 1e-5
    assert _rel_max(tg.detach(), jg) <= 1e-5
    assert _rel_max(tf.field_mlp_apply(tp, torch.as_tensor(x), tcfg),
                    jf.field_mlp_apply(jp, jnp.asarray(x), jcfg)) <= 1e-5
    own = tf.field_mlp_init(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own,
                                  is_leaf=torch.is_tensor) == shapes
    assert float(own["layers"][0]["w"].abs().max()) <= 1.0 / 21
    bound = np.sqrt(6.0 / 32) / 30.0
    assert float(own["out"]["w"].abs().max()) <= bound


def test_delta_field_matches_jax():
    cfg = dict(log2_hashmap_size=12, n_levels=4, max_resolution=256)
    jcfg, tcfg = jf.DeltaFieldConfig(**cfg), tf.DeltaFieldConfig(**cfg)
    jp = jf.delta_field_init(jax.random.PRNGKey(3), jcfg)
    jp["table"] = jp["table"] * 1e3
    tp = field_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert tcfg.hashgrid.level_offsets == jcfg.hashgrid.level_offsets
    x = _x(200, seed=8, scale=1.5)
    want = jf.delta_field_apply(jp, jnp.asarray(x), jcfg)
    got = tf.delta_field_apply(tp, torch.as_tensor(x), tcfg)
    assert got.shape == (200,)
    assert _rel_max(got, want) <= 1e-5
    own = tf.delta_field_init(torch.Generator().manual_seed(0), tcfg)
    assert own["table"].shape == tuple(jp["table"].shape)
