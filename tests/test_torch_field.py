"""The port's quadrature field (models/field.py) against the JAX package's,
on the same seeded numpy inputs and carried-across weights: the field and
its position gradient (tet and cube corner grids, the cell grid), the
gradient of the stage-2 loss through the position gradient in the table
and the decoder, the second derivative, the two regularising losses, the
SIREN field, the delta field and the sinusoidal encoding; and the port's
refusal of back_prop=True where a graph through the position gradient
would be built. JAX runs on the CPU; the port takes each kernel's plain
version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.models import field as jf
from quadraturefields_tpu.models import mlp_nerf as jmn
from quadraturefields_tpu_torch.models import field as tf
from quadraturefields_tpu_torch.models import mlp_nerf as tmn
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


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_field_loss_gradient_matches_jax(grid):
    """The stage-2 loss through field_with_grad, masked as the trainer
    masks padding: the value within 1e-5 relative, the gradient of every
    leaf (table and decoder) within 1e-4 of its max. The decoder's output
    bias moves the field and not its gradient: its gradient is 0 in JAX,
    and autograd leaves it unset."""
    jcfg, tcfg, jp, tp = _field(grid)
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
    leaves = {"table": tp["table"]}
    tp["table"].requires_grad_(True)
    for i, layer in enumerate(tp["decoder"]["layers"]):
        for k, v in layer.items():
            leaves[f"{i}.{k}"] = v.requires_grad_(True)
    _, g = tf.field_with_grad(tp, torch.as_tensor(x), tcfg)
    lt = tf.field_loss(torch.as_tensor(w), torch.as_tensor(w_rev), g,
                       torch.as_tensor(dirs), mask=torch.as_tensor(mask))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = {"table": gj["table"]}
    for i, layer in enumerate(gj["decoder"]["layers"]):
        for k, v in layer.items():
            want[f"{i}.{k}"] = v
    assert set(want) == set(leaves)
    last_b = f"{len(gj['decoder']['layers']) - 1}.b"
    for name, leaf in leaves.items():
        if name == last_b:
            assert leaf.grad is None
            assert not np.asarray(want[name]).any()
            continue
        assert np.abs(np.asarray(want[name])).max() > 0, name
        assert _rel_max(leaf.grad, want[name]) <= 1e-4, name


def test_field_double_grad_and_losses_match_jax():
    """The [N, 3, 3] second derivative within 1e-4 of max, and the two
    regularising losses within 1e-5 relative."""
    jcfg, tcfg, jp, tp = _field("tet")
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


def test_back_prop_true_is_refused_where_a_graph_is_built():
    """back_prop=True: building the graph through the position gradient
    raises NotImplementedError (field_with_grad's default, the second
    derivative); the first-order gradient alone, which goes through the
    encode's position gradient, equals JAX's within 1e-4 of max."""
    jcfg, tcfg, jp, tp = _field("tet", back_prop=True)
    x = _x(128, seed=5)
    with pytest.raises(NotImplementedError):
        tf.field_with_grad(tp, torch.as_tensor(x), tcfg)
    with pytest.raises(NotImplementedError):
        tf.field_double_grad(tp, torch.as_tensor(x), tcfg)
    _, jg = jax.jit(lambda p, x: jf.field_with_grad(p, x, jcfg))(
        jp, jnp.asarray(x))
    _, tg = tf.field_with_grad(tp, torch.as_tensor(x), tcfg,
                               create_graph=False)
    assert _rel_max(tg, jg) <= 1e-4
    # the encode's branch is in it: back_prop=False gives another gradient
    _, t0 = tf.field_with_grad(
        tp, torch.as_tensor(x), tf.FieldConfig(**dict(_SMALL, interp="tet")),
        create_graph=False)
    assert _rel_max(tg, t0) > 1e-3


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
