"""The port's NGP model and its parts against the JAX package, on the same
weights (carried across by utils/convert.py) and numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops import activations as jact
from quadraturefields_tpu.ops import mlp as jmlp
from quadraturefields_tpu.ops import sh as jsh
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.ops import activations as tact
from quadraturefields_tpu_torch.ops import mlp as tmlp
from quadraturefields_tpu_torch.ops import sh as tsh
from quadraturefields_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

AABB = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, (n, 3)).astype(np.float32)   # some outside
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return x, d


def test_activations_match_jax():
    """Within 1e-6 relative: the same f32 elementwise formulas."""
    x, _ = _inputs(512, 1)
    aabb = jnp.asarray(AABB)
    np.testing.assert_allclose(
        tact.density_activation(torch.as_tensor(x)).numpy(),
        np.asarray(jact.density_activation(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(
        tact.contract_to_unisphere(torch.as_tensor(x * 2),
                                   torch.as_tensor(AABB)).numpy(),
        np.asarray(jact.contract_to_unisphere(jnp.asarray(x * 2), aabb)),
        rtol=1e-6, atol=1e-7)
    sel_t, y_t = tact.normalize_aabb(torch.as_tensor(x),
                                     torch.as_tensor(AABB))
    sel_j, y_j = jact.normalize_aabb(jnp.asarray(x), aabb)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)


def test_spherical_harmonics_match_jax():
    """Within 1e-6: polynomial of degree <= 3 in values <= 1."""
    _, d = _inputs(512, 2)
    d01 = (d + 1) / 2
    np.testing.assert_allclose(
        tsh.spherical_harmonics_deg4(torch.as_tensor(d01)).numpy(),
        np.asarray(jsh.spherical_harmonics_deg4(jnp.asarray(d01))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-3)])
def test_mlp_apply_matches_jax(dtype, tol):
    """f32 within 1e-5 (summation order); bf16 within 5e-3: both round
    the operands to bf16 and keep f32 products, but a hidden value whose
    f32 sums differ in the last bit can round to the next bf16."""
    params = jmlp.mlp_init(jax.random.PRNGKey(3), 32, 16, hidden_dim=64,
                           num_hidden_layers=2, bias=True)
    x = np.random.default_rng(4).normal(size=(1024, 32)).astype(np.float32)
    ref = np.asarray(jmlp.mlp_apply(params, jnp.asarray(x),
                                    compute_dtype=jnp.dtype(dtype)))
    got = tmlp.mlp_apply(params_from_jax(_np_tree(params)),
                         torch.as_tensor(x),
                         compute_dtype=getattr(torch, dtype)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


HEADS = [
    dict(head="sg", num_g_lobes=2),
    dict(head="sg_old", num_g_lobes=2),
    dict(head="mlp"),
    dict(head="sg", num_g_lobes=3, use_viewdirs=True),
]


@pytest.mark.parametrize("head_kw", HEADS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-3)])
def test_ngp_forward_matches_jax(head_kw, dtype, tol):
    """rgb and density within 1e-5 in f32 (summation order) and 5e-3 in
    bf16 (a bf16 rounding of an operand may flip, see the MLP test)."""
    kw = dict(n_levels=4, log2_hashmap_size=12, max_resolution=256,
              interp="tet", compute_dtype=dtype, **head_kw)
    jcfg, tcfg = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    params = jngp.ngp_init(jax.random.PRNGKey(0), jcfg)
    # lift the table out of its 1e-4 init so the encoding matters
    params["table"] = params["table"] * 1e4
    tparams = params_from_jax(_np_tree(params))
    x, d = _inputs()
    rgb_j, dens_j = jngp.ngp_forward(params, jnp.asarray(x), jnp.asarray(d),
                                     jnp.asarray(AABB), jcfg)
    rgb_t, dens_t = tngp.ngp_forward(tparams, torch.as_tensor(x),
                                     torch.as_tensor(d),
                                     torch.as_tensor(AABB), tcfg)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                               rtol=tol, atol=tol)
    if head_kw["head"] == "sg" and not head_kw.get("use_viewdirs"):
        f_j = jngp.ngp_features(params, jnp.asarray(x), jnp.asarray(AABB),
                                jcfg)
        f_t = tngp.ngp_features(tparams, torch.as_tensor(x),
                                torch.as_tensor(AABB), tcfg)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j),
                                   rtol=tol, atol=tol)


def test_ngp_init_layout_matches_jax():
    """Same tree, shapes and init ranges as the JAX ngp_init."""
    cfg = dict(n_levels=4, log2_hashmap_size=12, num_g_lobes=2)
    jp = _np_tree(jngp.ngp_init(jax.random.PRNGKey(0),
                                jngp.NGPConfig(**cfg)))
    tp = tngp.ngp_init(torch.Generator().manual_seed(0),
                       tngp.NGPConfig(**cfg))
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, jp)
    shapes_t = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert shapes_j == shapes_t
    assert float(tp["table"].abs().max()) <= 1e-4
    w0 = tp["mlp_base"]["layers"][0]["w"]
    assert float(w0.abs().max()) <= 1.0 / np.sqrt(w0.shape[0])
    assert "b" not in tp["mlp_base"]["layers"][0]
    assert "b" in tp["mlp_head"]["layers"][0]
