"""The port's stage-2 scans and render (ops/scan.py, render/renderer.py
`render_rays_field`) against the JAX package's, on the same seeded numpy
inputs: the visibility test, the reverse weights and the quadrature
composite on padded ray-sorted buffers (padding carries ray index ==
n_rays and t = 0, as the march lays it out), and the stage-2 render with
the same NGP weights, occupancy, rays and stratified jitter (JAX's draw
fed to the port)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.data.fixture import FixtureScene
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops import grid as jgrid
from quadraturefields_tpu.ops import scan as jscan
from quadraturefields_tpu.render import renderer as jr
from quadraturefields_tpu.train import stage2_field as jst2
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.ops import scan as tscan
from quadraturefields_tpu_torch.render import renderer as tr
from quadraturefields_tpu_torch.train import stage2_field as tst2
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)


def _padded(seed=0, n_rays=40, s=1200, n_pad=150):
    """A ray-sorted packed buffer: per ray a run of contiguous intervals
    from its own entry t, then `n_pad` padding slots (ray n_rays, t 0,
    sigma nonzero: the scans must ignore it through `valid`)."""
    rng = np.random.default_rng(seed)
    ray = np.sort(rng.integers(0, n_rays, s - n_pad))
    ts = np.empty(s - n_pad, np.float32)
    for r in range(n_rays):
        sel = np.flatnonzero(ray == r)
        ts[sel] = rng.uniform(1.5, 3.0) + 5e-3 * np.arange(sel.size)
    ts = ts + rng.uniform(0, 1e-3, ts.size).astype(np.float32)
    pad_t = np.zeros(n_pad, np.float32)
    return dict(
        ray=np.concatenate([ray, np.full(n_pad, n_rays)]).astype(np.int32),
        ts=np.concatenate([ts, pad_t]),
        te=np.concatenate([ts + 5e-3, pad_t]).astype(np.float32),
        sig=rng.exponential(30.0, s).astype(np.float32),
        valid=np.arange(s) < s - n_pad,
        rgb=rng.uniform(0, 1, (s, 3)).astype(np.float32),
        n_rays=n_rays,
    )


def test_reverse_weights_match_jax_on_padded_buffers():
    """Within 1e-6: the same mirror value max(t_starts) + max(t_ends)
    over the padded buffer and the same flips; the segmented sums
    associate differently (doubling scans against XLA's associative
    scan). Padding gets weight 0 in both."""
    for seed in range(3):
        b = _padded(seed)
        want = jscan.reverse_weights(
            jnp.asarray(b["ts"]), jnp.asarray(b["te"]), jnp.asarray(b["sig"]),
            jnp.asarray(b["ray"]), b["n_rays"], jnp.asarray(b["valid"]))
        got = tscan.reverse_weights(
            torch.as_tensor(b["ts"]), torch.as_tensor(b["te"]),
            torch.as_tensor(b["sig"]), torch.as_tensor(b["ray"]),
            b["n_rays"], torch.as_tensor(b["valid"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert not got.numpy()[~b["valid"]].any()
        assert got.numpy().max() > 0.1


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
def test_visibility_matches_jax(alpha_thre):
    b = _padded(4)
    sig = np.where(b["valid"], b["sig"], 0.0).astype(np.float32)
    jb = jscan.mark_pack_boundaries(jnp.asarray(b["ray"]))
    tb = tscan.mark_pack_boundaries(torch.as_tensor(b["ray"]))
    want = jscan.render_visibility_from_density(
        jnp.asarray(b["ts"]), jnp.asarray(b["te"]), jnp.asarray(sig), jb,
        early_stop_eps=1e-2, alpha_thre=alpha_thre)
    got = tscan.render_visibility_from_density(
        torch.as_tensor(b["ts"]), torch.as_tensor(b["te"]),
        torch.as_tensor(sig), tb, early_stop_eps=1e-2,
        alpha_thre=alpha_thre)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


@pytest.mark.parametrize("bg", ["white", "black", "random"])
def test_derive_properties_matches_jax(bg):
    """rgb, alpha and depth per ray and the weights within 1e-5."""
    b = _padded(5)
    sig = np.where(b["valid"], b["sig"], 0.0).astype(np.float32)
    depths = (b["ts"] + b["te"]) / 2
    deltas = b["te"] - b["ts"]
    bkgd = np.array([0.2, 0.5, 0.7], np.float32)
    want = jscan.derive_properties(
        jnp.asarray(b["rgb"]), jnp.asarray(sig), jnp.asarray(depths),
        jnp.asarray(deltas), jnp.asarray(b["ray"]), b["n_rays"],
        bg_color=bg, render_bkgd=jnp.asarray(bkgd))
    got = tscan.derive_properties(
        torch.as_tensor(b["rgb"]), torch.as_tensor(sig),
        torch.as_tensor(depths), torch.as_tensor(deltas),
        torch.as_tensor(b["ray"]), b["n_rays"], bg_color=bg,
        render_bkgd=torch.as_tensor(bkgd))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def occupancy(scene_type, res, render_step_size):
    """(occs, binaries) numpy: the fixture sphere's occupancy on a res^3
    grid over [-1.5, 1.5]^3, or every cell for a 360 scene."""
    if scene_type == "360":
        return np.ones(res**3, np.float32), np.ones((res,) * 3, bool)
    lin = np.linspace(-1.5, 1.5, res)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = (FixtureScene().sigma(grid.reshape(-1, 3))
            * render_step_size).astype(np.float32)
    return occs, (occs > 0.01).reshape(res, res, res)


def rays(scene_type, n=96, seed=9):
    """(origins, viewdirs) numpy [n, 3]: from a sphere of radius 2.8
    (0.28 for 360 scenes, inside the contracted box) towards points near
    the centre."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-0.4, 0.4, (n, 3))
    o = rng.normal(size=(n, 3))
    o = 2.8 * o / np.linalg.norm(o, axis=1, keepdims=True)
    if scene_type == "360":
        o = o * 0.1
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _render_inputs(scene_type):
    """The stage-2 configs of both packages at a small size, JAX's NGP
    (table scaled by 1e4, f32 MLPs) carried to the port, the occupancy
    and the rays."""
    kw = dict(n_levels=4, log2_hashmap_size=12, batch_size_log2=13,
              render_step_size=2e-2, num_lobes=0, scene_type=scene_type,
              scene="fixture" if scene_type == "synthetic" else "garden")
    jcfg, tcfg = jst2.Stage2Config(**kw), tst2.Stage2Config(**kw)
    assert tcfg.render_config() == tr.RenderConfig(
        **dataclasses.asdict(jcfg.render_config()))
    jn = dataclasses.replace(jcfg.ngp_config(), compute_dtype="float32")
    tn = dataclasses.replace(tcfg.ngp_config(), compute_dtype="float32")
    jp = jngp.ngp_init(jax.random.PRNGKey(0), jn)
    jp["table"] = jp["table"] * 1e4
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    aabb = jcfg.aabb
    occs, binaries = occupancy(scene_type, jcfg.grid_resolution,
                               jcfg.render_step_size)
    jocc = jgrid.OccGridState(jnp.asarray(occs), jnp.asarray(binaries),
                              jnp.asarray(aabb))
    tocc = occ_state_from_jax(occs, binaries, aabb)
    o, d = rays(scene_type)
    bkgd = np.array([0.3, 0.6, 0.9], np.float32)
    return (jcfg, tcfg, jn, tn, jp, tp, jocc, tocc, o, d, bkgd)


@pytest.mark.parametrize("scene_type", ["synthetic", "360"])
def test_render_rays_field_matches_jax(scene_type):
    """The same sample set (valid, num_valid exactly), positions within
    1e-6 relative (the march's t knots may round an ulp apart: XLA
    contracts multiply-adds), dirs within 1e-6, forward and reverse
    weights, rgb and opacity within 1e-5, on f32 MLPs."""
    (jcfg, tcfg, jn, tn, jp, tp, jocc, tocc, o, d,
     bkgd) = _render_inputs(scene_type)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, occ, o, d, b: jr.render_rays_field(
        p, jnp.asarray(jcfg.aabb), jn, occ, o, d, jcfg.render_config(),
        render_bkgd=b, stratified=True, key=key))(
        jp, jocc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(bkgd))
    u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    with torch.no_grad():
        got = tr.render_rays_field(
            tp, torch.as_tensor(tcfg.aabb), tn, tocc, torch.as_tensor(o),
            torch.as_tensor(d), tcfg.render_config(),
            render_bkgd=torch.as_tensor(bkgd), stratified=True,
            t_jitter=torch.tensor(u))
    assert int(got.num_valid) == int(want.num_valid) > 500
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    valid = got.valid.numpy()
    for name, rtol, atol in (("positions", 1e-6, 1e-6), ("dirs", 0, 1e-6),
                             ("weights", 0, 1e-5), ("weights_rev", 0, 1e-5),
                             ("rgb", 0, 1e-5), ("opacity", 0, 1e-5)):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if g.shape[0] == valid.shape[0]:
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=name)
    assert not got.weights_rev.numpy()[~valid].any()
    assert got.weights_rev.numpy().max() > 1e-3
