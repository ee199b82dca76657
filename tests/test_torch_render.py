"""The port's segmented scans and stage-1 renderers against the JAX
package, on the same weights, occupancy grid and rays."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops import grid as jg
from quadraturefields_tpu.ops import scan as jscan
from quadraturefields_tpu.render import renderer as jr
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.ops import scan as tscan
from quadraturefields_tpu_torch.render import renderer as tr
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)

from test_torch_grid import AABB, DT, _fixture_binaries, _rays

torch.set_num_threads(1)


def _packed(seed=0, n_rays=300, s=6000):
    """A sorted packed stream: rays of 0-60 samples, then sentinel
    padding (ray index == n_rays, sigma 0)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, n_rays)
    ray = np.repeat(np.arange(n_rays), counts)[:s]
    pad = s - ray.shape[0]
    ray = np.concatenate([ray, np.full(pad, n_rays)]).astype(np.int32)
    ts = rng.uniform(0, 4, s).astype(np.float32)
    te = ts + DT
    sig = rng.exponential(20.0, s).astype(np.float32)
    sig[ray == n_rays] = 0.0
    return ray, ts, te, sig


def test_segmented_scans_match_jax():
    """exclusive sum within 1e-4 relative of values up to ~30 (f32
    scans in another association order), exclusive product and the
    weights within 1e-6."""
    ray, ts, te, sig = _packed()
    jb = jscan.mark_pack_boundaries(jnp.asarray(ray))
    tb = tscan.mark_pack_boundaries(torch.as_tensor(ray))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    x = sig * DT
    np.testing.assert_allclose(
        tscan.exclusive_sum(torch.as_tensor(x), tb).numpy(),
        np.asarray(jax.jit(jscan.exclusive_sum)(jnp.asarray(x), jb)),
        rtol=1e-4, atol=1e-6)
    a = np.clip(x, 0, 1)
    np.testing.assert_allclose(
        tscan.exclusive_prod(torch.as_tensor(1 - a), tb).numpy(),
        np.asarray(jax.jit(jscan.exclusive_prod)(jnp.asarray(1 - a), jb)),
        rtol=0, atol=1e-6)
    wt = tscan.render_weight_from_density(
        torch.as_tensor(ts), torch.as_tensor(te), torch.as_tensor(sig), tb)
    wj = jax.jit(jscan.render_weight_from_density)(
        jnp.asarray(ts), jnp.asarray(te), jnp.asarray(sig), jb)
    for a_, b_ in zip(wt, wj):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), rtol=0,
                                   atol=1e-6)
    wa = tscan.render_weight_from_alpha(torch.as_tensor(a), tb)
    wja = jax.jit(jscan.render_weight_from_alpha)(jnp.asarray(a), jb)
    for a_, b_ in zip(wa, wja):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), rtol=0,
                                   atol=1e-6)
    vals = np.random.default_rng(1).random((len(ray), 3)).astype(np.float32)
    np.testing.assert_allclose(
        tscan.accumulate_along_rays(wt[0], torch.as_tensor(ray),
                                    torch.as_tensor(vals), 300).numpy(),
        np.asarray(jscan.accumulate_along_rays(
            wj[0], jnp.asarray(ray), jnp.asarray(vals), 300)),
        rtol=0, atol=1e-5)


def _scene():
    kw = dict(head="sg", num_g_lobes=2, n_levels=4, log2_hashmap_size=12,
              max_resolution=256, interp="tet", compute_dtype="float32")
    jcfg, tcfg = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    params = jngp.ngp_init(jax.random.PRNGKey(0), jcfg)
    params["table"] = params["table"] * 1e4
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    b = _fixture_binaries(128)
    jstate = jg.occ_grid_init(jnp.asarray(AABB), jg.OccGridConfig())
    jstate = jstate._replace(binaries=jnp.asarray(b))
    tstate = occ_state_from_jax(jstate.occs, b, AABB)
    stride, dil = jg.resolve_coarse_stride(-1, AABB, 128, 4, DT)
    rkw = dict(render_step_size=DT, max_steps=jg.max_march_steps(AABB, DT),
               max_samples_total=1 << 15, coarse_factor=4,
               coarse_stride=stride, coarse_dilation=dil)
    o, d = _rays(256, 7)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams,
                jstate=jstate, tstate=tstate, jrcfg=jr.RenderConfig(**rkw),
                trcfg=tr.RenderConfig(**rkw), o=o, d=d)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_render_rays_occgrid_matches_jax(scene):
    """rgb, opacity within 1e-5 and depth within 1e-4 (depth ~4 divided
    by opacity); the same sample set exactly."""
    s = scene

    @jax.jit
    def jax_render(params, state, o, d):
        return jr.render_rays_occgrid(params, jnp.asarray(AABB), s["jcfg"],
                                      state, o, d, s["jrcfg"],
                                      render_bkgd=jnp.ones(3))

    j = jax_render(s["params"], s["jstate"], jnp.asarray(s["o"]),
                   jnp.asarray(s["d"]))
    with torch.no_grad():
        t = tr.render_rays_occgrid(
            s["tparams"], torch.as_tensor(AABB), s["tcfg"], s["tstate"],
            torch.as_tensor(s["o"]), torch.as_tensor(s["d"]), s["trcfg"],
            render_bkgd=torch.ones(3))
    assert int(t.num_valid) == int(j.num_valid) > 1000
    np.testing.assert_array_equal(t.samples.ray_indices.numpy(),
                                  np.asarray(j.samples.ray_indices))
    assert float(t.opacity.max()) > 0.1
    np.testing.assert_allclose(t.rgb.numpy(), np.asarray(j.rgb), atol=1e-5)
    np.testing.assert_allclose(t.opacity.numpy(), np.asarray(j.opacity),
                               atol=1e-5)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth),
                               atol=1e-4)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               atol=1e-5)


def test_window_renderer_matches_jax_and_oneshot(scene):
    """The windowed renderer: rgb and opacity within 1e-5 of JAX's, the
    same sample count; and within 1e-4 of the port's one-shot render
    at a budget that truncates nothing (the carried transmittance
    reassociates the products)."""
    s = scene
    jfn = jr.make_test_renderer(s["params"], jnp.asarray(AABB), s["jcfg"],
                                s["jrcfg"], window_steps=64,
                                window_budget=256 * 64)
    tfn = tr.make_test_renderer(s["tparams"], torch.as_tensor(AABB),
                                s["tcfg"], s["trcfg"], window_steps=64,
                                window_budget=256 * 64)
    j = jfn(s["jstate"], jnp.asarray(s["o"]), jnp.asarray(s["d"]),
            render_bkgd=jnp.ones(3))
    with torch.no_grad():
        t = tfn(s["tstate"], torch.as_tensor(s["o"]), torch.as_tensor(s["d"]),
                render_bkgd=torch.ones(3))
        one = tr.render_rays_occgrid(
            s["tparams"], torch.as_tensor(AABB), s["tcfg"], s["tstate"],
            torch.as_tensor(s["o"]), torch.as_tensor(s["d"]),
            dataclasses.replace(s["trcfg"], max_samples_total=1 << 17),
            render_bkgd=torch.ones(3))
    assert t[3] == j[3] > 1000
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-5)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-5)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=1e-4)
    np.testing.assert_allclose(t[0].numpy(), one.rgb.numpy(), atol=1e-4)


def test_render_image_with_occgrid_pads_and_chunks(scene):
    """Chunked full-image render equals one call on all rays (at a
    budget where neither truncates)."""
    s = scene
    o, d = torch.as_tensor(s["o"][:50]), torch.as_tensor(s["d"][:50])

    def fn(oc, dc):
        return tr.render_rays_occgrid(
            s["tparams"], torch.as_tensor(AABB), s["tcfg"], s["tstate"],
            oc, dc, s["trcfg"], render_bkgd=torch.ones(3))[:4]

    with torch.no_grad():
        rgb, opa, dep, total = tr.render_image_with_occgrid(fn, o, d,
                                                            chunk=16)
        whole = fn(o, d)
    # the 14 padding rays start at the origin, inside the sphere, and
    # count their samples too
    assert rgb.shape == (50, 3) and total > int(whole[3])
    np.testing.assert_allclose(rgb.numpy(), whole[0].numpy(), atol=1e-6)
