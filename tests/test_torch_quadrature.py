"""The port's stage-4 quadrature renderer (render/quadrature.py) against
the JAX package's, on the same seeded numpy inputs: the row and packed
composites (forward and gradients), the stable re-sorts with equal-depth
ties, the packing of dense rows and of a host stream with and without
truncation, the ray mask, and the three finetune renders (dense rows,
packed rows, host stream) with the same NGP and deformation field
(JAX's init carried across with utils/convert.py), the same hits and
the same barycentric uniforms (JAX's draw fed to the port): outputs and
every parameter's gradient, with the radiance field live and frozen.
Then the per-face deformation scatter and the vertex update, and
snap_pack_cap."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.geometry.native import BVH as JBVH
from quadraturefields_tpu.models import field as jf
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.render import quadrature as jq
from quadraturefields_tpu.train import stage4_finetune as jst4
from quadraturefields_tpu.utils import batching as jbatch
from quadraturefields_tpu_torch.models import field as tf
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.render import quadrature as tq
from quadraturefields_tpu_torch.train.stage1_ngp import _as_leaf_params
from quadraturefields_tpu_torch.utils import batching as tbatch
from quadraturefields_tpu_torch.utils.convert import (
    field_params_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

SMALL = dict(n_levels=4, log2_hashmap_size=12, field_log2_hashmap_size=12,
             field_max_res=64, num_lobes=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(compute_dtype="float32", field_scale=1e3):
    """(JAX params {"rf", "field"}, port leaf params, ngp cfgs (jax,
    port), field cfgs (jax, port), aabb) at a small size: Stage4Config's
    NGP and field with L4, T 2^12, the NGP table scaled by 1e4 and the
    field's by `field_scale`, so both matter."""
    jcfg = jst4.Stage4Config(**SMALL)
    jn = dataclasses.replace(jcfg.ngp_config(), compute_dtype=compute_dtype)
    jfc = jcfg.field_config()
    from quadraturefields_tpu_torch.train import stage4_finetune as tst4

    tcfg = tst4.Stage4Config(**SMALL)
    tn = dataclasses.replace(tcfg.ngp_config(), compute_dtype=compute_dtype)
    tfc = tcfg.field_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    rf = jngp.ngp_init(k1, jn)
    rf["table"] = rf["table"] * 1e4
    field = jf.field_init(k2, jfc)
    field["table"] = field["table"] * field_scale
    jp = {"rf": rf, "field": field}
    tp = {"rf": _as_leaf_params(params_from_jax(_np(rf))),
          "field": _as_leaf_params(field_params_from_jax(_np(field)))}
    return jp, tp, (jn, tn), (jfc, tfc), jcfg.aabb


def sphere_mesh(n=20):
    """A closed triangulated sphere of radius 0.5 (a UV sphere)."""
    th = np.linspace(0, np.pi, n)[1:-1]
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 -1).reshape(-1, 3) * 0.5
    v = np.concatenate([v, [[0, 0, 0.5], [0, 0, -0.5]]]).astype(np.float32)
    nt, npp = th.size, ph.size
    faces = []
    for i in range(nt - 1):
        for j in range(npp):
            a, b = i * npp + j, i * npp + (j + 1) % npp
            c, d = a + npp, b + npp
            faces += [[a, c, b], [b, c, d]]
    top, bot = nt * npp, nt * npp + 1
    for j in range(npp):
        faces.append([top, j, (j + 1) % npp])
        last = (nt - 1) * npp
        faces.append([bot, last + (j + 1) % npp, last + j])
    return v, np.asarray(faces, np.int32)


def hits_inputs(n_rays=48, max_hits=6, seed=0, ties=True):
    """Rays from a camera at distance 2 through the sphere mesh and the
    BVH's dense rows of their hits. With `ties`, some rays' second hit
    repeats the first's depth on another face (a shared edge's double
    hit)."""
    rng = np.random.default_rng(seed)
    verts, faces = sphere_mesh()
    cam = np.array([0.3, -2.0, 0.4], np.float32)
    target = rng.uniform(-0.45, 0.45, (n_rays, 3)).astype(np.float32)
    d = target - cam
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(cam, d.shape).astype(np.float32).copy()
    # a few rays miss the mesh entirely
    d[:3] = np.array([0.0, 1.0, 0.9]) / np.linalg.norm([0.0, 1.0, 0.9])
    tri, ts, _ = JBVH(verts, faces).intersect(o, d, max_hits=max_hits)
    if ties:
        two = np.flatnonzero((tri[:, 1] >= 0) & (tri[:, 2] < 0))[:4]
        ts[two, 1] = ts[two, 0]
        tri[two, 1] = (tri[two, 0] + 7) % faces.shape[0]
    pixels = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    bary = rng.uniform(0, 1, (n_rays, max_hits, 3)).astype(np.float32)
    return dict(o=o, d=d.astype(np.float32), tri=tri, ts=ts, valid=tri >= 0,
                verts=verts, faces=faces, pixels=pixels, bary=bary,
                fv=verts[faces[np.maximum(tri, 0)]],
                table=verts[faces])


def host_pack(tri_ids, ts, cap):
    """Numpy model of the C++ packed cast's compaction: the valid hits
    ray-major and depth-sorted, slots = ray*H + k, truncated at cap."""
    R, H = tri_ids.shape
    flat = np.flatnonzero(tri_ids.reshape(-1) >= 0)
    keep = flat[:cap]
    slots = np.full((cap,), R * H, np.int32)
    tri = np.full((cap,), -1, np.int32)
    t = np.zeros((cap,), np.float32)
    slots[:keep.size] = keep
    tri[:keep.size] = tri_ids.reshape(-1)[keep]
    t[:keep.size] = ts.reshape(-1)[keep]
    return slots, tri, t, flat.size


def _j_rgb_sigma(p, x, d, a, c):
    rgb, density = jngp.ngp_forward(p, x, d, a, c)
    return rgb, density[..., 0]


def _t_rgb_sigma(p, x, d, a, c):
    rgb, density = tngp.ngp_forward(p, x, d, a, c)
    return rgb, density[..., 0]


def leaves(tree, prefix=""):
    """(name, leaf) pairs of a params tree in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def assert_grads_match(tp, jgrads, rtol=1e-4):
    """Every port leaf's .grad within rtol of max |JAX grad| of JAX's."""
    for (name, t), (jname, j) in zip(leaves(tp), leaves(jgrads)):
        assert name == jname
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0, name
        err = np.abs(t.grad.numpy() - j).max()
        assert err <= rtol * scale, (name, err, scale)


def test_row_composite_matches_jax():
    """Forward within 1e-6 and the gradients of a loss of all four
    outputs within 1e-5 of max, for each background mode."""
    rng = np.random.default_rng(0)
    R, H = 9, 6
    args = [rng.uniform(0, 1, (R, H, 3)), rng.uniform(0, 60, (R, H)),
            np.sort(rng.uniform(1, 3, (R, H)), axis=1),
            np.full((R, H), 5e-3)]
    args = [a.astype(np.float32) for a in args]
    valid = rng.random((R, H)) > 0.3
    bkgd = np.array([0.2, 0.5, 0.8], np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((R, 3), (R, 1), (R, 1), (R, H))]
    for bg in ("white", "black", "random"):
        def jloss(rgbs, sigmas):
            outs = jq.row_composite(rgbs, sigmas, jnp.asarray(args[2]),
                                    jnp.asarray(args[3]),
                                    jnp.asarray(valid), bg,
                                    jnp.asarray(bkgd))
            return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

        (_, jouts), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(args[0]), jnp.asarray(args[1]))
        rgbs, sigmas = (torch.tensor(a, requires_grad=True)
                        for a in args[:2])
        touts = tq.row_composite(rgbs, sigmas, torch.as_tensor(args[2]),
                                 torch.as_tensor(args[3]),
                                 torch.as_tensor(valid), bg,
                                 torch.as_tensor(bkgd))
        sum((o * torch.as_tensor(c)).sum()
            for o, c in zip(touts, cot)).backward()
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=0, atol=1e-6, err_msg=bg)
        for t, j in zip((rgbs, sigmas), jg):
            j = np.asarray(j)
            assert np.abs(t.grad.numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_resort_rows_is_stable_on_ties():
    """Equal depths keep their order in both packages (jnp.argsort and
    the port's are stable), invalid entries go to the tail."""
    ts = np.array([[3.0, 1.0, 1.0, 2.0, 1.0], [5.0, 4.0, 6.0, 4.0, 4.0]],
                  np.float32)
    valid = np.array([[1, 1, 1, 0, 1], [1, 1, 0, 1, 1]], bool)
    j = np.asarray(jq.resort_rows(jnp.asarray(ts), jnp.asarray(valid)))
    t = tq.resort_rows(torch.as_tensor(ts), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, [[1, 2, 4, 0, 3], [1, 3, 4, 0, 2]])
    a = np.arange(30, dtype=np.float32).reshape(2, 5, 3)
    (jp,) = jq.apply_row_permutation(jnp.asarray(j), jnp.asarray(a))
    (tp,) = tq.apply_row_permutation(torch.as_tensor(t), torch.as_tensor(a))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("cap", [None, 17])
def test_pack_hit_rows_and_ray_mask_match_jax(cap):
    """pack_hit_rows (no truncation and a cap that truncates) and
    packed_hits_from_host on the C++ packed cast give JAX's stream bit
    for bit; packed_ray_mask masks the same rays."""
    h = hits_inputs()
    R, H = h["tri"].shape
    cap = cap or R * H
    jh = jq.HitRows(jnp.asarray(h["tri"]), jnp.asarray(h["ts"]),
                    jnp.asarray(h["valid"]))
    th = tq.HitRows(torch.as_tensor(h["tri"]), torch.as_tensor(h["ts"]),
                    torch.as_tensor(h["valid"]))
    jph, tph = jq.pack_hit_rows(jh, cap), tq.pack_hit_rows(th, cap)
    slots, tri, t, total = host_pack(h["tri"], h["ts"], cap)
    jhost = jq.packed_hits_from_host(jnp.asarray(slots), jnp.asarray(tri),
                                     jnp.asarray(t), total, R, H)
    thost = tq.packed_hits_from_host(torch.as_tensor(slots),
                                     torch.as_tensor(tri),
                                     torch.as_tensor(t), total, R, H)
    for jp_, tp_ in ((jph, tph), (jhost, thost), (jph, thost)):
        for name in jq.PackedHits._fields:
            np.testing.assert_array_equal(
                getattr(tp_, name).numpy(), np.asarray(getattr(jp_, name)),
                err_msg=name)
        np.testing.assert_array_equal(
            tq.packed_ray_mask(tp_, R, cap).numpy(),
            np.asarray(jq.packed_ray_mask(jp_, R, cap)))
    mask = tq.packed_ray_mask(tph, R, cap).numpy()
    assert mask.all() == (total <= cap)
    assert int(tph.num_valid) == total


def test_packed_composite_matches_jax():
    """On a ray-sorted stream with pads (ray == R, t = 0): the forward
    within 1e-6 and the gradients in rgbs and sigmas within 1e-5 of max
    (K3's plain version and its gather backward on the CPU)."""
    rng = np.random.default_rng(3)
    R, M, n_pad = 12, 70, 10
    ray = np.concatenate([np.sort(rng.integers(0, R, M - n_pad)),
                          np.full(n_pad, R)]).astype(np.int32)
    valid = ray < R
    ts = np.where(valid, rng.uniform(1, 3, M), 0).astype(np.float32)
    rgbs = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    sig = rng.uniform(0, 80, M).astype(np.float32)
    bkgd = np.array([0.1, 0.4, 0.7], np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((R, 3), (R, 1), (R, 1), (M,))]

    def jloss(rgbs, sig):
        outs = jq.packed_composite(jnp.asarray(ray), rgbs, sig,
                                   jnp.asarray(ts), jnp.asarray(valid), R,
                                   5e-3, "random", jnp.asarray(bkgd))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    (_, jouts), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(rgbs),
                                              jnp.asarray(sig))
    trgbs = torch.tensor(rgbs, requires_grad=True)
    tsig = torch.tensor(sig, requires_grad=True)
    touts = tq.packed_composite(torch.as_tensor(ray), trgbs, tsig,
                                torch.as_tensor(ts), torch.as_tensor(valid),
                                R, 5e-3, "random", torch.as_tensor(bkgd))
    sum((o * torch.as_tensor(c)).sum() for o, c in zip(touts, cot)).backward()
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    for t, j in zip((trgbs, tsig), jg):
        j = np.asarray(j)
        assert np.abs(t.grad.numpy() - j).max() <= 1e-5 * np.abs(j).max()


def _render_kwargs(pack, h, bary, freeze, bg="random"):
    return dict(scaling=0.0434, render_step_size=5e-3, bg_color=bg,
                render_bkgd=pack(np.array([0.3, 0.6, 0.9], np.float32)),
                bary_uniforms=pack(bary), stop_gradient_rf=freeze)


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("route", ["rows", "packed", "packed_trunc",
                                   "stream", "stream_trunc"])
def test_finetune_render_matches_jax(route, freeze):
    """The three finetune renders with the same f32 NGP and deformation
    field, hits (equal-depth ties included), uniforms and background:
    rgb, alpha, depth, weights and dh within 1e-5 (and 1e-5 relative:
    depth ~ 2 under XLA's fused rounding), the sorted triangle
    ids, validity, ray mask and hit counts equal, reg within 1e-5
    relative; then a loss of rgb, depth and reg: every field gradient
    within 1e-4 of its max of JAX's, every rf gradient within 1e-3.
    Frozen (stop_gradient_rf), the rf gets no gradient in the port and
    zeros in JAX."""
    h = hits_inputs()
    R, H = h["tri"].shape
    cap = 29 if route.endswith("trunc") else R * H
    jp, tp, (jn, tn), (jfc, tfc), aabb = models()
    rng = np.random.default_rng(9)
    cot_rgb = rng.normal(size=(R, 3)).astype(np.float32)
    cot_depth = rng.normal(size=(R, 1)).astype(np.float32)

    def run(mod, params, pack, fwd, fapply, ncfg, fcfg):
        kw = dict(ngp_forward_fn=fwd, field_apply_fn=fapply,
                  **_render_kwargs(pack, h, h["bary"], freeze))
        if route == "rows":
            hits = mod.HitRows(pack(h["tri"]), pack(h["ts"]),
                               pack(h["valid"]))
            return mod.render_finetune_rows(
                params["rf"], params["field"], hits, pack(h["o"]),
                pack(h["d"]), pack(h["fv"]), pack(aabb), ncfg, fcfg, **kw)
        if route.startswith("packed"):
            hits = mod.HitRows(pack(h["tri"]), pack(h["ts"]),
                               pack(h["valid"]))
            return mod.render_finetune_packed(
                params["rf"], params["field"], hits, pack(h["o"]),
                pack(h["d"]), pack(h["fv"]), pack(aabb), ncfg, fcfg,
                pack_cap=cap, **kw)
        slots, tri, t, total = host_pack(h["tri"], h["ts"], cap)
        ph = mod.packed_hits_from_host(pack(slots), pack(tri), pack(t),
                                       total, R, H)
        return mod.render_finetune_packed_stream(
            params["rf"], params["field"], ph, R, H, pack(h["o"]),
            pack(h["d"]), pack(h["table"]), pack(aabb), ncfg, fcfg, **kw)

    def jloss(params):
        out = run(jq, params, jnp.asarray, _j_rgb_sigma, jf.field_apply, jn,
                  jfc)
        loss = (jnp.sum(out["rgb"] * cot_rgb)
                + jnp.sum(out["depth"] * cot_depth) + 100.0 * out["reg"])
        return loss, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tout = run(tq, tp, torch.as_tensor, _t_rgb_sigma, tf.field_apply, tn,
               tfc)
    tl = ((tout["rgb"] * torch.as_tensor(cot_rgb)).sum()
          + (tout["depth"] * torch.as_tensor(cot_depth)).sum()
          + 100.0 * tout["reg"])
    tl.backward()
    for k in ("rgb", "alpha", "depth", "weights", "dh"):
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("tri_ids", "valid", "n_hits") + (
            ("ray_mask", "n_rendered") if route != "rows" else ()):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(tout["reg"].detach()),
                               float(jout["reg"]),
                               rtol=1e-5)
    assert float(jout["reg"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    if route.endswith("trunc"):
        assert not np.asarray(jout["ray_mask"]).all()
    # the deformed positions enter the NGP's finest level (res 4096),
    # which turns their f32 ulps (XLA fuses and reassociates; the port
    # does not) into ~1e-4 relative changes of the rf's features
    assert_grads_match(tp["field"], jg["field"], rtol=1e-4)
    if freeze:
        assert all(p.grad is None for _, p in leaves(tp["rf"]))
        assert not any(np.asarray(g).any() for _, g in leaves(jg["rf"]))
    else:
        assert_grads_match(tp["rf"], jg["rf"], rtol=1e-3)


def test_random_barycentric_vertices_matches_jax():
    rng = np.random.default_rng(5)
    tv = rng.normal(size=(7, 4, 3, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (7, 4, 3)).astype(np.float32)
    u[0, 0] = 0.0  # all-zero weights: the 1e-6 keeps it finite
    j = jq.random_barycentric_vertices(None, jnp.asarray(tv),
                                       uniforms=jnp.asarray(u))
    t = tq.random_barycentric_vertices(None, torch.as_tensor(tv),
                                       uniforms=torch.as_tensor(u))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-7)
    g = torch.Generator().manual_seed(0)
    drawn = tq.random_barycentric_vertices(g, torch.as_tensor(tv))
    assert drawn.shape == (7, 4, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("layout", ["rows", "stream"])
def test_mesh_accumulate_and_update_match_jax(layout):
    """The per-face scatter of a render's (dh, weights, tri_ids, valid)
    within 1e-6 of max (index_add_ against XLA's segment_sum), twice
    accumulated onto a cache, then the vertex update on the sphere
    mesh (clipped to +-scaling) within 1e-6."""
    h = hits_inputs()
    R, H = h["tri"].shape
    rng = np.random.default_rng(2)
    if layout == "rows":
        dh = rng.normal(0, 0.01, (R, H, 3)).astype(np.float32)
        w = rng.uniform(0, 1, (R, H)).astype(np.float32)
        tri, valid = h["tri"], h["valid"]
    else:
        slots, tri, _, _ = host_pack(h["tri"], h["ts"], R * H)
        valid = tri >= 0
        dh = rng.normal(0, 0.01, (R * H, 3)).astype(np.float32)
        w = rng.uniform(0, 1, R * H).astype(np.float32)
    n_faces = h["faces"].shape[0]
    jd, jw = jnp.zeros((n_faces, 3)), jnp.full((n_faces,), 1e-8)
    td, tw = torch.zeros((n_faces, 3)), torch.full((n_faces,), 1e-8)
    for _ in range(2):
        jd, jw = jq.mesh_accumulate_deformation(
            jd, jw, jnp.asarray(dh), jnp.asarray(w), jnp.asarray(tri),
            jnp.asarray(valid), n_faces)
        td, tw = tq.mesh_accumulate_deformation(
            td, tw, torch.as_tensor(dh), torch.as_tensor(w),
            torch.as_tensor(tri), torch.as_tensor(valid), n_faces)
    for t, j in ((td, jd), (tw, jw)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()
    assert (tw.numpy() > 1e-3).sum() > 10
    jv = jq.mesh_update_vertices(h["verts"], h["faces"], jd, jw, 0.0434)
    tv = tq.mesh_update_vertices(h["verts"], h["faces"], td, tw, 0.0434)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    moved = np.abs(tv - h["verts"]).max(axis=1)
    assert moved.max() > 1e-3 and moved.max() <= 0.0434 + 1e-6


def test_snap_pack_cap_matches_jax():
    for pack_cap in (1 << 12, 163_840, 1 << 19, 1 << 23):
        for total in (0, 10, 4096, 5000, 99_999, 163_840, 262_147,
                      (1 << 22) + 12_345):
            assert tbatch.snap_pack_cap(total, pack_cap) == \
                jbatch.snap_pack_cap(total, pack_cap), (total, pack_cap)
