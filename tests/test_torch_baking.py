"""The port's baking codecs and baked renderer (ops/quantize.py,
baking/compression.py, utils/png.py, render/baked.py, baking/stage6.py's
BakedRenderer) against the JAX package's, on the same seeded inputs:
every uint8 codec (the numpy and the torch half against JAX's numpy and
jnp halves), the feature compression and its PNG round trip, the PNG
codec against imageio in both directions (every row filter), the two
texel decodes, the hit texels, the dense baked renders, the four
BakedRenderer variants on one mesh, atlas and set of uint8 maps, and
the host packing of hits with and without overflow. JAX runs eagerly
where a fused multiply-add would move a texel coordinate by an ulp."""
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.baking import compression as jcomp
from quadraturefields_tpu.baking import stage6 as jst6
from quadraturefields_tpu.geometry.meshio import Mesh as JMesh
from quadraturefields_tpu.models.ngp import NGPConfig as JNGPConfig
from quadraturefields_tpu.ops import quantize as jqz
from quadraturefields_tpu.render import baked as jbaked
from quadraturefields_tpu.render import quadrature as jq
from quadraturefields_tpu_torch.baking import compression as tcomp
from quadraturefields_tpu_torch.baking import stage6 as tst6
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from quadraturefields_tpu_torch.models.ngp import NGPConfig as TNGPConfig
from quadraturefields_tpu_torch.ops import quantize as tqz
from quadraturefields_tpu_torch.render import baked as tbaked
from quadraturefields_tpu_torch.render import quadrature as tq
from quadraturefields_tpu_torch.utils import png
from test_torch_quadrature import hits_inputs, sphere_mesh

torch.set_num_threads(1)

LOBES = 2
TEX = 128


def _inputs(rng, n=4096):
    """Seeded inputs of every codec, with their edge values."""
    sigma = np.concatenate([[0.0, 1e-3, 1e4], rng.uniform(0, 2000, n)])
    colors = np.concatenate([[-30.0, 0.0, 30.0], rng.normal(0, 4, n)])
    vec = rng.normal(size=(n, 3))
    vec[:3] = [[1, 0, 0], [0, 0, 1], [0, 0, -1]]
    lam = np.concatenate([[0.0, 1e-6, 1e4], np.exp(rng.uniform(-6, 6, n))])
    axis = np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1, 1, n)])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(sigma=f32(sigma), colors=f32(colors).reshape(-1, 1),
                vec=f32(vec), lam=f32(lam), axis=f32(axis))


CODECS = {
    "sigma": (lambda m, x: m.compress_sigma(x["sigma"]),
              lambda m, u: m.inverse_of_compressed_sigma(u)),
    "colors_sigmoid": (lambda m, x: m.compress_colors(x["colors"]),
                       lambda m, u: m.inverse_of_compressed_colors(u)),
    "colors_linear": (
        lambda m, x: m.compress_colors(x["colors"], 12.0, "linear"),
        lambda m, u: m.inverse_of_compressed_colors(u, 12.0, "linear")),
    "lambda": (lambda m, x: m.compress_lambda(x["lam"], 7.5),
               lambda m, u: m.inverse_of_compressed_lambda(u, 7.5)),
    "axis": (lambda m, x: m.discretize_axis(x["axis"]),
             lambda m, u: m.continuous_axis(u)),
}


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("name", sorted(CODECS) + ["polar"])
def test_quantize_codecs_match_jax(name):
    """Each codec's numpy half and torch half against JAX's numpy and
    jnp halves on the same 4,099 seeded inputs (edge values included):
    the uint8 codes equal; each decode of all 256 codes within 1e-6
    (relative, and absolute near 0) of JAX's jnp decode, and the numpy
    decode equal to JAX's numpy decode."""
    x = _inputs(np.random.default_rng(0))
    codes = np.arange(256, dtype=np.uint8)
    if name == "polar":
        want = [np.asarray(a) for a in jqz.compress_polar_coordinates(
            jnp.asarray(x["vec"]))]
        for half in (x["vec"], torch.as_tensor(x["vec"])):
            got = tqz.compress_polar_coordinates(half)
            for g, w in zip(got, want):
                assert g.dtype == (torch.uint8 if torch.is_tensor(half)
                                   else np.uint8)
                np.testing.assert_array_equal(_np(g), w)
        az, el = np.meshgrid(codes, codes, indexing="ij")
        az, el = az.reshape(-1), el.reshape(-1)
        want = np.asarray(jqz.inverse_of_azimuth_and_elevation(
            jnp.asarray(az), jnp.asarray(el)))
        got_t = tqz.inverse_of_azimuth_and_elevation(torch.as_tensor(az),
                                                     torch.as_tensor(el))
        np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            tqz.inverse_of_azimuth_and_elevation(az, el),
            jqz.inverse_of_azimuth_and_elevation(az, el))
        return
    enc, dec = CODECS[name]
    want_np = enc(jqz, x)
    want_j = np.asarray(enc(jqz, {k: jnp.asarray(v) for k, v in x.items()}))
    np.testing.assert_array_equal(want_np, want_j)
    got_np = enc(tqz, x)
    got_t = enc(tqz, {k: torch.as_tensor(v) for k, v in x.items()})
    assert got_np.dtype == np.uint8 and got_t.dtype == torch.uint8
    np.testing.assert_array_equal(got_np, want_np)
    np.testing.assert_array_equal(got_t.numpy(), want_j)
    want = np.asarray(dec(jqz, jnp.asarray(codes)))
    np.testing.assert_allclose(dec(tqz, torch.as_tensor(codes)).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dec(tqz, codes), dec(jqz, codes))


def random_features(rng, n, num_lobes=LOBES):
    """Feature vectors [diffuse(3), lobes (axis, lambda, color) x L,
    sigma] spread over every codec's range."""
    f = rng.normal(0, 2, (n, 3 + 7 * num_lobes + 1)).astype(np.float32)
    for i in range(num_lobes):
        f[:, 3 + 7 * i + 3] = np.exp(rng.uniform(-2.5, 4.5, n))
    f[:, -1] = rng.uniform(0, 800, n)
    return f


def test_feature_compression_round_trip_matches_jax(tmp_path):
    """The same features loaded into JAX's and the port's maps give the
    same uint8 maps; the port's maps saved as PNGs (utils/png.py) and
    read back by a new FeatureCompression are the same maps, and imageio
    reads the same pixels from each file."""
    rng = np.random.default_rng(1)
    n = 2000
    feats = random_features(rng, n)
    idx = np.stack(np.unravel_index(rng.permutation(TEX * TEX)[:n],
                                    (TEX, TEX)), 1)
    maps = []
    for mod in (jcomp, tcomp):
        c = mod.FeatureCompression(num_lobes=LOBES, initialize=True,
                                   texture_size=TEX, lambda_thres=7.5)
        c.load_features_into_maps(feats, idx)
        maps.append(c)
    j, t = maps
    for name in ("alpha", "diffuse"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for a, b in zip(t.lambdas + t.sg_colors, j.lambdas + j.sg_colors):
        np.testing.assert_array_equal(a, b)
    prefix = str(tmp_path / "texture/")
    t.save_to_file(prefix + "/")
    back = tcomp.FeatureCompression(num_lobes=LOBES, path=prefix + "/")
    assert back.texture_size == TEX
    np.testing.assert_array_equal(back.alpha, t.alpha)
    np.testing.assert_array_equal(back.diffuse, t.diffuse)
    for a, b in zip(back.lambdas + back.sg_colors, t.lambdas + t.sg_colors):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        imageio.imread(prefix + "/lambda_axis_1.png"), t.lambdas[1])
    np.testing.assert_array_equal(imageio.imread(prefix + "/alpha.png"),
                                  t.alpha)


def _filtered_png(image, filters):
    """A PNG of image whose row y uses filter filters[y % len(filters)],
    filtered by a plain per-byte loop (the PNG specification's
    formulas)."""
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    rows = image.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        prior = rows[y - 1] if y else np.zeros(w * c, np.int64)
        line = [f]
        for i in range(w * c):
            a = rows[y, i - c] if i >= c else 0
            b = prior[i]
            cc = prior[i - c] if i >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                pred = png._paeth(int(a), int(b), int(cc))
            line.append((rows[y, i] - pred) % 256)
        out.append(bytes(line))
    color = 0 if c == 1 else 2
    import struct
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3), (1, 1), (7, 1, 3)])
def test_png_codec_against_imageio(tmp_path, shape):
    """Gray and RGB uint8 images: a file the port writes reads back the
    same through imageio and through the port; a file imageio writes
    (Pillow filters its rows) reads the same through the port; files
    whose rows use each of the five filters (a per-byte encoder of the
    specification) read the same through imageio and the port."""
    rng = np.random.default_rng(sum(shape))
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    ramp = (np.indices(shape).sum(0) * 7 % 256).astype(np.uint8)
    for image in (noise, ramp):
        path = str(tmp_path / "a.png")
        png.write_png(path, image)
        np.testing.assert_array_equal(imageio.imread(path), image)
        np.testing.assert_array_equal(png.read_png(path), image)
        imageio.imwrite(path, image)
        np.testing.assert_array_equal(png.read_png(path), image)
        for filters in ([1], [2], [3], [4], [0, 1, 2, 3, 4]):
            blob = _filtered_png(image, filters)
            with open(path, "wb") as f:
                f.write(blob)
            np.testing.assert_array_equal(imageio.imread(path), image)
            np.testing.assert_array_equal(png.decode_png(blob), image)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "b.png"), noise.astype(np.float32))


def _maps(rng, tex=TEX, fill=0.6):
    """A JAX and a port FeatureCompression holding the same uint8 maps
    (random features at a `fill` share of the texels)."""
    n = int(tex * tex * fill)
    idx = np.stack(np.unravel_index(rng.permutation(tex * tex)[:n],
                                    (tex, tex)), 1)
    feats = random_features(rng, n)
    out = []
    for mod in (jcomp, tcomp):
        c = mod.FeatureCompression(num_lobes=LOBES, initialize=True,
                                   texture_size=tex)
        c.load_features_into_maps(feats, idx)
        out.append(c)
    return out


def test_texel_decodes_match_jax():
    """get_features_from_packed_texels on gathered texel rows and
    get_features_from_texture_map on texel indices: within 1e-6
    (relative, absolute near 0) of JAX's."""
    rng = np.random.default_rng(3)
    j, t = _maps(rng)
    idx = rng.integers(0, TEX, (3000, 2)).astype(np.int32)
    jp = np.asarray(j.as_device_array_packed())
    tp = t.as_device_array_packed()
    np.testing.assert_array_equal(tp.numpy(), jp)
    want = np.asarray(j.get_features_from_packed_texels(
        jnp.asarray(jp[idx[:, 0], idx[:, 1]])))
    got = t.get_features_from_packed_texels(tp[idx[:, 0], idx[:, 1]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(j.get_features_from_texture_map(jnp.asarray(idx)))
    got = t.get_features_from_texture_map(torch.as_tensor(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got.shape == (3000, 3 + 7 * LOBES + 1)


def _baked_inputs():
    """Sphere-mesh hits (8 a ray), each hit triangle's corners and
    seeded per-corner UVs in texel units, and a raw float texture."""
    h = hits_inputs(max_hits=8)
    rng = np.random.default_rng(4)
    uvc = rng.uniform(0, TEX, (h["faces"].shape[0], 3, 2)).astype(np.float32)
    h["fuv"] = uvc[np.maximum(h["tri"], 0)]
    h["raw"] = random_features(rng, TEX * TEX).reshape(TEX, TEX, -1)
    return h


def test_hit_uv_texels_equal_jax():
    h = _baked_inputs()
    x = h["o"][:, None] + h["d"][:, None] * h["ts"][..., None]
    want = np.asarray(jbaked.hit_uv_texels(jnp.asarray(x),
                                           jnp.asarray(h["fv"]),
                                           jnp.asarray(h["fuv"]), TEX))
    got = tbaked.hit_uv_texels(torch.as_tensor(x), torch.as_tensor(h["fv"]),
                               torch.as_tensor(h["fuv"]), TEX)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    b = np.asarray(jbaked.barycentric_coordinates(jnp.asarray(x),
                                                  jnp.asarray(h["fv"])))
    np.testing.assert_allclose(
        tbaked.barycentric_coordinates(torch.as_tensor(x),
                                       torch.as_tensor(h["fv"])).numpy(),
        b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["maps", "raw"])
def test_render_baked_rows_match_jax(kind):
    """render_baked_rows (uint8 maps through the texture-map decode) and
    render_baked_raw_rows (a float texture) on the same hits, corners,
    UVs and maps: rgb, alpha, depth and weights within 1e-5 of max."""
    h = _baked_inputs()
    j, t = _maps(np.random.default_rng(5))
    cfgs = (JNGPConfig(head="sg", num_g_lobes=LOBES),
            TNGPConfig(head="sg", num_g_lobes=LOBES))
    outs = []
    with jax.disable_jit():
        for mod, rq, pack, comp, cfg in ((jbaked, jq, jnp.asarray, j,
                                          cfgs[0]),
                                         (tbaked, tq, torch.as_tensor, t,
                                          cfgs[1])):
            hits = rq.HitRows(pack(h["tri"]), pack(h["ts"]),
                              pack(h["valid"]))
            args = (hits, pack(h["o"]), pack(h["d"]), pack(h["fv"]),
                    pack(h["fuv"]))
            kw = dict(render_step_size=5e-3, bg_color="white")
            if kind == "raw":
                out = mod.render_baked_raw_rows(*args, pack(h["raw"]), cfg,
                                                **kw)
            else:
                maps = (comp.as_device_arrays() if mod is jbaked
                        else comp.as_device_arrays("cpu"))
                out = mod.render_baked_rows(
                    *args, maps, comp.get_features_from_texture_map, cfg,
                    texture_size=TEX, **kw)
            outs.append([_np(o) for o in out])
    for name, got, want in zip(("rgb", "alpha", "depth", "weights"),
                               outs[1], outs[0]):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    assert outs[0][1].max() > 0.1


def renderers(rng, tex=TEX, device="cpu"):
    """A JAX and a port BakedRenderer on one sphere mesh's atlas (the
    port's segment_and_atlas; JAX's gives the same bit for bit, see
    test_torch_stage6.py) and the same uint8 maps (random features on
    the filled texels, sigma in [50, 400])."""
    verts, faces = sphere_mesh(30)
    am, uv, _, tri_img = tst6.segment_and_atlas(TMesh(verts, faces), tex)
    rows, cols = np.nonzero(tri_img >= 0)
    feats = random_features(rng, rows.shape[0])
    feats[:, -1] = rng.uniform(50, 400, rows.shape[0])
    out = []
    for comp, st6, mesh_cls, cfg, kw in (
            (jcomp, jst6, JMesh, JNGPConfig, {}),
            (tcomp, tst6, TMesh, TNGPConfig, dict(device=device))):
        c = comp.FeatureCompression(num_lobes=LOBES, initialize=True,
                                    texture_size=tex)
        c.load_features_into_maps(feats, np.stack([rows, cols], 1))
        out.append(st6.BakedRenderer(
            mesh_cls(am.vertices, am.faces), uv, c,
            cfg(head="sg", num_g_lobes=LOBES), max_hits=8,
            render_step_size=5e-3, **kw))
    return out


def _camera_rays(rng, n=384):
    eye = np.asarray([2.0, 0.3, 0.5], np.float32)
    d = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) - eye
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


@pytest.mark.parametrize("variant", ["packed_uv", "packed_tri", "dense",
                                     "packed_uv_cam"])
def test_baked_renderer_variants_match_jax(variant):
    """Each BakedRenderer variant of both packages on the same atlas,
    maps and rays: rgb, alpha and depth within 1e-5 of JAX's; the
    packed variants composite with one segment sum and equal the dense
    rows within 2e-5 (JAX's own parity, tests/test_baked_packed.py).
    The pinhole variant renders a 24 x 24 image from its camera matrix
    in two chunks."""
    rng = np.random.default_rng(6)
    jr, tr = renderers(rng)
    if variant == "packed_uv_cam":
        w, focal = 24, 30.0
        eye = np.asarray([0.4, -2.2, 0.6])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        cam = np.stack([eye, right, up, fwd]).astype(np.float32)
        j, i = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
        d = ((i.reshape(-1, 1) - w / 2) / focal * cam[1]
             + (j.reshape(-1, 1) - w / 2) / focal * -cam[2] + cam[3])
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o = np.broadcast_to(cam[0], d.shape).astype(np.float32).copy()
        outs = []
        for r, pack, args in ((jr, jnp.asarray, ()), (tr, torch.as_tensor,
                                                       ())):
            parts = []
            for start in (0, w * w // 2):
                sl = slice(start, start + w * w // 2)
                tri, ts, _, uvs = r.mesh_intersect.intersect_rows_uv(o[sl],
                                                                     d[sl])
                cap = r._pack_cap(w * w // 2, int((tri >= 0).sum()), None)
                slots, ts_p, uv_p = r.pack_hits_uv(tri, ts, uvs, cap)
                with jax.disable_jit():
                    rgb, alpha, depth = r._render_packed_uv_cam_impl(
                        r.maps_packed, pack(cam), float(start), pack(slots),
                        pack(uv_p), pack(ts_p), w * w // 2, 8, w, focal)
                parts.append([_np(a) for a in (rgb, alpha, depth)])
            outs.append([np.concatenate(p) for p in zip(*parts)])
        dense = _np(tr.render_rays(o, d, packed=False)[0])
    else:
        o, d = _camera_rays(rng)
        kw = dict(packed=variant != "dense",
                  uv_transport=variant == "packed_uv")
        with jax.disable_jit():
            outs = [[_np(a) for a in r.render_rays(o, d, **kw)]
                    for r in (jr, tr)]
        dense = _np(tr.render_rays(o, d, packed=False)[0])
    for name, got, want in zip(("rgb", "alpha", "depth"), outs[1], outs[0]):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    assert outs[1][1].max() > 0.5 and outs[1][1].min() == 0.0
    np.testing.assert_allclose(outs[1][0], dense, atol=2e-5)


def test_pack_hits_match_jax():
    """pack_hits and pack_hits_uv equal JAX's on the sphere's hit rows,
    with room to spare and overflowing, and on the overflow case of
    tests/test_baked_packed.py (64 rays of 4 hits at cap 138: whole
    depth levels 2+ drop, every ray keeps its nearest hit); the
    adaptive cap equals JAX's."""
    rng = np.random.default_rng(7)
    jr, tr = renderers(rng)
    o, d = _camera_rays(rng)
    tri, ts, _, uvs = tr.mesh_intersect.intersect_rows_uv(o, d)
    n_valid = int((tri >= 0).sum())
    adaptive = tr._pack_cap(o.shape[0], n_valid, None)
    assert adaptive == jr._pack_cap(o.shape[0], n_valid, None) >= n_valid
    for cap in (adaptive, n_valid // 2, int(o.shape[0] * 2.0)):
        for a, b in zip(tst6.BakedRenderer.pack_hits(tri, ts, cap),
                        jst6.BakedRenderer.pack_hits(tri, ts, cap)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tst6.BakedRenderer.pack_hits_uv(tri, ts, uvs, cap),
                        jst6.BakedRenderer.pack_hits_uv(tri, ts, uvs, cap)):
            np.testing.assert_array_equal(a, b)
    for n, nv, hits in ((8192, 46_300, None), (640_000, 708_000, None),
                        (100, 5, None), (100, 50, 2.0)):
        assert tst6.BakedRenderer._pack_cap(n, nv, hits) == \
            jst6.BakedRenderer._pack_cap(n, nv, hits)
    tri_ids = np.full((64, 8), -1, np.int32)
    ts = np.zeros((64, 8), np.float32)
    tri_ids[:, :4] = 7
    ts[:, :4] = np.asarray([1.0, 1.5, 2.0, 2.5])
    cap = 64 * 2 + 10
    got = tst6.BakedRenderer.pack_hits(tri_ids, ts, cap)
    for a, b in zip(got, jst6.BakedRenderer.pack_hits(tri_ids, ts, cap)):
        np.testing.assert_array_equal(a, b)
    slots = got[0]
    valid = slots >= 0
    assert valid.sum() == 128 and (slots[valid] % 8).max() == 1
    assert np.unique(slots[valid] // 8).shape[0] == 64
