"""Stage 6: prune -> segment -> UV atlas -> bake textures -> baked eval.

Port of quadraturefields_tpu/baking/stage6.py (reference
script/run_nerfsynthetic_baking.sh:32-38):
  prune_mesh            examples/prune_mesh_after_finetuning.py:324-373
  segmentation          ScanNet segmentator binary -> *.segs.json
  UV atlas + V image    examples/generate_uv_xatlas_old.py
  texture bake          examples/bake_texture_images_shelly.py:284-294
  baked evaluation      examples/test_baking_texture_images.py:341-429
The teacher's and the SG model's queries run on the device their
parameters lie on (K2 on the card); the segmentation, the atlas, the
V-image raster and the uint8 quantisation run on the host, as in JAX.
BakedRenderer composites each packed chunk with one K3 segment sum.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..geometry.intersect import MeshIntersection
from ..geometry.meshio import Mesh, save_obj_with_uv, save_ply
from ..geometry.native import segment_mesh
from ..models.ngp import (
    NGPConfig,
    ngp_features,
    ngp_features_to_rgb,
    ngp_forward,
    ngp_query_density,
)
from ..ops import scan
from ..ops.hashgrid_sorted import presorted_row_segment_sum
from ..render.baked import hit_uv_texels, render_baked_rows
from ..render.quadrature import HitRows, row_composite
from ..utils.batching import snap_pack_cap
from ..utils.metrics import lpips_metric, psnr, ssim
from .compression import FeatureCompression
from .uvatlas import build_uv_atlas, rasterize_v_image


def _device_of(params) -> torch.device:
    return params["table"].device


@torch.no_grad()
def prune_mesh(
    teacher_params,
    teacher_cfg: NGPConfig,
    mesh_intersect: MeshIntersection,
    dataset,
    aabb,
    *,
    render_step_size: float = 5e-3,
    weight_thres: float = 1e-3,
    n_batches: int | None = None,
    rays_per_batch: int = 8192,
    extra_views=None,
    out_dir: str | None = None,
):
    """Keep the faces whose largest rendering weight over the train
    views exceeds weight_thres (prune_mesh_after_finetuning.py:324-369).
    Returns (pruned Mesh, triangle_weights).

    As the reference, the default (n_batches=None) renders EVERY pixel
    of EVERY train view in rays_per_batch chunks (a random sample of
    rays prunes every face it never hit); n_batches takes that many
    random batches instead. extra_views: loaders with __len__ and
    rays_for_view(i) (data.own_views.spiral_prune_rings) swept in full
    as well, the split-independent analog of the reference's
    `--train_split trainval` (prune_mesh_after_finetuning.py:62-66).
    The teacher runs on its parameters' device; the per-face maximum is
    taken on the host."""
    n_faces = mesh_intersect.n_faces
    tri_weights = np.zeros((n_faces,), np.float32)
    dev = _device_of(teacher_params)
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=dev)

    def to_dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    def weights_fn(origins, viewdirs, tri_ids, ts, valid):
        R, H = ts.shape
        xyzs = origins[:, None, :] + viewdirs[:, None, :] * ts[..., None]
        dirs = viewdirs[:, None, :].expand(R, H, 3)
        _, sigmas = ngp_forward(teacher_params, xyzs.reshape(-1, 3),
                                dirs.reshape(-1, 3), aabb, teacher_cfg)
        sigmas = sigmas[..., 0].reshape(R, H)
        deltas = torch.full_like(sigmas, render_step_size)
        _, _, _, w = row_composite(torch.zeros((R, H, 3), device=dev),
                                   sigmas, ts, deltas, valid, "white")
        return w

    def accumulate(origins, viewdirs):
        tri_ids, ts, valid = mesh_intersect.intersect_rows(origins,
                                                           viewdirs)
        w = weights_fn(to_dev(origins), to_dev(viewdirs),
                       to_dev(tri_ids, np.int32), to_dev(ts),
                       to_dev(valid, bool)).cpu().numpy()
        sel = valid.reshape(-1)
        np.maximum.at(tri_weights, tri_ids.reshape(-1)[sel],
                      w.reshape(-1)[sel])

    def sweep_view(origins, viewdirs):
        # every pixel, in fixed-size chunks; the tail repeats the last
        # ray, which can only raise a face's weight with a ray that sees
        # it
        c = rays_per_batch
        origins = np.asarray(origins, np.float32)
        viewdirs = np.asarray(viewdirs, np.float32)
        n = origins.shape[0]
        n_pad = (n + c - 1) // c * c
        if n_pad != n:
            origins = np.concatenate(
                [origins, np.repeat(origins[-1:], n_pad - n, 0)])
            viewdirs = np.concatenate(
                [viewdirs, np.repeat(viewdirs[-1:], n_pad - n, 0)])
        for j in range(0, n_pad, c):
            accumulate(origins[j:j + c], viewdirs[j:j + c])

    if n_batches is None:
        for i in range(len(dataset)):
            view = dataset.fetch_eval_view(i)
            sweep_view(view["rays"].origins, view["rays"].viewdirs)
    else:
        prev_num_rays = dataset.num_rays
        dataset.update_num_rays(rays_per_batch)
        for _ in range(n_batches):
            batch = dataset.fetch_train_batch()
            accumulate(np.asarray(batch["rays"].origins),
                       np.asarray(batch["rays"].viewdirs))
        dataset.update_num_rays(prev_num_rays)

    if extra_views is not None:
        for loader in extra_views:
            for i in range(len(loader)):
                rays = loader.rays_for_view(i)
                sweep_view(rays.origins, rays.viewdirs)

    mask = tri_weights > weight_thres
    pruned = Mesh(mesh_intersect.mesh.vertices,
                  mesh_intersect.mesh.faces[mask]) \
        .remove_unreferenced_vertices()
    if out_dir:
        np.save(os.path.join(out_dir, "triangle_weights.npy"), tri_weights)
        save_ply(os.path.join(out_dir, "mesh_updated.ply"), pruned)
    return pruned, tri_weights


def segment_and_atlas(
    mesh: Mesh,
    texture_size: int,
    *,
    kthr: float = 0.01,
    min_size: int | None = None,
    padding: float = 2.0,
    out_dir: str | None = None,
):
    """Segmentation + UV atlas + V image, on the host. Writes the
    reference's artifact set (segs.json, mesh_segmentation_<N>.obj,
    V_<N>.npy). min_size=None takes the merge floor at ~1% of the face
    count (at least 20), as JAX does: on decimated meshes the
    Felzenszwalb step alone splinters into ~17-face segments, whose
    per-chart padding collapses the texel utilisation."""
    if min_size is None:
        min_size = max(20, mesh.faces.shape[0] // 100)
    face_seg = segment_mesh(mesh.vertices, mesh.faces, kthr=kthr,
                            min_size=min_size)
    atlas_mesh, uv, atlas_stats = build_uv_atlas(
        mesh, face_seg, texture_size, padding=padding)
    v_image, tri_image = rasterize_v_image(atlas_mesh, uv, texture_size)
    # the share of the atlas that carries signal, dilation included
    atlas_stats["raster_utilization"] = float((tri_image >= 0).mean())
    if out_dir:
        with open(os.path.join(out_dir, "atlas_stats.json"), "w") as f:
            json.dump(atlas_stats, f, indent=1)
        # per-vertex segIndices like the ScanNet segmentator's output
        vert_seg = np.zeros((mesh.vertices.shape[0],), np.int64)
        vert_seg[mesh.faces.reshape(-1)] = np.repeat(face_seg, 3)
        # <mesh>.<kThresh>.segs.json, the segmentator's naming
        # (run_*_baking.sh:33)
        with open(os.path.join(out_dir,
                               f"mesh_updated.{kthr:.6f}.segs.json"),
                  "w") as f:
            json.dump({"segIndices": vert_seg.tolist()}, f)
        save_obj_with_uv(
            os.path.join(out_dir, f"mesh_segmentation_{texture_size}.obj"),
            atlas_mesh, uv)
        dtype = np.float16 if texture_size > 8192 else np.float32
        np.save(os.path.join(out_dir, f"V_{texture_size}.npy"),
                v_image.astype(dtype))
    return atlas_mesh, uv, v_image, tri_image


@torch.no_grad()
def bake_textures(
    sg_params,
    sg_cfg: NGPConfig,
    v_image: np.ndarray,
    tri_image: np.ndarray,
    aabb,
    *,
    teacher_params=None,
    teacher_cfg: NGPConfig | None = None,
    texture_size: int,
    compression_type: str = "sigmoid",
    lambda_thres: float = 7.5,
    chunk: int = 1 << 18,
    out_dir: str | None = None,
):
    """Query the SG features at the V image's texels in chunks on the
    SG model's device and quantize them into the texture maps on the
    host (bake_texture_images_shelly.py:284-294). With the teacher, the
    baked sigma channel is the finetuned radiance field's density
    instead of the SG model's (bake_texture_images_shelly.py:288-290)."""
    comp = FeatureCompression(
        num_lobes=sg_cfg.num_g_lobes, initialize=True,
        texture_size=texture_size, compression_type=compression_type,
        lambda_thres=lambda_thres)
    rows, cols = np.nonzero(tri_image >= 0)
    pts = v_image[rows, cols]
    dev = _device_of(sg_params)
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=dev)

    def feats_fn(x):
        feats = ngp_features(sg_params, x, aabb, sg_cfg)
        if teacher_params is not None:
            sigma = ngp_query_density(teacher_params, x, aabb, teacher_cfg)
            feats[:, -1] = sigma[:, 0]
        return feats

    for i in range(0, pts.shape[0], chunk):
        x = torch.as_tensor(np.asarray(pts[i:i + chunk], np.float32),
                            device=dev)
        feats = feats_fn(x).cpu().numpy()
        idx = np.stack([rows[i:i + chunk], cols[i:i + chunk]], axis=1)
        comp.load_features_into_maps(feats, idx)
    if out_dir:
        prefix = os.path.join(out_dir, f"texture_{texture_size}/")
        os.makedirs(prefix, exist_ok=True)
        comp.save_to_file(prefix)
    return comp


class BakedRenderer:
    """The texture-only renderer over the atlas mesh, the real-time path
    (test_baking_texture_images.py:341-429). The maps and the atlas
    geometry live on `device`; the host BVH casts each chunk's rays and
    packs its hits. Four variants of one render: the packed stream with
    each hit's UV from the cast (the default), the packed stream with
    the hit's triangle (the UV solved on the device), the pinhole form
    of the UV stream (directions from camera math) and dense rows."""

    def __init__(self, atlas_mesh: Mesh, uv, compressor, sg_cfg: NGPConfig,
                 max_hits: int = 25, render_step_size: float = 5e-3,
                 device="cuda"):
        self.device = torch.device(device)
        self.mesh_intersect = MeshIntersection(
            mesh=atlas_mesh, simplify_mesh=False, scale=1.0,
            num_intersections=max_hits,
        )
        self.uv = np.asarray(uv, np.float32)
        self.compressor = compressor
        self.maps = compressor.as_device_arrays(self.device)
        self.maps_packed = compressor.as_device_array_packed(self.device)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=self.device)

        self.geom = {
            "verts": dev(atlas_mesh.vertices, np.float32),
            "faces": dev(atlas_mesh.faces, np.int64),
            "uv": dev(self.uv, np.float32),
            # per-face corners [F, 3, 5] = (xyz, uv): one row gather a
            # hit in the packed-triangle variant
            "face_data": dev(np.concatenate(
                [atlas_mesh.vertices[atlas_mesh.faces],
                 self.uv[atlas_mesh.faces]], axis=-1), np.float32),
        }
        self.sg_cfg = sg_cfg
        self.render_step_size = render_step_size
        self.mesh_intersect.set_atlas_uv(self.uv)

    def _render_impl(self, maps, geom, origins, viewdirs, tri_ids, ts):
        """Dense rows [R, H]: face corners gathered on the device, the
        composite along the rows (no segment sum)."""
        valid = tri_ids >= 0
        corner_ids = geom["faces"][tri_ids.clamp_min(0).long()]
        face_vertices = geom["verts"][corner_ids]     # [R, H, 3, 3]
        face_uv = geom["uv"][corner_ids]              # [R, H, 3, 2]
        rgb, alpha, depth, _ = render_baked_rows(
            HitRows(tri_ids=tri_ids, ts=ts, valid=valid), origins, viewdirs,
            face_vertices, face_uv, maps,
            self.compressor.get_features_from_texture_map, self.sg_cfg,
            texture_size=self.compressor.texture_size,
            render_step_size=self.render_step_size)
        return rgb, alpha, depth

    @staticmethod
    def _ray_indices(slots, n_rays: int, max_hits: int):
        """The ray of each packed hit (slot = ray * max_hits + h); pads
        (slot -1) get n_rays, K3's dropped key."""
        valid = slots >= 0
        ray_idx = torch.where(valid, torch.div(slots, max_hits,
                                               rounding_mode="floor"),
                              n_rays).to(torch.int32)
        return valid, ray_idx

    def _shade_composite(self, maps, texels, d, ts_p, valid, ray_idx,
                         n_rays: int):
        """The packed stream's texel fetch (one [C]-byte row a hit from
        the channel-packed maps), feature decode, SG colour, segmented
        transmittance, and rgb, alpha and depth in ONE K3 segment sum of
        8-wide rows; white background."""
        texels = texels.long()
        tex = maps[texels[:, 0], texels[:, 1]]
        feats = self.compressor.get_features_from_packed_texels(tex)
        sigmas = torch.where(valid, feats[:, -1], 0.0)
        rgbs = ngp_features_to_rgb(feats[:, :-1], d, self.sg_cfg)
        boundaries = scan.mark_pack_boundaries(ray_idx)
        weights, _, _ = scan.render_weight_from_density(
            ts_p, ts_p + self.render_step_size, sigmas, boundaries)
        w = torch.where(valid, weights, 0.0)[:, None]
        vals8 = torch.cat([w * rgbs, w, w * ts_p[:, None],
                           torch.zeros((w.shape[0], 3), device=w.device)],
                          dim=1)
        acc = presorted_row_segment_sum(ray_idx, vals8, n_rays)
        alpha = acc[:, 3:4]
        depth = acc[:, 4:5] / alpha.clamp_min(1e-10)
        return (1.0 - alpha) + acc[:, 0:3], alpha, depth

    def _render_packed_impl(self, maps, geom, origin_rows, viewdirs, slots,
                            tri, ts_p, n_rays: int, max_hits: int):
        """The packed stream of (slot, triangle, t): only the valid hits
        (slot = ray * H + h, -1 pads at the tail, ray-sorted and in depth
        order); each hit's UV is solved on the device from its face's
        corners."""
        valid, ray_idx = self._ray_indices(slots, n_rays, max_hits)
        ray = ray_idx.clamp(0, n_rays - 1).long()
        d = viewdirs[ray]
        xyz = origin_rows.expand(n_rays, 3)[ray] + d * ts_p[:, None]
        fd = geom["face_data"][tri.clamp_min(0).long()]   # [M, 3, 5]
        texels = hit_uv_texels(xyz, fd[..., :3], fd[..., 3:],
                               self.compressor.texture_size)
        return self._shade_composite(maps, texels, d, ts_p, valid, ray_idx,
                                     n_rays)

    def _render_packed_uv_impl(self, maps, viewdirs, slots, uv_p, ts_p,
                               n_rays: int, max_hits: int):
        """The UV transport: the host cast emits each hit's
        barycentric-interpolated atlas UV (qf_bvh_intersect_uv), so the
        device skips the face gather and the barycentric solve; 16 B a
        hit (slot, uv, t)."""
        valid, ray_idx = self._ray_indices(slots, n_rays, max_hits)
        d = viewdirs[ray_idx.clamp(0, n_rays - 1).long()]
        T = self.compressor.texture_size
        texels = torch.floor(uv_p).to(torch.int32).clamp(0, T - 1)
        return self._shade_composite(maps, texels, d, ts_p, valid, ray_idx,
                                     n_rays)

    def _render_packed_uv_cam_impl(self, maps, cam, start, slots, uv_p,
                                   ts_p, n_rays: int, max_hits: int,
                                   img_w: int, focal: float):
        """The pinhole form of the UV transport: each hit's direction
        from camera math (global ray index -> pixel (i, j)) instead of a
        gather from uploaded directions. cam [4, 3] = (eye, right, up,
        fwd); start = the chunk's first global ray index; a square image
        of width img_w."""
        valid, ray_idx = self._ray_indices(slots, n_rays, max_hits)
        g = ray_idx.clamp(0, n_rays - 1).to(torch.float32) + start
        i = torch.remainder(g, img_w)
        j = torch.floor(g / img_w)
        d = ((i[:, None] - img_w / 2) / focal * cam[1]
             + (j[:, None] - img_w / 2) / focal * -cam[2] + cam[3])
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        T = self.compressor.texture_size
        texels = torch.floor(uv_p).to(torch.int32).clamp(0, T - 1)
        return self._shade_composite(maps, texels, d, ts_p, valid, ray_idx,
                                     n_rays)

    @staticmethod
    def _pack_cap(n_rays: int, n_valid: int, pack_cap_hits) -> int:
        """The packed stream's length. None (the default): the √2-grid
        bucket at or above the chunk's TRUE hit count, at least n_rays
        (snap_pack_cap: at most 41% slack, and no hit dropped). A float
        fixes it at n_rays * pack_cap_hits (JAX measured a fixed 2.0
        dropping 70% of the hits of a busy chunk, 10 dB of PSNR)."""
        if pack_cap_hits is not None:
            return int(n_rays * pack_cap_hits)
        return snap_pack_cap(n_valid, 1 << 31, min_cap=max(int(n_rays), 128))

    @staticmethod
    def pack_hits_uv(tri_ids, ts, uvs, cap: int):
        """pack_hits for the UV transport: -> (slots, ts, uv) packed."""
        valid = tri_ids >= 0
        if int(valid.sum()) > cap:
            per_h = valid.sum(axis=0)
            cum = np.cumsum(per_h)
            h_keep = int(np.searchsorted(cum, cap, side="right"))
            valid = valid.copy()
            valid[:, h_keep:] = False
        slots = np.nonzero(valid.reshape(-1))[0].astype(np.int32)
        m = slots.shape[0]
        ts_p = ts.reshape(-1)[slots]
        uv_p = uvs.reshape(-1, 2)[slots]
        pad = cap - m
        return (
            np.concatenate([slots, np.full(pad, -1, np.int32)]),
            np.concatenate([ts_p, np.zeros(pad, np.float32)]),
            np.concatenate([uv_p, np.zeros((pad, 2), np.float32)]),
        )

    @staticmethod
    def pack_hits(tri_ids, ts, cap: int):
        """Host-side: dense [R,H] hits -> (slots, tri, ts) packed arrays
        of static length `cap` (slot = -1 padding). On overflow, whole
        trailing hit-DEPTH levels are dropped (never whole rays): level
        h is kept only if every hit up to level h fits."""
        valid = tri_ids >= 0
        if int(valid.sum()) > cap:
            per_h = valid.sum(axis=0)
            cum = np.cumsum(per_h)
            h_keep = int(np.searchsorted(cum, cap, side="right"))
            valid = valid.copy()
            valid[:, h_keep:] = False
        slots = np.nonzero(valid.reshape(-1))[0].astype(np.int32)
        m = slots.shape[0]
        tri_p = tri_ids.reshape(-1)[slots]
        ts_p = ts.reshape(-1)[slots]
        pad = cap - m
        return (
            np.concatenate([slots, np.full(pad, -1, np.int32)]),
            np.concatenate([tri_p, np.zeros(pad, np.int32)]),
            np.concatenate([ts_p, np.zeros(pad, np.float32)]),
        )

    def _to_device(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    @torch.no_grad()
    def render_rays(self, origins, viewdirs, packed: bool = True,
                    pack_cap_hits: float | None = None,
                    uv_transport: bool = True):
        """(rgb [n, 3], alpha [n, 1], depth [n, 1]) of host rays, on the
        renderer's device."""
        n = origins.shape[0]
        H = self.mesh_intersect.max_hits
        if packed and uv_transport:
            tri_ids, ts, _, uvs = self.mesh_intersect.intersect_rows_uv(
                origins, viewdirs)
            cap = self._pack_cap(n, int((tri_ids >= 0).sum()),
                                 pack_cap_hits)
            slots, ts_p, uv_p = self.pack_hits_uv(tri_ids, ts, uvs, cap)
            return self._render_packed_uv_impl(
                self.maps_packed, self._to_device(viewdirs),
                self._to_device(slots, np.int32), self._to_device(uv_p),
                self._to_device(ts_p), n, H)
        tri_ids, ts, _ = self.mesh_intersect.intersect_rows(origins,
                                                            viewdirs)
        if packed:
            cap = self._pack_cap(n, int((tri_ids >= 0).sum()),
                                 pack_cap_hits)
            slots, tri_p, ts_p = self.pack_hits(tri_ids, ts, cap)
            # pinhole cameras share one origin: upload [1, 3], expand
            o_rows = (origins[:1] if np.allclose(origins, origins[0])
                      else origins)
            return self._render_packed_impl(
                self.maps_packed, self.geom, self._to_device(o_rows),
                self._to_device(viewdirs), self._to_device(slots, np.int32),
                self._to_device(tri_p, np.int32), self._to_device(ts_p),
                n, H)
        return self._render_impl(
            self.maps, self.geom, self._to_device(origins),
            self._to_device(viewdirs), self._to_device(tri_ids, np.int32),
            self._to_device(ts))

    def render_view(self, data, chunk: int = 8192) -> torch.Tensor:
        """rgb [n, 3] of a full view on white, in chunks of `chunk`
        rays, on the renderer's device."""
        origins = np.asarray(data["rays"].origins)
        viewdirs = np.asarray(data["rays"].viewdirs)
        n = origins.shape[0]
        n_pad = (n + chunk - 1) // chunk * chunk
        o = np.concatenate([origins, np.zeros((n_pad - n, 3), np.float32)])
        d = np.concatenate(
            [viewdirs, np.tile([[0, 0, 1.0]], (n_pad - n, 1))]
        ).astype(np.float32)
        outs = []
        for i in range(0, n_pad, chunk):
            rgb, _, _ = self.render_rays(o[i:i + chunk], d[i:i + chunk])
            outs.append(rgb)
        return torch.cat(outs)[:n]


def evaluate_baked(
    renderer: BakedRenderer,
    dataset,
    n_views: int | None = None,
    out_path: str | None = None,
):
    """PSNR and SSIM over the test views, and the baked path's FPS end to
    end (the results_baking_*.json contract,
    test_baking_texture_images.py:412-429)."""
    n = len(dataset)
    if n_views is not None:
        n = min(n, n_views)
    H, W = dataset.HEIGHT, dataset.WIDTH
    psnrs, ssims, lpipss = [], [], []
    pairs = []
    t0 = time.perf_counter()
    for i in range(n):
        data = dataset.fetch_eval_view(i)
        rgb = renderer.render_view(data).reshape(H, W, 3)
        pixels = torch.as_tensor(np.asarray(data["pixels"], np.float32),
                                 device=rgb.device).reshape(H, W, 3)
        psnrs.append(float(psnr(rgb, pixels)))
        ssims.append(float(ssim(rgb, pixels)))
        pairs.append((rgb, pixels))
    dt = time.perf_counter() - t0
    # lpips outside the timed window (the reference times only the
    # render path, test_baking_texture_images.py:341-415)
    for rgb, pixels in pairs:
        lpipss.append(lpips_metric(rgb, pixels))
    results = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": float(np.mean(lpipss)),
        "fps": n / dt,
        "n_views": n,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f)
    return results
