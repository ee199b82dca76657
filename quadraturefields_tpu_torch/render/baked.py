"""Baked-texture rendering on dense hit rows (stage 6).

Port of quadraturefields_tpu/render/baked.py (reference
render_image_bake_texture_images_with_occgrid, utils.py:999-1095). Per
hit: barycentric coordinates in the atlas mesh -> UV texel -> uint8
texture fetch -> feature decode -> SG colour (no MLP) -> quadrature
composite, all on the device. The packed-stream variants, whose
composite is one K3 segment sum, are BakedRenderer's
(baking/stage6.py).
"""
from __future__ import annotations

import torch

from ..models.ngp import NGPConfig, ngp_features_to_rgb
from .quadrature import HitRows, row_composite


def barycentric_coordinates(points, tri_verts):
    """points [..., 3], tri_verts [..., 3, 3] -> [..., 3] barycentric
    (the closed-form 2x2 normal-equation solve; replaces trimesh's
    points_to_barycentric at utils.py:1057)."""
    a = tri_verts[..., 0, :]
    e1 = tri_verts[..., 1, :] - a
    e2 = tri_verts[..., 2, :] - a
    p = points - a
    d11 = (e1 * e1).sum(-1)
    d12 = (e1 * e2).sum(-1)
    d22 = (e2 * e2).sum(-1)
    p1 = (p * e1).sum(-1)
    p2 = (p * e2).sum(-1)
    det = d11 * d22 - d12 * d12
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    v = (d22 * p1 - d12 * p2) / det
    w = (d11 * p2 - d12 * p1) / det
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def hit_uv_texels(points, tri_verts, tri_uv, texture_size: int):
    """Barycentric-interpolated UV -> integer texel (row, col), with the
    reference's clamp, renormalisation and floor (utils.py:1057-1063)."""
    b = barycentric_coordinates(points, tri_verts).clamp(0.0, 1.0)
    b = b / b.sum(dim=-1, keepdim=True)
    uv = (tri_uv * b[..., None]).sum(dim=-2)
    return torch.floor(uv).to(torch.int32).clamp(0, texture_size - 1)


def render_baked_raw_rows(
    hits: HitRows,
    origins,
    viewdirs,
    face_vertices,
    face_uv,
    texture,        # [T, T, D+1] raw float features (last = sigma)
    sg_cfg: NGPConfig,
    *,
    render_step_size: float,
    bg_color: str = "white",
    render_bkgd=None,
):
    """The raw (uncompressed) float-texture variant, the reference's
    render_image_bake_with_occgrid (utils.py:900-996)."""
    R, H = hits.ts.shape
    xyzs = origins[:, None, :] + viewdirs[:, None, :] * hits.ts[..., None]
    dirs = viewdirs[:, None, :].expand(R, H, 3)
    texels = hit_uv_texels(xyzs, face_vertices, face_uv,
                           texture.shape[0]).long()
    tex = texture[texels[..., 0].reshape(-1), texels[..., 1].reshape(-1)]
    sigmas = tex[:, -1].reshape(R, H)
    rgbs = ngp_features_to_rgb(tex[:, :-1], dirs.reshape(-1, 3),
                               sg_cfg).reshape(R, H, 3)
    deltas = torch.full_like(sigmas, render_step_size)
    return row_composite(rgbs, sigmas, hits.ts, deltas, hits.valid,
                         bg_color, render_bkgd)


def render_baked_rows(
    hits: HitRows,
    origins,
    viewdirs,
    face_vertices,  # [R, H, 3, 3] atlas-mesh triangle verts
    face_uv,        # [R, H, 3, 2] per-corner UV texel coords
    maps,           # FeatureCompression.as_device_arrays()
    decode_fn,      # compressor.get_features_from_texture_map
    sg_cfg: NGPConfig,
    *,
    texture_size: int,
    render_step_size: float,
    bg_color: str = "white",
    render_bkgd=None,
):
    R, H = hits.ts.shape
    xyzs = origins[:, None, :] + viewdirs[:, None, :] * hits.ts[..., None]
    dirs = viewdirs[:, None, :].expand(R, H, 3)
    texels = hit_uv_texels(xyzs, face_vertices, face_uv, texture_size)
    feats = decode_fn(texels.reshape(-1, 2), maps)
    sigmas = feats[:, -1].reshape(R, H)
    rgbs = ngp_features_to_rgb(feats[:, :-1], dirs.reshape(-1, 3),
                               sg_cfg).reshape(R, H, 3)
    deltas = torch.full_like(sigmas, render_step_size)
    return row_composite(rgbs, sigmas, hits.ts, deltas, hits.valid,
                         bg_color, render_bkgd)
