"""Quadrature rendering at ray-mesh hits (stages 4, 5, 6).

Port of quadraturefields_tpu/render/quadrature.py (reference
utils.py:465-607 render_image_finetune_with_occgrid, utils.py:610-730
the stage-5 SG distillation pass, utils.py:732-861 the vertex-feature
baking check, and derive_properties, utils.py:863-898). Two layouts of
the same hits:

  * dense rows [R, max_hits] padded with valid=False (the BVH's rows):
    compositing is an exclusive cumsum along the hit axis and the
    post-deformation re-sort a stable per-row argsort (eval and the
    dense transport);
  * the packed stream [M] of valid hits, ray-sorted (the training
    transport, 12 B a hit from the host): the per-ray composite is one
    presorted segment sum (K3 on the card) and the re-sort one stable
    (ray, deformed t) two-key sort of the stream, pads (ray == R,
    t = inf) at the tail.

Stage 5 renders the SG model's rgb at the hits with the frozen
teacher's density: the teacher runs without a graph (JAX's
stop_gradient), so its encode records no table gradient.

The random barycentric samples of the vertex regularizer take their
uniforms at the dense [R, H, 3] shape, gathered by slot in the packed
paths, so both layouts see the same jitter; callers pass them in (the
trainer draws them from its generator).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import scan
from ..ops.hashgrid_sorted import presorted_row_segment_sum_vjp


class HitRows(NamedTuple):
    """Per-ray mesh hits, depth-sorted, -1/False padded."""
    tri_ids: torch.Tensor  # [R, H] int32, -1 pad
    ts: torch.Tensor       # [R, H] f32
    valid: torch.Tensor    # [R, H] bool


def _background(color, alpha, bg_color: str, render_bkgd):
    if bg_color == "white":
        return (1.0 - alpha) + color
    if bg_color == "black":
        return color
    return color + (1.0 - alpha) * render_bkgd


def row_composite(rgbs, sigmas, depths, deltas, valid, bg_color="white",
                  render_bkgd=None):
    """derive_properties on dense rows [R, H]: per-ray color, alpha and
    normalized depth, and the per-hit weights."""
    tau = torch.where(valid, sigmas * deltas, 0.0)
    exc = torch.cumsum(tau, dim=1) - tau
    trans = torch.exp(-exc)
    alphas = 1.0 - torch.exp(-tau)
    weights = torch.where(valid, trans * alphas, 0.0)

    alpha = weights.sum(dim=1, keepdim=True)
    color = (weights[..., None] * rgbs).sum(dim=1)
    depth = (weights * depths).sum(dim=1, keepdim=True)
    depth = depth / alpha.clamp_min(1e-10)
    return (_background(color, alpha, bg_color, render_bkgd), alpha, depth,
            weights)


def resort_rows(ts, valid, key_pad=1e10):
    """The stable per-row permutation that sorts the deformed depths,
    invalid entries at the row tail (replaces the reference's host
    np.lexsort, mesh_utils.py:395)."""
    keys = torch.where(valid, ts, key_pad)
    return torch.argsort(keys.detach(), dim=1, stable=True)


def apply_row_permutation(order, *arrays):
    out = []
    for a in arrays:
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2))
        out.append(torch.take_along_dim(a, idx.expand(order.shape
                                                      + a.shape[2:]), 1))
    return tuple(out)


def random_barycentric_vertices(generator, tri_vertices, uniforms=None):
    """Random convex combination of each hit triangle's vertices
    (reference utils.py:543-546: weights ~ U[0,1]^3, normalized).
    tri_vertices [..., 3, 3]; `uniforms` [..., 3] override the draw
    from `generator`."""
    if uniforms is None:
        uniforms = torch.rand(tri_vertices.shape[:-1], generator=generator,
                              device=tri_vertices.device)
    w = uniforms[..., None]
    return (tri_vertices * w).sum(dim=-2) / (w.sum(dim=-2) + 1e-6)


def _rf_forward(ngp_forward_fn, ngp_params, x, d, aabb, ngp_cfg,
                stop_gradient_rf: bool):
    """(rgbs, sigmas) of the radiance field; with stop_gradient_rf
    without a graph (JAX's stop_gradient: no gradient reaches the rf
    or, through the positions, the deformation field)."""
    if stop_gradient_rf:
        with torch.no_grad():
            return ngp_forward_fn(ngp_params, x, d, aabb, ngp_cfg)
    return ngp_forward_fn(ngp_params, x, d, aabb, ngp_cfg)


def render_finetune_rows(
    ngp_params,
    field_params,
    hits: HitRows,
    origins,            # [R, 3]
    viewdirs,           # [R, 3]
    face_vertices,      # [R, H, 3, 3] world verts of hit triangles
    aabb,
    ngp_cfg,
    field_cfg,
    *,
    ngp_forward_fn,
    field_apply_fn,
    scaling: float,
    render_step_size: float,
    bg_color: str = "white",
    render_bkgd=None,
    generator=None,
    bary_uniforms=None,  # [R, H, 3] override the generator's draw
    stop_gradient_rf: bool = False,
):
    """Stage-4 forward on dense rows: deform the hits along their rays
    by the scalar field, re-sort, query the radiance field, composite;
    returns the render, the deformation regularizer and the per-face
    scatter inputs. As the reference (utils.py:465-607), the field has
    output_dim 1 broadcast over xyz: del_delta = sum(tanh(f) * scaling *
    dirs), the hit moves by del_delta * dirs and ts += del_delta."""
    R, H = hits.ts.shape
    valid = hits.valid
    xyzs = origins[:, None, :] + viewdirs[:, None, :] * hits.ts[..., None]
    dirs = viewdirs[:, None, :].expand(R, H, 3)

    del_scalar = field_apply_fn(
        field_params, xyzs.reshape(-1, 3), field_cfg).reshape(R, H)
    del_vector3 = (torch.tanh(del_scalar)[..., None] * scaling) \
        .expand(R, H, 3)
    del_delta = (del_vector3 * dirs).sum(dim=-1)           # [R, H]

    v_samples = random_barycentric_vertices(generator, face_vertices,
                                            uniforms=bary_uniforms)
    del_scalar_v = field_apply_fn(
        field_params, v_samples.reshape(-1, 3), field_cfg).reshape(R, H)
    del_vector_v3 = (torch.tanh(del_scalar_v)[..., None] * scaling) \
        .expand(R, H, 3)

    dh = del_delta[..., None] * dirs
    xyzs = xyzs + dh
    ts = hits.ts + del_delta

    order = resort_rows(ts, valid)
    ts, _ = apply_row_permutation(order, ts, del_delta)
    xyzs, dh_s, dirs = apply_row_permutation(order, xyzs, dh, dirs)
    valid_s = torch.take_along_dim(valid, order, 1)
    tri_ids_s = torch.take_along_dim(hits.tri_ids, order, 1)

    rgbs, sigmas = _rf_forward(ngp_forward_fn, ngp_params,
                               xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                               aabb, ngp_cfg, stop_gradient_rf)
    rgbs = rgbs.reshape(R, H, 3)
    sigmas = sigmas.reshape(R, H)

    deltas = torch.full_like(sigmas, render_step_size)
    rgb, alpha, depth, weights = row_composite(
        rgbs, sigmas, ts, deltas, valid_s, bg_color, render_bkgd)

    # deformation regularizer E[dv^2] + E[(dv_v - sg(dv))^2] over the
    # valid entries (reference utils.py:583)
    nvalid = valid.sum().to(torch.float32).clamp_min(1.0)
    msk = valid[..., None]
    reg = (
        torch.where(msk, del_vector3 ** 2, 0.0).sum() / (3 * nvalid)
        + torch.where(msk, (del_vector_v3 - del_vector3.detach()) ** 2,
                      0.0).sum() / (3 * nvalid)
    )
    return {
        "rgb": rgb,
        "alpha": alpha,
        "depth": depth,
        "weights": weights,       # [R, H] sorted order
        "tri_ids": tri_ids_s,     # [R, H] sorted order
        "valid": valid_s,
        "dh": dh_s,               # [R, H, 3] sorted order
        "reg": reg,
        "n_hits": valid.sum(),
    }


def render_fit_sg_rows(
    sg_params,
    teacher_params,
    hits: HitRows,
    origins,
    viewdirs,
    aabb,
    sg_cfg,
    teacher_cfg,
    *,
    ngp_forward_fn,
    render_step_size: float,
    bg_color: str = "white",
    render_bkgd=None,
):
    """Stage-5 forward on dense rows: the SG model's rgb at the hits,
    the frozen teacher's density, the composite (reference
    utils.py:610-730). Returns (rgb, alpha, depth, weights)."""
    R, H = hits.ts.shape
    xyzs = (origins[:, None, :] + viewdirs[:, None, :] * hits.ts[..., None]
            ).reshape(-1, 3)
    dirs = viewdirs[:, None, :].expand(R, H, 3).reshape(-1, 3)
    rgbs, _ = ngp_forward_fn(sg_params, xyzs, dirs, aabb, sg_cfg)
    _, sigmas = _rf_forward(ngp_forward_fn, teacher_params, xyzs, dirs,
                            aabb, teacher_cfg, stop_gradient_rf=True)
    rgbs = rgbs.reshape(R, H, 3)
    sigmas = sigmas.reshape(R, H)
    deltas = torch.full_like(sigmas, render_step_size)
    return row_composite(rgbs, sigmas, hits.ts, deltas, hits.valid,
                         bg_color, render_bkgd)


def render_finetune_baking_rows(
    sg_params,
    hits: HitRows,
    origins,
    viewdirs,
    face_vertices,      # [R, H, 3, 3] hit-triangle vertices
    barycentric,        # [R, H, 3] of the hit points
    aabb,
    sg_cfg,
    *,
    features_fn,        # ngp_features(params, x, aabb, cfg)
    features_to_rgb_fn,  # ngp_features_to_rgb(features, dirs, cfg)
    render_step_size: float,
    bg_color: str = "white",
    render_bkgd=None,
):
    """Vertex-feature baking check: the bakeable features at the hit
    triangle's vertices, averaged by the hits' barycentrics, decoded and
    composited (reference render_image_finetune_baking_with_occgrid,
    utils.py:732-861)."""
    R, H = hits.ts.shape
    dirs = viewdirs[:, None, :].expand(R, H, 3)
    feats = features_fn(sg_params, face_vertices.reshape(-1, 3), aabb,
                        sg_cfg)
    feats = feats.reshape(R, H, 3, -1)
    feats = (feats * barycentric[..., None]).sum(dim=2)    # [R, H, D+1]
    sigmas = feats[..., -1]
    rgbs = features_to_rgb_fn(feats[..., :-1].reshape(R * H, -1),
                              dirs.reshape(-1, 3), sg_cfg).reshape(R, H, 3)
    deltas = torch.full_like(sigmas, render_step_size)
    return row_composite(rgbs, sigmas, hits.ts, deltas, hits.valid,
                         bg_color, render_bkgd)


class PackedHits(NamedTuple):
    """Valid mesh hits compacted to a flat ray-sorted stream, in
    (ray, original depth) order; pads carry ray == n_rays, slot R*H,
    tri -1 and t 0."""
    ray_indices: torch.Tensor  # [M] int32, non-decreasing; pad = n_rays
    slots: torch.Tensor        # [M] int32 flat index into [R*H]
    tri_ids: torch.Tensor      # [M] int32, -1 pad
    ts: torch.Tensor           # [M] f32, 0 pad
    valid: torch.Tensor        # [M] bool
    num_valid: torch.Tensor    # [] int32 TRUE hit count (may exceed M)


def pack_hit_rows(hits: HitRows, cap: int) -> PackedHits:
    """Compact the valid entries of dense hit rows into a [cap] stream.
    With more than `cap` valid hits the stream truncates (the highest
    ray indices lose hits first); num_valid reports the true demand."""
    R, H = hits.ts.shape
    n = R * H
    flat_valid = hits.valid.reshape(-1)
    iota = torch.arange(n, dtype=torch.int32, device=flat_valid.device)
    keys = torch.where(flat_valid, iota, n)
    slots = torch.sort(keys).values[:cap]
    if n < cap:
        slots = torch.cat([slots, slots.new_full((cap - n,), n)])
    valid = slots < n
    s = slots.clamp(0, n - 1).to(torch.int64)
    ray_indices = torch.where(valid, slots // H, R).to(torch.int32)
    tri_ids = torch.where(valid, hits.tri_ids.reshape(-1)[s], -1)
    ts = torch.where(valid, hits.ts.reshape(-1)[s], 0.0)
    return PackedHits(ray_indices=ray_indices, slots=slots, tri_ids=tri_ids,
                      ts=ts, valid=valid,
                      num_valid=flat_valid.sum().to(torch.int32))


def packed_hits_from_host(slots, tri_ids, ts, num_valid, n_rays: int,
                          max_hits: int) -> PackedHits:
    """Wrap a host-compacted hit stream (MeshIntersection.
    intersect_packed) as PackedHits: the ray indices and validity derive
    on the device from the slots, so the upload stays 12 B a hit. The
    same layout as pack_hit_rows on the dense image of the same hits."""
    n = n_rays * max_hits
    valid = slots < n
    ray_indices = torch.where(valid, slots.clamp(0, n - 1) // max_hits,
                              n_rays).to(torch.int32)
    return PackedHits(
        ray_indices=ray_indices, slots=slots, tri_ids=tri_ids, ts=ts,
        valid=valid,
        num_valid=torch.as_tensor(num_valid, dtype=torch.int32,
                                  device=slots.device),
    )


def packed_ray_mask(ph: PackedHits, n_rays: int, cap: int):
    """[n_rays] bool: rays whose hits were all packed. When the cap
    truncates (num_valid > cap), every ray at or after the one holding
    the cap-th hit is masked out."""
    bound = torch.where(ph.num_valid > cap, ph.ray_indices[cap - 1], n_rays)
    return torch.arange(n_rays, device=bound.device) < bound


def packed_composite(ray_indices, rgbs, sigmas, ts, valid, n_rays: int,
                     render_step_size: float, bg_color: str = "white",
                     render_bkgd=None):
    """row_composite on a packed stream: a segmented-scan transmittance,
    then color, alpha and weighted depth in ONE presorted segment sum of
    8-wide rows (K3 on the card; differentiable, a gather backward)."""
    tau = torch.where(valid, sigmas * render_step_size, 0.0)
    boundaries = scan.mark_pack_boundaries(ray_indices)
    exc = scan.exclusive_sum(tau, boundaries)
    weights = torch.where(valid, torch.exp(-exc) * (1.0 - torch.exp(-tau)),
                          0.0)
    w = weights[:, None]
    vals8 = torch.cat(
        [w * rgbs, w, w * ts[:, None],
         torch.zeros((w.shape[0], 3), dtype=torch.float32, device=w.device)],
        dim=1,
    )
    acc = presorted_row_segment_sum_vjp(ray_indices.to(torch.int32),
                                        vals8.contiguous(), n_rays)
    color = acc[:, 0:3]
    alpha = acc[:, 3:4]
    depth = acc[:, 4:5] / alpha.clamp_min(1e-10)
    return (_background(color, alpha, bg_color, render_bkgd), alpha, depth,
            weights)


def render_finetune_packed(
    ngp_params, field_params, hits: HitRows, origins, viewdirs,
    face_vertices, aabb, ngp_cfg, field_cfg, *, ngp_forward_fn,
    field_apply_fn, scaling: float, render_step_size: float, pack_cap: int,
    bg_color: str = "white", render_bkgd=None, generator=None,
    bary_uniforms=None, stop_gradient_rf: bool = False,
):
    """render_finetune_rows on the packed stream of the dense rows: the
    field and radiance-field queries run over `pack_cap` actual hits
    instead of R*max_hits slots."""
    R, H = hits.ts.shape
    cap = min(int(pack_cap), R * H)
    ph = pack_hit_rows(hits, cap)
    s = ph.slots.clamp(0, R * H - 1).to(torch.int64)
    if bary_uniforms is None:
        bary_uniforms = torch.rand((R, H, 3), generator=generator,
                                   device=origins.device)
    u = bary_uniforms.reshape(R * H, 3)[s]
    fv = face_vertices.reshape(R * H, 3, 3)[s]
    return _finetune_on_stream(
        ngp_params, field_params, ph, R, origins, viewdirs, fv, u, aabb,
        ngp_cfg, field_cfg, ngp_forward_fn=ngp_forward_fn,
        field_apply_fn=field_apply_fn, scaling=scaling,
        render_step_size=render_step_size, bg_color=bg_color,
        render_bkgd=render_bkgd, stop_gradient_rf=stop_gradient_rf,
        cap=cap,
    )


def render_finetune_packed_stream(
    ngp_params, field_params, ph: PackedHits, n_rays: int, max_hits: int,
    origins, viewdirs,
    face_verts_table,   # [F, 3, 3] device-resident world verts per face
    aabb, ngp_cfg, field_cfg, *, ngp_forward_fn, field_apply_fn,
    scaling: float, render_step_size: float, bg_color: str = "white",
    render_bkgd=None, generator=None, bary_uniforms=None,
    stop_gradient_rf: bool = False,
):
    """render_finetune_packed when the hits arrive packed from the host
    (HitPrefetcher's packed mode): the face vertices are gathered on
    the device from the resident [F, 3, 3] table, and the uniforms,
    drawn at the dense [R, H, 3] shape, are gathered by slot."""
    R, H = n_rays, max_hits
    s = ph.slots.clamp(0, R * H - 1).to(torch.int64)
    if bary_uniforms is None:
        bary_uniforms = torch.rand((R, H, 3), generator=generator,
                                   device=origins.device)
    u = bary_uniforms.reshape(R * H, 3)[s]
    fv = face_verts_table[ph.tri_ids.clamp_min(0).to(torch.int64)]
    return _finetune_on_stream(
        ngp_params, field_params, ph, R, origins, viewdirs, fv, u, aabb,
        ngp_cfg, field_cfg, ngp_forward_fn=ngp_forward_fn,
        field_apply_fn=field_apply_fn, scaling=scaling,
        render_step_size=render_step_size, bg_color=bg_color,
        render_bkgd=render_bkgd, stop_gradient_rf=stop_gradient_rf,
        cap=ph.ts.shape[0],
    )


def _stable_sort_by_ray_then_t(ray_indices, tkey):
    """The permutation of JAX's stable lax.sort on the keys (ray, t):
    a stable sort by t, then a stable sort by ray."""
    by_t = torch.argsort(tkey, stable=True)
    return by_t[torch.argsort(ray_indices[by_t], stable=True)]


def _finetune_on_stream(
    ngp_params, field_params, ph: PackedHits, R, origins, viewdirs,
    fv,                 # [M, 3, 3] hit-triangle vertices (pre-gathered)
    u,                  # [M, 3] barycentric uniforms (pre-gathered)
    aabb, ngp_cfg, field_cfg, *, ngp_forward_fn, field_apply_fn, scaling,
    render_step_size, bg_color, render_bkgd, stop_gradient_rf, cap,
):
    M = ph.ts.shape[0]
    ray = ph.ray_indices.clamp(0, R - 1).to(torch.int64)
    d = viewdirs[ray]                                      # [M, 3]
    xyzs = origins[ray] + d * ph.ts[:, None]

    v_samples = (fv * u[..., None]).sum(dim=-2) / (
        u[..., None].sum(dim=-2) + 1e-6)

    # ONE field query over the hit points and the barycentric samples
    # (the encode is per point, so this equals two calls); its backward
    # is one table gradient (K1 on the card)
    f_both = field_apply_fn(field_params, torch.cat([xyzs, v_samples]),
                            field_cfg)[:, 0]
    del_scalar, del_scalar_v = f_both[:M], f_both[M:]
    # the scalar field broadcast over xyz, then dotted with the direction
    # (reference utils.py:557-571, output_dim 1)
    del_vector = torch.tanh(del_scalar) * scaling          # [M]
    del_delta = del_vector * d.sum(dim=-1)                 # [M]
    del_vector_v = torch.tanh(del_scalar_v) * scaling      # [M]

    dh = del_delta[:, None] * d                            # [M, 3]
    xyzs = xyzs + dh
    ts = ph.ts + del_delta

    # re-sort each ray's segment by deformed depth: one stable (ray, t)
    # sort of the stream; pads (ray == R, t = inf) stay at the tail
    tkey = torch.where(ph.valid, ts.detach(), float("inf"))
    perm = _stable_sort_by_ray_then_t(ph.ray_indices, tkey)
    ts_s = ts[perm]
    xyzs_s = xyzs[perm]
    d_s = d[perm]
    dh_s = dh[perm]
    tri_ids_s = ph.tri_ids[perm]
    valid_s = ph.valid[perm]

    rgbs, sigmas = _rf_forward(ngp_forward_fn, ngp_params, xyzs_s, d_s,
                               aabb, ngp_cfg, stop_gradient_rf)
    rgb, alpha, depth, weights = packed_composite(
        ph.ray_indices, rgbs, sigmas, ts_s, valid_s, R, render_step_size,
        bg_color, render_bkgd)

    # the deformation regularizer over the rendered hits (the scalar
    # field repeats over 3 channels, so the 3-channel mean is the scalar
    # mean)
    vmask = ph.valid.to(torch.float32)
    nvalid = vmask.sum().clamp_min(1.0)
    reg = (
        (vmask * del_vector ** 2).sum() / nvalid
        + (vmask * (del_vector_v - del_vector.detach()) ** 2).sum() / nvalid
    )
    return {
        "rgb": rgb,
        "alpha": alpha,
        "depth": depth,
        "weights": weights,       # [M] packed, sorted order
        "tri_ids": tri_ids_s,     # [M] packed, sorted order
        "valid": valid_s,         # [M]
        "dh": dh_s,               # [M, 3]
        "reg": reg,
        "n_hits": ph.num_valid,   # TRUE demand (drives the batch size)
        "n_rendered": ph.valid.sum().to(torch.int32),
        "ray_mask": packed_ray_mask(ph, R, cap),
    }


def render_fit_sg_packed(
    sg_params, teacher_params, hits: HitRows, origins, viewdirs, aabb,
    sg_cfg, teacher_cfg, *, ngp_forward_fn, render_step_size: float,
    pack_cap: int, bg_color: str = "white", render_bkgd=None,
):
    """render_fit_sg_rows on the packed stream of the dense rows.
    Returns (rgb, alpha, depth, weights, packed_hits, ray_mask); the
    mask leaves out the rays the cap truncated (packed_ray_mask)."""
    R, H = hits.ts.shape
    ph = pack_hit_rows(hits, min(int(pack_cap), R * H))
    return render_fit_sg_packed_stream(
        sg_params, teacher_params, ph, R, origins, viewdirs, aabb, sg_cfg,
        teacher_cfg, ngp_forward_fn=ngp_forward_fn,
        render_step_size=render_step_size, bg_color=bg_color,
        render_bkgd=render_bkgd)


def render_fit_sg_packed_stream(
    sg_params, teacher_params, ph: PackedHits, n_rays: int, origins,
    viewdirs, aabb, sg_cfg, teacher_cfg, *, ngp_forward_fn,
    render_step_size: float, bg_color: str = "white", render_bkgd=None,
):
    """render_fit_sg_packed on a stream packed by the host
    (MeshIntersection.intersect_packed, 12 B a hit): the SG model and
    the teacher query the stream's hits, and the composite is one K3
    segment sum with its gather VJP."""
    R = n_rays
    ray = ph.ray_indices.clamp(0, R - 1).to(torch.int64)
    d = viewdirs[ray]
    xyzs = origins[ray] + d * ph.ts[:, None]
    rgbs, _ = ngp_forward_fn(sg_params, xyzs, d, aabb, sg_cfg)
    _, sigmas = _rf_forward(ngp_forward_fn, teacher_params, xyzs, d, aabb,
                            teacher_cfg, stop_gradient_rf=True)
    rgb, alpha, depth, weights = packed_composite(
        ph.ray_indices, rgbs, sigmas, ph.ts, ph.valid, R, render_step_size,
        bg_color, render_bkgd)
    return (rgb, alpha, depth, weights, ph,
            packed_ray_mask(ph, R, ph.ts.shape[0]))


def mesh_accumulate_deformation(cache_d, cache_w, dh, weights, tri_ids,
                                valid, n_faces: int):
    """MeshFinetune.update_d: scatter-add the per-face dh*w and w
    (reference mesh_utils.py:126-133, torch_scatter.scatter_add). The
    inputs are detached; index_add_ is the library call JAX's XLA
    segment_sum maps to."""
    with torch.no_grad():
        tri = torch.where(valid, tri_ids, n_faces).reshape(-1) \
            .to(torch.int64)
        w = torch.where(valid, weights, 0.0).reshape(-1)
        dhw = (dh * weights[..., None]).reshape(-1, 3)
        add_d = torch.zeros((n_faces + 1, 3), dtype=torch.float32,
                            device=dhw.device).index_add_(0, tri, dhw)
        add_w = torch.zeros((n_faces + 1,), dtype=torch.float32,
                            device=w.device).index_add_(0, tri, w)
    return cache_d + add_d[:-1], cache_w + add_w[:-1]


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mesh_update_vertices(vertices, faces, cache_d, cache_w,
                         scaling: float):
    """MeshFinetune.update_faces: the per-face mean deformation, clipped
    to +-scaling, scatter-meaned onto the vertices (mesh_utils.py:
    135-143), on the host."""
    deformation = _host(cache_d) / _host(cache_w)[:, None]
    deformation = np.clip(deformation, -scaling, scaling)
    dv = np.zeros((vertices.shape[0], 3), np.float32)
    cnt = np.zeros((vertices.shape[0],), np.float32)
    np.add.at(dv, faces.reshape(-1), np.repeat(deformation, 3, axis=0))
    np.add.at(cnt, faces.reshape(-1), 1.0)
    dv = dv / np.maximum(cnt[:, None], 1.0)
    return vertices + dv
