"""Packed-sample volume renderer for the stage-1 NGP field.

Port of quadraturefields_tpu/render/renderer.py (stage-1 half): the
occupancy-grid march, the NGP query at the sample midpoints, and one
compositor whose per-ray sum is the presorted segment sum (a CUDA
kernel on the card). `make_test_renderer` is the memory-bounded
alive-ray window renderer of the evaluation path. The stage-2
render_rays_field comes with stage 2.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.ngp import NGPConfig, ngp_forward
from ..ops import scan
from ..ops.grid import (
    OccGridState,
    PackedSamples,
    _cone_t_grid,
    max_march_steps_cone,
    occ_grid_sampling,
    ray_aabb_intersect,
)
from ..ops.hashgrid_sorted import presorted_row_segment_sum


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    render_step_size: float = 5e-3
    near_plane: float = 0.0
    far_plane: float = 1e10
    alpha_thre: float = 0.0
    early_stop_eps: float = 1e-4
    cone_angle: float = 0.0
    max_steps: int = 1024
    max_samples_total: int = 1 << 18
    coarse_factor: int = 0
    max_coarse_hits: int = 0
    coarse_stride: int = 0
    coarse_dilation: int = 0


class RenderResult(NamedTuple):
    rgb: torch.Tensor        # [n_rays, 3]
    opacity: torch.Tensor    # [n_rays, 1]
    depth: torch.Tensor      # [n_rays, 1]
    num_valid: torch.Tensor  # [] int32, true sample demand
    weights: torch.Tensor    # [S]
    sigmas: torch.Tensor     # [S]
    samples: PackedSamples


def _composite(samples: PackedSamples, rgbs, sigmas, n_rays: int,
               render_bkgd, early_stop_eps: float, alpha_thre: float):
    """Packed weights -> per-ray color, opacity, depth (+ background).
    Color, opacity and weighted depth go through ONE presorted segment
    sum of 8-wide rows, as in the JAX package."""
    sigmas = torch.where(samples.valid, sigmas, 0.0)
    boundaries = scan.mark_pack_boundaries(samples.ray_indices)
    weights, trans, alphas = scan.render_weight_from_density(
        samples.t_starts, samples.t_ends, sigmas, boundaries
    )
    # nerfacc prunes invisible samples while sampling; the same
    # thresholds folded into the weights give the same composite
    vis = trans >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (alphas >= alpha_thre)
    weights = torch.where(vis & samples.valid, weights, 0.0)

    t_mid = (samples.t_starts + samples.t_ends) / 2.0
    w = weights[:, None]
    vals8 = torch.cat(
        [w * rgbs, w, w * t_mid[:, None],
         torch.zeros((w.shape[0], 3), dtype=torch.float32, device=w.device)],
        dim=1,
    )
    acc = presorted_row_segment_sum(samples.ray_indices, vals8, n_rays)
    colors = acc[:, 0:3]
    opacity = acc[:, 3:4]
    depth = acc[:, 4:5] / acc[:, 3:4].clamp_min(1e-10)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacity)
    return colors, opacity, depth, weights


def _sample_positions(samples: PackedSamples, origins, viewdirs,
                      n_rays: int):
    idx = samples.ray_indices.clamp(0, n_rays - 1).to(torch.int64)
    t_mid = (samples.t_starts + samples.t_ends)[:, None] / 2.0
    pos = origins[idx] + viewdirs[idx] * t_mid
    return pos, viewdirs[idx], idx


def render_rays_occgrid(
    ngp_params,
    aabb: torch.Tensor,
    ngp_cfg: NGPConfig,
    occ_state: OccGridState,
    origins: torch.Tensor,
    viewdirs: torch.Tensor,
    rcfg: RenderConfig,
    render_bkgd: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Volume rendering with occupancy-grid sampling (stage-1 path)."""
    n_rays = origins.shape[0]
    samples = occ_grid_sampling(
        occ_state,
        origins,
        viewdirs,
        render_step_size=rcfg.render_step_size,
        max_steps=rcfg.max_steps,
        max_samples_total=rcfg.max_samples_total,
        near_plane=rcfg.near_plane,
        far_plane=rcfg.far_plane,
        coarse_factor=rcfg.coarse_factor,
        max_coarse_hits=rcfg.max_coarse_hits,
        coarse_stride=rcfg.coarse_stride,
        coarse_dilation=rcfg.coarse_dilation,
        cone_angle=rcfg.cone_angle,
        contract_aabb=aabb if ngp_cfg.unbounded else None,
    )
    pos, dirs, _ = _sample_positions(samples, origins, viewdirs, n_rays)
    rgbs, sigmas = ngp_forward(ngp_params, pos, dirs, aabb, ngp_cfg)
    sigmas = sigmas[..., 0]
    colors, opacity, depth, weights = _composite(
        samples, rgbs, sigmas, n_rays, render_bkgd,
        rcfg.early_stop_eps, rcfg.alpha_thre,
    )
    return RenderResult(
        rgb=colors,
        opacity=opacity,
        depth=depth,
        num_valid=samples.num_valid,
        weights=weights,
        sigmas=torch.where(samples.valid, sigmas, 0.0),
        samples=samples,
    )


def make_test_renderer(
    ngp_params,
    aabb: torch.Tensor,
    ngp_cfg: NGPConfig,
    rcfg: RenderConfig,
    window_steps: int = 64,
    window_budget: int = 1 << 16,
    early_stop_eps: float = 1e-4,
):
    """Memory-bounded iterative alive-ray renderer (test-time path).

    Each iteration marches the alive rays over a fixed t-window of
    `window_steps` steps (a budget of `window_budget` samples),
    composites with the carried prefix transmittance, and retires rays
    whose opacity crosses 1 - early_stop_eps or that left the aabb.

    Returns render_fn(occ_state, origins, viewdirs, render_bkgd=None,
    max_windows=64, params=None) -> (rgb, opacity, depth, total_samples).
    """
    dt = rcfg.render_step_size
    contracted = bool(ngp_cfg.unbounded)

    def window(params, occ_state, origins, viewdirs, near_planes, rgb,
               opacity, depth, alive):
        n_rays = origins.shape[0]
        # windows re-anchored at the previous knot continue the one-shot
        # t-grid, up to the f32 rounding of the re-anchored knot
        far = _cone_t_grid(near_planes, dt, rcfg.cone_angle,
                           window_steps)[:, -1]
        samples = occ_grid_sampling(
            occ_state, origins, viewdirs,
            render_step_size=dt,
            max_steps=window_steps,
            max_samples_total=window_budget,
            near_plane=near_planes,
            far_plane=far.clamp_max(rcfg.far_plane),
            cone_angle=rcfg.cone_angle,
            contract_aabb=aabb if contracted else None,
        )
        pos, dirs, idx = _sample_positions(samples, origins, viewdirs,
                                           n_rays)
        in_window = samples.valid & alive[idx]
        rgbs, sigmas = ngp_forward(params, pos, dirs, aabb, ngp_cfg)
        sigmas = torch.where(in_window, sigmas[..., 0], 0.0)

        boundaries = scan.mark_pack_boundaries(samples.ray_indices)
        weights, _, alphas = scan.render_weight_from_density(
            samples.t_starts, samples.t_ends, sigmas, boundaries
        )
        prefix = 1.0 - opacity[idx, 0]
        weights = torch.where(in_window, weights * prefix, 0.0)
        if rcfg.alpha_thre > 0:
            weights = torch.where(alphas >= rcfg.alpha_thre, weights, 0.0)

        # color, opacity and weighted depth in one 5-wide segment sum
        t_mid = (samples.t_starts + samples.t_ends) / 2.0
        acc = scan.accumulate_along_rays(
            weights, samples.ray_indices,
            torch.cat([rgbs, torch.ones_like(t_mid)[:, None],
                       t_mid[:, None]], dim=1),
            n_rays,
        )
        rgb = rgb + acc[:, 0:3]
        opacity = opacity + acc[:, 3:4]
        depth = depth + acc[:, 4:5]
        if contracted:
            t_max = torch.full((n_rays,), rcfg.far_plane,
                               device=origins.device)
        else:
            t_max = ray_aabb_t_max(occ_state.aabb, origins, viewdirs,
                                   rcfg.far_plane)
        alive = (opacity[:, 0] <= 1.0 - early_stop_eps) & (far < t_max)
        return far, rgb, opacity, depth, alive, in_window.sum()

    def render_fn(occ_state, origins, viewdirs, render_bkgd=None,
                  max_windows: int = 64, params=None):
        params = ngp_params if params is None else params
        n_rays = origins.shape[0]
        dev = origins.device
        if contracted:
            near = torch.full((n_rays,), rcfg.near_plane, device=dev)
            need = max_march_steps_cone(rcfg.near_plane, rcfg.far_plane, dt,
                                        rcfg.cone_angle)
            max_windows = max(max_windows, -(-need // window_steps))
        else:
            # anchor each ray at its aabb entry so the window samples land
            # on the one-shot renderer's t-grid
            t_entry, _, _ = ray_aabb_intersect(origins, viewdirs,
                                               occ_state.aabb)
            near = t_entry.clamp_min(rcfg.near_plane)
        rgb = torch.zeros((n_rays, 3), device=dev)
        opacity = torch.zeros((n_rays, 1), device=dev)
        depth = torch.zeros((n_rays, 1), device=dev)
        alive = torch.ones((n_rays,), dtype=torch.bool, device=dev)
        total = 0
        for _ in range(max_windows):
            near, rgb, opacity, depth, alive, ns = window(
                params, occ_state, origins, viewdirs, near, rgb, opacity,
                depth, alive,
            )
            total += int(ns)
            if not bool(alive.any()):
                break
        if render_bkgd is not None:
            rgb = rgb + render_bkgd * (1.0 - opacity)
        return rgb, opacity, depth, total

    return render_fn


def ray_aabb_t_max(aabb, origins, viewdirs, far_plane):
    _, t_max, _ = ray_aabb_intersect(origins, viewdirs, aabb)
    return t_max.clamp_max(far_plane)


def render_image_with_occgrid(render_fn, origins: torch.Tensor,
                              viewdirs: torch.Tensor, chunk: int = 8192):
    """Chunked full-image render: pads the rays to a multiple of `chunk`
    (zero origins, direction (0, 0, 1)) and maps `render_fn(origins,
    viewdirs)` over the chunks. render_fn returns a RenderResult-like
    tuple whose first 3 fields are per-ray and whose 4th counts
    samples."""
    n = origins.shape[0]
    n_pad = (n + chunk - 1) // chunk * chunk
    dev = origins.device
    o = torch.cat([origins, torch.zeros((n_pad - n, 3), device=dev)])
    pad_d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n_pad - n, 3)
    d = torch.cat([viewdirs, pad_d])
    rgbs, opas, depths = [], [], []
    total = 0
    for i in range(0, n_pad, chunk):
        res = render_fn(o[i:i + chunk], d[i:i + chunk])
        rgbs.append(res[0])
        opas.append(res[1])
        depths.append(res[2])
        total += int(res[3])
    return (torch.cat(rgbs)[:n], torch.cat(opas)[:n], torch.cat(depths)[:n],
            total)
