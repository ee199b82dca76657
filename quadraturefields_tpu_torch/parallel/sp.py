"""Sample-axis (t-window) sharding of the volumetric render over
torch.distributed ranks: the port of quadraturefields_tpu/parallel/sp.py,
with process groups in place of mesh axes.

Rank k of n marches only the t-window [base + k W dt, base + (k+1) W dt)
of every ray, W = ceil(max_steps / n), base = max(t_entry, near) + u dt
(u the stratified jitter, shared by every rank, or 0), so that each
rank's samples are a 1/n share of the march while it keeps the whole
max_samples_total: the render's capacity grows n-fold. The jitter goes
into the window's near plane and the march itself runs unjittered, so
every window's knots lie on the one global grid base + i dt.
Compositing factorizes over the windows:

    T_global(s) = T_in,k T_local(s),   T_in,k = exp(-sum_{j<k} tau_j)

with tau_j window j's optical depth along the ray. One all-gather of
the ranks' [R] optical depths and one all-reduce of the T_in-scaled
partial colour, opacity and weighted depth give the single-device
render up to f32 order. The early stop holds the global transmittance
T_in T_local against early_stop_eps, so a window behind a ray's spent
light gets zero weights, as on one device.

make_dp_sp_render shards the rays over the columns of a RankGrid
(multihost.make_rank_grid) and the windows over its rows: the stitch
stays within a row, and an all-gather over the column returns the
global [R, ...] render on every rank, as JAX's jit gathers it.

The renders are forwards (no graph). Each rank launches the kernels of
the single-device render: the encode (K2), the coarse occupancy bits of
the two-level march (K4) and the per-ray segment sum (K3, once for the
optical depths and once for the partials). As in JAX, the march is the
bounded scene's: no contraction and no cone stepping.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.ngp import NGPConfig, ngp_forward
from ..ops import scan
from ..ops.grid import occ_grid_sampling, ray_aabb_intersect
from ..ops.hashgrid_sorted import presorted_row_segment_sum_vjp
from ..render.renderer import RenderConfig
from .dp import psum_count
from .multihost import RankGrid, shard_batch


def _check_bounded(ngp_cfg: NGPConfig, rcfg: RenderConfig) -> None:
    if ngp_cfg.unbounded or rcfg.cone_angle > 0:
        raise ValueError("the sample-axis render marches a bounded scene "
                         "at a fixed step (no contraction, no cone)")


def _jitter(n_rays: int, device, generator, stratified: bool):
    """The per-ray grid shift u [R]: the same draw on every rank (each
    rank's generator in the same state), or 0."""
    if not stratified:
        return torch.zeros((n_rays,), device=device)
    if generator is None:
        raise ValueError("the stratified render needs a generator")
    return torch.rand((n_rays,), generator=generator, device=device)


def _window_render(params, occ_state, origins, viewdirs, u, aabb,
                   ngp_cfg: NGPConfig, rcfg: RenderConfig, k: int, n: int,
                   group):
    """Window k of n of the rays, stitched over `group` (the n ranks of
    the windows): ([R, 5] colour, opacity and weighted depth summed over
    the windows, this window's valid samples)."""
    dt = rcfg.render_step_size
    w_steps = -(-rcfg.max_steps // n)
    n_rays = origins.shape[0]
    t_entry, _, _ = ray_aabb_intersect(origins, viewdirs, occ_state.aabb)
    base = t_entry.clamp_min(rcfg.near_plane) + u * dt
    # the offsets in f32 as JAX computes them, k * W then times dt
    near = base + float(np.float32(k * w_steps) * np.float32(dt))
    far = (base + float(np.float32((k + 1) * w_steps) * np.float32(dt))) \
        .clamp_max(rcfg.far_plane)
    samples = occ_grid_sampling(
        occ_state, origins, viewdirs, render_step_size=dt,
        max_steps=w_steps, max_samples_total=rcfg.max_samples_total,
        near_plane=near, far_plane=far, coarse_factor=rcfg.coarse_factor,
        max_coarse_hits=rcfg.max_coarse_hits,
        coarse_stride=rcfg.coarse_stride,
        coarse_dilation=rcfg.coarse_dilation,
    )
    ray = samples.ray_indices
    idx = ray.clamp(0, n_rays - 1).to(torch.int64)
    t_mid = (samples.t_starts + samples.t_ends) / 2.0
    pos = origins[idx] + viewdirs[idx] * t_mid[:, None]
    rgbs, sigmas = ngp_forward(params, pos, viewdirs[idx], aabb, ngp_cfg)
    sigmas = torch.where(samples.valid, sigmas[..., 0], 0.0)

    # this window's optical depth per ray, the windows' in front of it
    tau = scan.accumulate_along_rays(
        sigmas * (samples.t_ends - samples.t_starts), ray, None, n_rays)
    taus = [torch.empty_like(tau) for _ in range(n)]
    dist.all_gather(taus, tau.contiguous(), group=group)
    t_in = torch.exp(-sum(taus[:k], torch.zeros_like(tau)))[:, 0]

    boundaries = scan.mark_pack_boundaries(ray)
    weights, trans, alphas = scan.render_weight_from_density(
        samples.t_starts, samples.t_ends, sigmas, boundaries)
    vis = trans * t_in[idx] >= rcfg.early_stop_eps
    if rcfg.alpha_thre > 0:
        vis = vis & (alphas >= rcfg.alpha_thre)
    w = torch.where(vis & samples.valid, weights * t_in[idx], 0.0)[:, None]
    vals8 = torch.cat([w * rgbs, w, w * t_mid[:, None],
                       torch.zeros((w.shape[0], 3), device=w.device)], dim=1)
    part = presorted_row_segment_sum_vjp(ray, vals8, n_rays)[:, :5] \
        .contiguous()
    dist.all_reduce(part, group=group)
    return part, samples.num_valid


def _finish(part, render_bkgd):
    """(rgb, opacity, depth) of the summed partials: the depth divided
    after the sum, the background added."""
    color, opacity = part[:, 0:3], part[:, 3:4]
    depth = part[:, 4:5] / opacity.clamp_min(1e-10)
    if render_bkgd is not None:
        color = color + render_bkgd * (1.0 - opacity)
    return color, opacity, depth


def make_sp_render(aabb, ngp_cfg: NGPConfig, rcfg: RenderConfig,
                   group=None):
    """render(params, occ_state, origins, viewdirs, render_bkgd=None,
    generator=None, stratified=False) -> (rgb [R, 3], opacity [R, 1],
    depth [R, 1], num_valid) with the march depth sharded over the ranks
    of `group` (the default group when None); every rank passes the same
    rays and parameters and returns the same render. num_valid is summed
    over the group. Each rank's sample budget is the whole
    rcfg.max_samples_total."""
    _check_bounded(ngp_cfg, rcfg)
    n, k = dist.get_world_size(group), dist.get_rank(group)

    @torch.no_grad()
    def render(params, occ_state, origins, viewdirs, render_bkgd=None,
               generator=None, stratified: bool = False):
        u = _jitter(origins.shape[0], origins.device, generator, stratified)
        part, nv = _window_render(params, occ_state, origins, viewdirs, u,
                                  aabb, ngp_cfg, rcfg, k, n, group)
        return (*_finish(part, render_bkgd), psum_count(nv, group))

    return render


def make_dp_sp_render(aabb, ngp_cfg: NGPConfig, rcfg: RenderConfig,
                      grid: RankGrid):
    """The 2-D composition on `grid`: row d renders the d-th of grid.dp
    equal slices of the rays (R must divide by grid.dp), its ranks
    sharing the march depth as make_sp_render's do. render(...) takes the
    global rays and, on every rank, returns the global (rgb, opacity,
    depth) [R, ...], gathered over the rank's column, and num_valid
    summed over the grid's ranks."""
    _check_bounded(ngp_cfg, rcfg)

    @torch.no_grad()
    def render(params, occ_state, origins, viewdirs, render_bkgd=None,
               generator=None, stratified: bool = False):
        u = _jitter(origins.shape[0], origins.device, generator, stratified)
        o, d, u = shard_batch((origins, viewdirs, u), grid.dp, grid.dp_index)
        part, nv = _window_render(params, occ_state, o, d, u, aabb, ngp_cfg,
                                  rcfg, grid.sp_index, grid.sp,
                                  grid.sp_group)
        parts = [torch.empty_like(part) for _ in range(grid.dp)]
        dist.all_gather(parts, part, group=grid.dp_group)
        nv = psum_count(psum_count(nv, grid.sp_group), grid.dp_group)
        return (*_finish(torch.cat(parts), render_bkgd), nv)

    return render
