"""Occupancy-grid estimator: state, ray/box tests and the masked march.

Port of quadraturefields_tpu/ops/grid.py (sampling half). The contract
is the JAX package's: a fixed number of uniform steps per ray through
the ray/aabb span, each candidate masked by the occupancy binary, and
the survivors compacted into one flat ray-sorted buffer of static
length `max_samples_total`, whose padding carries ray index == n_rays.
The two-level march probes a dilated coarse grid first; its coarse
lookup is ops/occ_bits.py (a CUDA kernel on the card). Training marches
with stratified jitter, and `occ_grid_update` refreshes the grid with an
EMA max of density evaluations at jittered cell positions. The march
takes its uniforms as a tensor; the update takes a tensor or draws from
a `torch.Generator`. So tests can hand both JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .activations import contract_to_unisphere, inv_contract_from_unisphere
from .occ_bits import bits_lookup_applicable, occupancy_lookup_bits


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 128
    warmup_steps: int = 256
    update_interval: int = 16
    ema_decay: float = 0.95
    occ_thre: float = 0.01
    partitions: int = 4


class OccGridState(NamedTuple):
    occs: torch.Tensor      # [res^3] f32 EMA densities
    binaries: torch.Tensor  # [res, res, res] bool
    aabb: torch.Tensor      # [6] f32


def occ_grid_init(aabb, cfg: OccGridConfig, device=None) -> OccGridState:
    res = cfg.resolution
    return OccGridState(
        occs=torch.zeros((res**3,), dtype=torch.float32, device=device),
        binaries=torch.ones((res, res, res), dtype=torch.bool,
                            device=device),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=device),
    )


def _cell_positions(aabb, res: int, idx_flat, jitter):
    """World positions of the flat cells idx_flat [P], jittered inside
    each cell by the uniforms jitter [P, 3] (x, y, z)."""
    iz = idx_flat // (res * res)
    iy = (idx_flat // res) % res
    ix = idx_flat % res
    coords = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    unit = (coords + jitter) / res
    return aabb[:3] + unit * (aabb[3:] - aabb[:3])


def occ_grid_update(state: OccGridState, step: int, occ_eval_fn,
                    cfg: OccGridConfig, contract_aabb=None, *,
                    jitter=None, generator=None) -> OccGridState:
    """One EMA update (the caller calls it every cfg.update_interval
    steps). During warm-up (step < cfg.warmup_steps) every partition of
    the flat grid is evaluated; after it one partition per update, in
    rotation. occs <- max(decay * occs, occ_eval_fn(x)) on the evaluated
    cells, and binaries = occs > min(mean(occs), occ_thre).

    occ_eval_fn(x [P, 3] world) -> [P] occupancy (density * step size).
    jitter: [P, 3] uniforms in [0, 1), P = cells per partition, else
    drawn from `generator`. One draw serves every partition of a warm-up
    update, as in JAX (one key for all partitions). With
    `contract_aabb`, cells live in contracted [0,1]^3 and are mapped
    back to world space (the unbounded estimator).
    """
    res = cfg.resolution
    n_cells = res**3
    part = n_cells // cfg.partitions
    occs = state.occs
    dev = occs.device
    if jitter is None:
        jitter = torch.rand((part, 3), generator=generator, device=dev)
    jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev)

    def eval_part(part_id: int):
        idx = torch.arange(part_id * part, (part_id + 1) * part,
                           device=dev)
        if contract_aabb is None:
            x = _cell_positions(state.aabb, res, idx, jitter)
        else:
            unit = _as_f32([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], occs)
            y = _cell_positions(unit, res, idx, jitter)
            # clamp away from the contraction's open boundary
            y = y.clamp(1e-4, 1.0 - 1e-4)
            x = inv_contract_from_unisphere(y, _as_f32(contract_aabb, occs))
        return occ_eval_fn(x).reshape(-1).to(torch.float32)

    if cfg.partitions == 1:
        new_occs = torch.maximum(occs * cfg.ema_decay, eval_part(0))
    elif step < cfg.warmup_steps:
        upd = torch.cat([eval_part(p) for p in range(cfg.partitions)])
        if upd.shape[0] < n_cells:  # non-divisible tail: never updated
            upd = F.pad(upd, (0, n_cells - upd.shape[0]))
        new_occs = torch.maximum(occs * cfg.ema_decay, upd)
    else:
        p = (step // cfg.update_interval) % cfg.partitions
        sl = slice(p * part, (p + 1) * part)
        new_occs = occs.clone()
        new_occs[sl] = torch.maximum(occs[sl] * cfg.ema_decay, eval_part(p))
    thre = torch.clamp(new_occs.mean(), max=cfg.occ_thre)
    binaries = (new_occs > thre).reshape(res, res, res)
    return OccGridState(occs=new_occs, binaries=binaries, aabb=state.aabb)


def _aabb_numpy(aabb) -> np.ndarray:
    if torch.is_tensor(aabb):
        return aabb.detach().cpu().numpy()
    return np.asarray(aabb)


def ray_aabb_intersect(origins, viewdirs, aabb):
    """Slab test: (t_min, t_max, hit) per ray, both clamped at 0; a miss
    gets t_min = 1e10 and t_max = -1e10."""
    tiny = torch.where(viewdirs >= 0, 1e-10, -1e-10)
    inv_d = 1.0 / torch.where(viewdirs.abs() < 1e-10, tiny, viewdirs)
    t0 = (aabb[:3] - origins) * inv_d
    t1 = (aabb[3:] - origins) * inv_d
    t_min = torch.minimum(t0, t1).amax(dim=-1)
    t_max = torch.maximum(t0, t1).amin(dim=-1)
    t_min = t_min.clamp_min(0.0)
    hit = t_min <= t_max
    return (torch.where(hit, t_min, 1e10), torch.where(hit, t_max, -1e10),
            hit)


def occupancy_lookup(binaries, aabb, x):
    """binaries[cell(x)] with out-of-box positions -> False."""
    res = binaries.shape[0]
    unit = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    inside = ((unit >= 0.0) & (unit < 1.0)).all(dim=-1)
    cell = (unit * res).to(torch.int32).clamp(0, res - 1).to(torch.int64)
    flat = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    return binaries.reshape(-1)[flat] & inside


class PackedSamples(NamedTuple):
    """Flat ray-sorted sample buffer of static length S; padding has
    ray_indices == n_rays and valid == False."""
    ray_indices: torch.Tensor  # [S] int32
    t_starts: torch.Tensor     # [S] f32
    t_ends: torch.Tensor       # [S] f32
    valid: torch.Tensor        # [S] bool
    num_valid: torch.Tensor    # [] int32: true count before truncation


def max_march_steps(aabb, render_step_size: float) -> int:
    """Worst-case uniform steps across the aabb diagonal."""
    aabb = _aabb_numpy(aabb).astype(np.float64)
    diag = float(np.linalg.norm(aabb[3:] - aabb[:3]))
    return int(np.ceil(diag / render_step_size)) + 1


def max_march_steps_cone(near: float, far: float, render_step_size: float,
                         cone_angle: float) -> int:
    """Step bound for cone marching: linear dt-steps until t*cone_angle
    exceeds dt, then geometric growth."""
    if cone_angle <= 0:
        return int(np.ceil((far - near) / render_step_size)) + 1
    t_star = max(render_step_size / cone_angle, near)
    linear = max(0, int(np.ceil((t_star - near) / render_step_size))) + 1
    geom = int(
        np.ceil(np.log(far / t_star) / np.log1p(cone_angle))
    ) + 1 if far > t_star else 0
    return linear + max(geom, 0) + 1


def _cone_t_grid(t_min, dt: float, cone_angle: float, max_steps: int):
    """Per-ray knots [n_rays, max_steps+1]: spacing dt until
    t*cone_angle > dt, then geometric (1+cone_angle) growth."""
    i = torch.arange(max_steps + 1, dtype=torch.float32,
                     device=t_min.device)[None, :]
    if cone_angle <= 0:
        return t_min[:, None] + i * dt
    t_star = dt / cone_angle
    i_star = torch.ceil((t_star - t_min).clamp_min(0.0) / dt)[:, None]
    t_lin = t_min[:, None] + i * dt
    t_at_star = t_min[:, None] + i_star * dt
    t_geo = t_at_star * torch.pow(
        torch.tensor(1.0 + cone_angle, dtype=torch.float32), i - i_star
    )
    return torch.where(i <= i_star, t_lin, t_geo)


def compact_indices(flat_mask: torch.Tensor, size: int) -> torch.Tensor:
    """Ordered indices (int64) of the True entries, cut or padded with
    n = len(flat_mask) to exactly `size` — the nonzero(size=, fill=n)
    contract. torch.nonzero waits for the device to learn the count."""
    n = flat_mask.shape[0]
    idx = torch.nonzero(flat_mask).reshape(-1)[:size]
    if idx.shape[0] < size:
        pad = torch.full((size - idx.shape[0],), n, dtype=idx.dtype,
                         device=idx.device)
        idx = torch.cat([idx, pad])
    return idx


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def occ_grid_sampling(
    state: OccGridState,
    origins: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    render_step_size: float,
    max_steps: int,
    max_samples_total: int,
    near_plane=0.0,   # scalar or per-ray [n_rays]
    far_plane=1e10,   # scalar or per-ray [n_rays]
    stratified: bool = False,
    t_jitter=None,    # [n_rays] uniforms in [0, 1), needed by stratified
    coarse_factor: int = 0,
    max_coarse_hits: int = 0,
    coarse_stride: int = 0,
    coarse_dilation: int = 0,
    cone_angle: float = 0.0,
    contract_aabb=None,
) -> PackedSamples:
    """Fixed-step masked ray march + global compaction: per-ray interval
    [t_min, t_max] from the slab test intersected with [near, far],
    samples at t0 + i*dt whose midpoint cell is occupied. With
    coarse_factor > 1 on a grid whose coarse level keeps >= 32^3 cells,
    the two-level march gives the same sample set. `stratified` (the
    training march) shifts each ray's t0 by t_jitter * dt."""
    n_rays = origins.shape[0]
    if contract_aabb is None:
        t_min, t_max, _ = ray_aabb_intersect(origins, viewdirs, state.aabb)
        t_min = torch.maximum(t_min, _as_f32(near_plane, t_min))
        t_max = torch.minimum(t_max, _as_f32(far_plane, t_max))
    else:
        t_min = _as_f32(near_plane, origins).expand(n_rays)
        t_max = _as_f32(far_plane, origins).expand(n_rays)
    if stratified:
        if t_jitter is None:
            raise ValueError("the stratified march needs t_jitter")
        t_min = t_min + _as_f32(t_jitter, origins) * render_step_size
    if (
        coarse_factor > 1
        and contract_aabb is None
        and cone_angle == 0.0
        and state.binaries.shape[0] // coarse_factor >= 32
    ):
        stride = coarse_stride or coarse_factor
        budget_c = max_coarse_hits or max(
            max_samples_total * coarse_factor // stride, 1024
        )
        rc = state.binaries.shape[0] // coarse_factor
        dil = coarse_dilation or _coarse_dilation_cells(
            state.aabb, rc, stride, render_step_size
        )
        return _two_level_march(
            state, origins, viewdirs, t_min, t_max, n_rays,
            render_step_size, max_steps, max_samples_total,
            coarse_factor, budget_c, stride, dil,
        )

    knots = _cone_t_grid(t_min, render_step_size, cone_angle, max_steps)
    t0 = knots[:, :-1]
    t1 = knots[:, 1:]
    t_mid = (t0 + t1) * 0.5
    in_span = t_mid < t_max[:, None]
    pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
    if contract_aabb is None:
        occ = occupancy_lookup(state.binaries, state.aabb, pos)
    else:
        y = contract_to_unisphere(pos, _as_f32(contract_aabb, pos))
        unit = _as_f32([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], pos)
        occ = occupancy_lookup(state.binaries, unit, y)
    flat_mask = (in_span & occ).reshape(-1)
    num_valid = flat_mask.sum(dtype=torch.int32)
    sel = compact_indices(flat_mask, max_samples_total)
    is_pad = sel >= flat_mask.shape[0]
    sel_safe = torch.where(is_pad, 0, sel)
    ray_idx = (sel_safe // max_steps).to(torch.int32)
    ts = t0.reshape(-1)[sel_safe]
    te = t1.reshape(-1)[sel_safe]
    return PackedSamples(
        ray_indices=torch.where(is_pad, n_rays, ray_idx).to(torch.int32),
        t_starts=torch.where(is_pad, 0.0, ts),
        t_ends=torch.where(is_pad, 0.0, te),
        valid=~is_pad,
        num_valid=num_valid,
    )


def _dilated_coarse_binaries(binaries, cf: int, dil: int = 1):
    """Max-pool the fine binaries by cf per axis, then dilate by `dil`
    coarse cells ((2*dil+1)^3 max, "SAME" padding)."""
    res = binaries.shape[0]
    rc = res // cf
    coarse = binaries.reshape(rc, cf, rc, cf, rc, cf) \
        .any(dim=5).any(dim=3).any(dim=1)
    f = coarse.to(torch.float32)[None, None]
    out = F.max_pool3d(f, kernel_size=2 * dil + 1, stride=1, padding=dil)
    return out[0, 0] > 0.0


def _coarse_dilation_cells(aabb, rc: int, stride: int, dt: float) -> int:
    """Dilation radius (coarse cells) that keeps the strided probe a
    strict superset of the fine march."""
    aabb = _aabb_numpy(aabb)
    cell = float((aabb[3:] - aabb[:3]).min()) / rc
    return max(1, int(np.ceil(stride * dt / cell - 1e-6)))


def resolve_coarse_stride(setting: int, aabb, resolution: int, cf: int,
                          dt: float):
    """Trainer convention -> (coarse_stride, coarse_dilation): -1 auto
    (one coarse cell), 0 legacy (stride = coarse_factor, dilation 1),
    > 0 explicit (dilation derived)."""
    if cf <= 1 or setting == 0:
        return 0, 0
    if setting > 0:
        rc = max(resolution // cf, 1)
        return setting, _coarse_dilation_cells(aabb, rc, setting, dt)
    return auto_coarse_stride(aabb, resolution, cf, dt)


def auto_coarse_stride(aabb, resolution: int, cf: int, dt: float):
    """(stride, dilation): one coarse cell's worth of dt steps, the
    largest stride whose superset dilation stays at 1 cell."""
    rc = max(resolution // cf, 1)
    aabb = _aabb_numpy(aabb)
    ext = float(np.min(aabb[3:] - aabb[:3]))
    stride = max(cf, int(ext / rc / dt))
    return stride, _coarse_dilation_cells(aabb, rc, stride, dt)


def _two_level_march(
    state, origins, viewdirs, t_min, t_max, n_rays,
    dt: float, max_steps: int, max_samples_total: int,
    cf: int, max_coarse_hits: int, stride: int, dil: int,
):
    """Coarse probe every stride*dt over the dilated cf-downsampled grid,
    compaction, then fine refinement (stride sub-steps) of the surviving
    probes: the single-level march's sample set at ~stride x fewer
    occupancy lookups."""
    dev = origins.device
    coarse_steps = -(-max_steps // stride)
    steps_c = torch.arange(coarse_steps, dtype=torch.float32, device=dev)
    seg_mid = t_min[:, None] + (steps_c[None, :] + 0.5) * (stride * dt)
    # clamp the probe just inside the span (a partial last segment's
    # midpoint can leave the aabb while its fine samples are inside)
    seg_mid = torch.minimum(seg_mid, t_max[:, None] - 0.25 * dt)
    in_span_c = (
        t_min[:, None] + steps_c[None, :] * (stride * dt) < t_max[:, None]
    )
    pos_c = origins[:, None, :] + viewdirs[:, None, :] * seg_mid[..., None]
    coarse_bin = _dilated_coarse_binaries(state.binaries, cf, dil)
    if bits_lookup_applicable(coarse_bin.shape[0]):
        occ_c = occupancy_lookup_bits(coarse_bin, state.aabb, pos_c)
    else:
        occ_c = occupancy_lookup(coarse_bin, state.aabb, pos_c)
    flat_c = (in_span_c & occ_c).reshape(-1)
    sel_c = compact_indices(flat_c, max_coarse_hits)
    pad_c = sel_c >= flat_c.shape[0]
    sel_c_safe = torch.where(pad_c, 0, sel_c)
    ray_c = sel_c_safe // coarse_steps
    step_c = sel_c_safe % coarse_steps

    # fine refinement: stride sub-steps per surviving coarse probe
    ks = torch.arange(stride, dtype=torch.float32, device=dev)
    fine_step = step_c[:, None].to(torch.float32) * stride + ks[None, :]
    ts_f = t_min[ray_c][:, None] + fine_step * dt
    tm_f = ts_f + 0.5 * dt
    pos_f = (origins[ray_c][:, None, :]
             + viewdirs[ray_c][:, None, :] * tm_f[..., None])
    occ_f = occupancy_lookup(state.binaries, state.aabb, pos_f)
    in_span_f = tm_f < t_max[ray_c][:, None]
    flat_f = (occ_f & in_span_f & (~pad_c)[:, None]).reshape(-1)

    # when the coarse pass saturates its hit budget, extrapolate the
    # true demand by the truncation ratio (the dynamic batch reads it)
    num_valid = flat_f.sum(dtype=torch.int32)
    num_coarse = flat_c.sum(dtype=torch.int32)
    ratio = (num_coarse.to(torch.float32) / float(max_coarse_hits)) \
        .clamp_min(1.0)
    num_valid = (num_valid.to(torch.float32) * ratio).to(torch.int32)
    sel_f = compact_indices(flat_f, max_samples_total)
    pad_f = sel_f >= flat_f.shape[0]
    sel_f_safe = torch.where(pad_f, 0, sel_f)
    ci = sel_f_safe // stride
    ki = (sel_f_safe % stride).to(torch.float32)
    ray_idx = ray_c[ci]
    ts = t_min[ray_idx] + (step_c[ci].to(torch.float32) * stride + ki) * dt
    te = ts + dt
    return PackedSamples(
        ray_indices=torch.where(pad_f, n_rays, ray_idx).to(torch.int32),
        t_starts=torch.where(pad_f, 0.0, ts),
        t_ends=torch.where(pad_f, 0.0, te),
        valid=~pad_f,
        num_valid=num_valid,
    )
