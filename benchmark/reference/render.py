"""Plain PyTorch reference of the stage-1 occupancy-grid renderer.

The ray/box test, the occupancy lookup, the stratified two-level march
of the training step (a coarse probe over the max-pooled and dilated
grid, then the fine steps), the single-level march of the evaluation's
t-windows, the segmented-scan composite, the alive-ray window renderer
of the evaluation, and the occupancy refresh. A frozen copy of the plain
paths of `quadraturefields_tpu_torch` (ops/grid.py, ops/scan.py,
render/renderer.py, as the benchmark was first written), bounded scenes
and cone angle 0 only, with nothing of that package imported. Per-ray
sums are `index_add_` in f32; the coarse grid is worked out here from
the fine binaries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .ngp import Field


@dataclasses.dataclass(frozen=True)
class March:
    """A render configuration of a bounded scene."""

    step: float = 5e-3
    max_steps: int = 1040
    budget: int = 1 << 20
    coarse_factor: int = 4
    coarse_stride: int = 0
    coarse_dilation: int = 0
    early_stop_eps: float = 1e-4


def aabb_span(origins, viewdirs, aabb):
    """(t_min, t_max, hit): the slab test, clamped at 0."""
    tiny = torch.where(viewdirs >= 0, 1e-10, -1e-10)
    inv_d = 1.0 / torch.where(viewdirs.abs() < 1e-10, tiny, viewdirs)
    t0 = (aabb[:3] - origins) * inv_d
    t1 = (aabb[3:] - origins) * inv_d
    t_min = torch.minimum(t0, t1).amax(dim=-1).clamp_min(0.0)
    t_max = torch.maximum(t0, t1).amin(dim=-1)
    hit = t_min <= t_max
    return (torch.where(hit, t_min, 1e10), torch.where(hit, t_max, -1e10),
            hit)


def occupied(binaries, aabb, x):
    """binaries[cell(x)], False outside the box."""
    res = binaries.shape[0]
    unit = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    inside = ((unit >= 0.0) & (unit < 1.0)).all(dim=-1)
    cell = (unit * res).to(torch.int32).clamp(0, res - 1).to(torch.int64)
    flat = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    return binaries.reshape(-1)[flat] & inside


def first_true(mask, size: int):
    """Ordered indices of the True entries, cut or padded with
    len(mask) to `size`."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).reshape(-1)[:size]
    if idx.shape[0] < size:
        idx = torch.cat([idx, torch.full((size - idx.shape[0],), n,
                                         dtype=idx.dtype,
                                         device=idx.device)])
    return idx


@dataclasses.dataclass
class Packed:
    """A ray-sorted sample buffer of fixed length; padding has ray index
    n_rays and valid False."""

    ray: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    valid: torch.Tensor


def march_single(binaries, aabb, origins, viewdirs, t_min, t_max,
                 dt: float, steps: int, budget: int) -> Packed:
    """Uniform steps t_min + i dt whose midpoint cell is occupied."""
    n_rays = origins.shape[0]
    i = torch.arange(steps + 1, dtype=torch.float32,
                     device=origins.device)[None, :]
    knots = t_min[:, None] + i * dt
    t0, t1 = knots[:, :-1], knots[:, 1:]
    t_mid = (t0 + t1) * 0.5
    pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
    mask = ((t_mid < t_max[:, None]) & occupied(binaries, aabb, pos)) \
        .reshape(-1)
    sel = first_true(mask, budget)
    pad = sel >= mask.shape[0]
    safe = torch.where(pad, 0, sel)
    return Packed(
        ray=torch.where(pad, n_rays, safe // steps),
        t0=torch.where(pad, 0.0, t0.reshape(-1)[safe]),
        t1=torch.where(pad, 0.0, t1.reshape(-1)[safe]),
        valid=~pad)


def coarse_binaries(binaries, cf: int, dil: int):
    res = binaries.shape[0]
    rc = res // cf
    coarse = binaries.reshape(rc, cf, rc, cf, rc, cf) \
        .any(dim=5).any(dim=3).any(dim=1)
    out = F.max_pool3d(coarse.to(torch.float32)[None, None],
                       kernel_size=2 * dil + 1, stride=1, padding=dil)
    return out[0, 0] > 0.0


def max_march_steps(aabb, dt: float) -> int:
    """Uniform steps along the box's diagonal."""
    aabb = np.asarray(aabb, np.float32).astype(np.float64)
    return int(np.ceil(float(np.linalg.norm(aabb[3:] - aabb[:3])) / dt)) + 1


def coarse_stride_dilation(aabb, resolution: int, cf: int, dt: float):
    """The trainer's automatic stride (one coarse cell of steps) and
    the dilation that keeps the probe a superset of the fine march."""
    aabb = np.asarray(aabb, np.float32)
    rc = max(resolution // cf, 1)
    ext = float(np.min(aabb[3:] - aabb[:3]))
    stride = max(cf, int(ext / rc / dt))
    cell = float((aabb[3:] - aabb[:3]).min()) / rc
    return stride, max(1, int(np.ceil(stride * dt / cell - 1e-6)))


def march_two_level(binaries, aabb, origins, viewdirs, t_min, t_max,
                    m: March) -> Packed:
    """The coarse probe every stride * dt over the dilated coarse grid,
    then the stride fine steps of each probe that hit."""
    n_rays, dev, dt = origins.shape[0], origins.device, m.step
    cf, stride, dil = m.coarse_factor, m.coarse_stride, m.coarse_dilation
    hits_budget = max(m.budget * cf // stride, 1024)
    n_coarse = -(-m.max_steps // stride)
    steps_c = torch.arange(n_coarse, dtype=torch.float32, device=dev)
    mid = t_min[:, None] + (steps_c[None, :] + 0.5) * (stride * dt)
    mid = torch.minimum(mid, t_max[:, None] - 0.25 * dt)
    in_span = t_min[:, None] + steps_c[None, :] * (stride * dt) \
        < t_max[:, None]
    pos_c = origins[:, None, :] + viewdirs[:, None, :] * mid[..., None]
    hit_c = (in_span & occupied(coarse_binaries(binaries, cf, dil), aabb,
                                pos_c)).reshape(-1)
    sel_c = first_true(hit_c, hits_budget)
    pad_c = sel_c >= hit_c.shape[0]
    safe_c = torch.where(pad_c, 0, sel_c)
    ray_c, step_c = safe_c // n_coarse, safe_c % n_coarse

    ks = torch.arange(stride, dtype=torch.float32, device=dev)
    fine = step_c[:, None].to(torch.float32) * stride + ks[None, :]
    ts = t_min[ray_c][:, None] + fine * dt
    tm = ts + 0.5 * dt
    pos = origins[ray_c][:, None, :] + viewdirs[ray_c][:, None, :] \
        * tm[..., None]
    mask = (occupied(binaries, aabb, pos) & (tm < t_max[ray_c][:, None])
            & (~pad_c)[:, None]).reshape(-1)
    sel = first_true(mask, m.budget)
    pad = sel >= mask.shape[0]
    safe = torch.where(pad, 0, sel)
    ci, ki = safe // stride, (safe % stride).to(torch.float32)
    ray = ray_c[ci]
    t0 = t_min[ray] + (step_c[ci].to(torch.float32) * stride + ki) * dt
    return Packed(ray=torch.where(pad, n_rays, ray),
                  t0=torch.where(pad, 0.0, t0),
                  t1=torch.where(pad, 0.0, t0 + dt),
                  valid=~pad)


def segment_starts(ray):
    first = torch.ones((1,), dtype=torch.bool, device=ray.device)
    return torch.cat([first, ray[1:] != ray[:-1]])


def segmented_cumsum(x, starts):
    """Inclusive per-segment sum by doubling (no global cumsum, which
    cancels at millions of samples)."""
    v, f, d, n = x, starts, 1, x.shape[0]
    while d < n:
        prev_v = torch.cat([torch.zeros((d,), dtype=v.dtype,
                                        device=v.device), v[:-d]])
        prev_f = torch.cat([torch.ones((d,), dtype=torch.bool,
                                       device=f.device), f[:-d]])
        v = torch.where(f, v, prev_v + v)
        f = f | prev_f
        d *= 2
    return v


def weights_of(t0, t1, sigmas, starts):
    """(w, T, alpha): T_i = exp(-sum_{j<i} sigma_j dt_j) per ray."""
    sdt = sigmas * (t1 - t0)
    alphas = 1.0 - torch.exp(-sdt)
    trans = torch.exp(-(segmented_cumsum(sdt, starts) - sdt))
    return trans * alphas, trans, alphas


def ray_sums(ray, vals, n_rays: int):
    out = torch.zeros((n_rays + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out = out.index_add(0, ray.to(torch.int64).clamp(0, n_rays), vals)
    return out[:n_rays]


def positions(s: Packed, origins, viewdirs):
    n_rays = origins.shape[0]
    idx = s.ray.clamp(0, n_rays - 1).to(torch.int64)
    t_mid = (s.t0 + s.t1)[:, None] / 2.0
    return origins[idx] + viewdirs[idx] * t_mid, idx


def render_train(field: Field, params, aabb, binaries, origins, viewdirs,
                 t_jitter, bkgd, m: March):
    """The training step's render: the stratified two-level march, the
    field at every sample of the buffer, the composite on a background.
    Returns (rgb [n, 3], opacity [n])."""
    n_rays = origins.shape[0]
    t_min, t_max, _ = aabb_span(origins, viewdirs, aabb)
    t_min = t_min + t_jitter * m.step
    s = march_two_level(binaries, aabb, origins, viewdirs, t_min, t_max, m)
    pos, _ = positions(s, origins, viewdirs)
    rgbs, sigmas = field.forward(params, pos, aabb)
    sigmas = torch.where(s.valid, sigmas[..., 0], 0.0)
    w, trans, _ = weights_of(s.t0, s.t1, sigmas, segment_starts(s.ray))
    w = torch.where((trans >= m.early_stop_eps) & s.valid, w, 0.0)
    t_mid = (s.t0 + s.t1) / 2.0
    vals = torch.cat([w[:, None] * rgbs, w[:, None],
                      (w * t_mid)[:, None]], dim=1)
    acc = ray_sums(s.ray, vals, n_rays)
    opacity = acc[:, 3]
    rgb = acc[:, 0:3] + bkgd * (1.0 - opacity[:, None])
    return rgb, opacity


@torch.no_grad()
def render_eval(field: Field, params, aabb, binaries, origins, viewdirs,
                m: March, window_steps: int, max_windows: int = 64):
    """The evaluation's alive-ray renderer on a white background: each
    window marches `window_steps` steps from the last window's far
    knot, composites with the carried transmittance and retires rays
    that are opaque or past the box. Returns (rgb [n, 3], samples),
    samples counting the valid samples of alive rays."""
    n_rays, dev, dt = origins.shape[0], origins.device, m.step
    budget = n_rays * window_steps
    t_entry, t_max_box, _ = aabb_span(origins, viewdirs, aabb)
    near = t_entry
    rgb = torch.zeros((n_rays, 3), device=dev)
    opacity = torch.zeros((n_rays,), device=dev)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    steps_i = torch.arange(window_steps + 1, dtype=torch.float32,
                           device=dev)
    total = 0
    for _ in range(max_windows):
        far = (near[:, None] + steps_i[None, :] * dt)[:, -1]
        s = march_single(binaries, aabb, origins, viewdirs,
                         torch.maximum(t_entry, near),
                         torch.minimum(t_max_box, far), dt, window_steps,
                         budget)
        pos, idx = positions(s, origins, viewdirs)
        live = s.valid & alive[idx]
        keep = torch.nonzero(live).reshape(-1)
        sig = torch.zeros_like(s.t0)
        col = torch.zeros((s.t0.shape[0], 3), device=dev)
        if keep.numel():
            c, d = field.forward(params, pos[keep], aabb)
            sig[keep] = d[:, 0]
            col[keep] = c
        w, _, _ = weights_of(s.t0, s.t1, sig, segment_starts(s.ray))
        w = torch.where(live, w * (1.0 - opacity[idx]), 0.0)
        acc = ray_sums(s.ray, torch.cat([w[:, None] * col, w[:, None]],
                                        dim=1), n_rays)
        rgb = rgb + acc[:, 0:3]
        opacity = opacity + acc[:, 3]
        total += int(live.sum())
        alive = (opacity <= 1.0 - m.early_stop_eps) & (far < t_max_box)
        near = far
        if not bool(alive.any()):
            break
    return rgb + (1.0 - opacity[:, None]), total


OCC_PARTITIONS, OCC_WARMUP_STEPS, OCC_INTERVAL, OCC_DECAY = 4, 256, 16, 0.95


@torch.no_grad()
def occupancy_refresh(field: Field, params, aabb, occs, jitter,
                      step_size: float, step: int):
    """The refresh at update `step` of the EMA densities occs [res^3]:
    during the warm-up every partition of the flat grid, after it one
    partition in rotation, is evaluated at one jittered point a cell
    (jitter [res^3 / partitions, 3], the same for every partition);
    occs <- max(decay * occs, density * step_size) there. Returns the
    new occs."""
    n_cells = occs.shape[0]
    resolution = round(n_cells ** (1.0 / 3.0))
    part = n_cells // OCC_PARTITIONS
    parts = (range(OCC_PARTITIONS) if step < OCC_WARMUP_STEPS
             else [(step // OCC_INTERVAL) % OCC_PARTITIONS])
    new = occs.clone()
    for p in parts:
        idx = torch.arange(p * part, (p + 1) * part, device=jitter.device)
        iz = idx // (resolution * resolution)
        iy = (idx // resolution) % resolution
        ix = idx % resolution
        unit = (torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
                + jitter) / resolution
        x = aabb[:3] + unit * (aabb[3:] - aabb[:3])
        density = field.density(params, x, aabb)[..., 0] * step_size
        new[p * part:(p + 1) * part] = torch.maximum(
            occs[p * part:(p + 1) * part] * OCC_DECAY, density)
    return new
