"""Packed volume-rendering math as segmented scans.

Port of quadraturefields_tpu/ops/scan.py. The packed layout is the JAX
package's: a flat ray-sorted sample buffer whose padding carries
ray_index == n_rays and sigma == 0. Scans are segmented (Hillis-Steele,
log2(S) doubling steps that reset at segment starts), so a ray's prefix
sums only its own samples: no f32 global cumsum minus per-ray offsets,
which cancels catastrophically at millions of samples. Per-ray sums go
through the presorted segment sum (a CUDA kernel on the card).
"""
from __future__ import annotations

import torch

from .hashgrid_sorted import presorted_row_segment_sum


def mark_pack_boundaries(ray_indices: torch.Tensor) -> torch.Tensor:
    """True at the first sample of each ray segment."""
    first = torch.ones((1,), dtype=torch.bool, device=ray_indices.device)
    return torch.cat([first, ray_indices[1:] != ray_indices[:-1]])


def _segmented_inclusive_scan(x, boundaries, op, identity: float):
    """Inclusive scan of x under `op` that restarts at every boundary:
    the segment-reset combinator of the JAX package's associative scan,
    evaluated by doubling."""
    v = x
    f = boundaries
    n = x.shape[0]
    d = 1
    while d < n:
        prev_v = torch.cat([torch.full((d,), identity, dtype=v.dtype,
                                       device=v.device), v[:-d]])
        prev_f = torch.cat([torch.ones((d,), dtype=torch.bool,
                                       device=f.device), f[:-d]])
        v = torch.where(f, v, op(prev_v, v))
        f = f | prev_f
        d *= 2
    return v


def inclusive_sum(x, boundaries):
    return _segmented_inclusive_scan(x, boundaries, torch.add, 0.0)


def exclusive_sum(x, boundaries):
    """Segmented exclusive sum (nerfacc.scan.exclusive_sum)."""
    return inclusive_sum(x, boundaries) - x


def exclusive_prod(x, boundaries):
    """Segmented exclusive product, as a shifted inclusive product with
    per-segment reset (exact at x == 0)."""
    inc = _segmented_inclusive_scan(x, boundaries, torch.mul, 1.0)
    shifted = torch.cat([torch.ones_like(inc[:1]), inc[:-1]])
    return torch.where(boundaries, torch.ones_like(x), shifted)


def render_transmittance_from_alpha(alphas, boundaries):
    """T_i = prod_{j<i} (1 - alpha_j) within each ray segment."""
    return exclusive_prod(1.0 - alphas, boundaries)


def render_transmittance_from_density(t_starts, t_ends, sigmas,
                                      boundaries):
    """T_i = exp(-sum_{j<i} sigma_j dt_j); alphas = 1 - exp(-sigma dt)."""
    sigmas_dt = sigmas * (t_ends - t_starts)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    trans = torch.exp(-exclusive_sum(sigmas_dt, boundaries))
    return trans, alphas


def render_weight_from_alpha(alphas, boundaries):
    """w_i = T_i * alpha_i."""
    trans = render_transmittance_from_alpha(alphas, boundaries)
    return trans * alphas, trans


def render_weight_from_density(t_starts, t_ends, sigmas, boundaries):
    """w_i = T_i * (1 - exp(-sigma_i dt_i)); returns (w, T, alpha)."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, boundaries
    )
    return trans * alphas, trans, alphas


def accumulate_along_rays(weights, ray_indices, values=None, n_rays=None):
    """Per-ray sum of weighted values; padding (ray index == n_rays) is
    dropped."""
    if values is None:
        src = weights[..., None]
    else:
        src = weights[..., None] * values
    return presorted_row_segment_sum(
        ray_indices, src.to(torch.float32).contiguous(), n_rays
    )
