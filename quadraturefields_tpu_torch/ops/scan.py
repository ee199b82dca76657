"""Packed volume-rendering math as segmented scans.

Port of quadraturefields_tpu/ops/scan.py. The packed layout is the JAX
package's: a flat ray-sorted sample buffer whose padding carries
ray_index == n_rays and sigma == 0. Scans are segmented (Hillis-Steele,
log2(S) doubling steps that reset at segment starts), so a ray's prefix
sums only its own samples: no f32 global cumsum minus per-ray offsets,
which cancels catastrophically at millions of samples. Autograd
differentiates the scans. Per-ray sums go through the presorted segment
sum (a CUDA kernel on the card) and its gather VJP. `reverse_weights`
(stage 2) flips the packed buffer and scans it again, as the JAX
package does, so its rounding follows JAX's on padded buffers too.
"""
from __future__ import annotations

import torch

from .hashgrid_sorted import presorted_row_segment_sum_vjp


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


def render_visibility_from_density(t_starts, t_ends, sigmas, boundaries,
                                   early_stop_eps=1e-4, alpha_thre=0.0):
    """Visible iff trans >= early_stop_eps and alpha >= alpha_thre."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, boundaries
    )
    vis = trans >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (alphas >= alpha_thre)
    return vis


def accumulate_along_rays(weights, ray_indices, values=None, n_rays=None):
    """Per-ray sum of weighted values; padding (ray index == n_rays) is
    dropped. Differentiable in weights and values."""
    if values is None:
        src = weights[..., None]
    else:
        src = weights[..., None] * values
    return presorted_row_segment_sum_vjp(
        ray_indices, src.to(torch.float32).contiguous(), n_rays
    )


def reverse_weights(t_starts, t_ends, sigmas, ray_indices, n_rays, valid):
    """Rendering weights of each sample with its ray traversed back to
    front: the ray-sorted buffer flipped (each ray's samples stay
    contiguous, reversed), its t mirrored at max(t_starts) +
    max(t_ends) over the whole buffer, padding included, and the same
    segmented scan run again. Padding (valid False) gets sigma 0 before
    the flip, so it stays a no-op. `n_rays` is unused, as in JAX."""
    sigmas = torch.where(valid, sigmas, 0.0)
    max_val = t_starts.max() + t_ends.max()
    ts_f = torch.flip(max_val - t_starts, (0,))
    te_f = torch.flip(max_val - t_ends, (0,))
    sig_f = torch.flip(sigmas, (0,))
    bound_f = mark_pack_boundaries(torch.flip(ray_indices, (0,)))
    w_rev, _, _ = render_weight_from_density(te_f, ts_f, sig_f, bound_f)
    return torch.flip(w_rev, (0,))


def derive_properties(rgbs, sigmas, depths, deltas, ray_indices, n_rays,
                      bg_color="white", render_bkgd=None):
    """Per-ray color, alpha and depth of packed quadrature samples
    (reference examples/utils.py:863-898): depth is the weight-normalized
    expectation; the background is white, black or `render_bkgd`.

    Returns (rgb [n_rays, 3], alpha [n_rays, 1], depth [n_rays, 1],
    weights [S])."""
    boundaries = mark_pack_boundaries(ray_indices)
    tau = sigmas * deltas
    alphas = 1.0 - torch.exp(-tau)
    trans = torch.exp(-exclusive_sum(tau, boundaries))
    weights = trans * alphas

    alpha = accumulate_along_rays(weights, ray_indices, None, n_rays)
    color_sum = accumulate_along_rays(weights, ray_indices, rgbs, n_rays)
    depth_sum = accumulate_along_rays(weights, ray_indices, depths[..., None],
                                      n_rays)
    depth = depth_sum / alpha.clamp_min(1e-10)
    if bg_color == "white":
        rgb = (1.0 - alpha) + color_sum
    elif bg_color == "black":
        rgb = color_sum
    else:
        rgb = color_sum + (1.0 - alpha) * render_bkgd
    return rgb, alpha, depth, weights
