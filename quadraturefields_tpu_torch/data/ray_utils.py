"""Ray helpers (reference examples/datasets/ray_utils.py parity):
camera-space ray directions, world rays, NDC transform, depth/dist
conversions. numpy, host-side."""
from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, focal, center=None):
    """Per-pixel camera-space ray directions (reference
    ray_utils.py:24-45; +0.5 pixel centering omitted there too)."""
    fx, fy = (focal, focal) if np.isscalar(focal) else focal
    cx, cy = center if center is not None else (W / 2, H / 2)
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32) + 0.5,
        np.arange(H, dtype=np.float32) + 0.5,
        indexing="xy",
    )
    return np.stack(
        [(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1
    )


def get_rays(directions, c2w):
    """Camera-space dirs + c2w -> world (origins, dirs), dirs
    normalized."""
    rays_d = directions @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), \
        rays_d.reshape(-1, 3).astype(np.float32)


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Shift rays to the near plane and map to NDC (standard NeRF
    forward-facing parameterization)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = (
        -1.0 / (W / (2.0 * focal))
        * (rays_d[..., 0] / rays_d[..., 2]
           - rays_o[..., 0] / rays_o[..., 2])
    )
    d1 = (
        -1.0 / (H / (2.0 * focal))
        * (rays_d[..., 1] / rays_d[..., 2]
           - rays_o[..., 1] / rays_o[..., 2])
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return (
        np.stack([o0, o1, o2], -1).astype(np.float32),
        np.stack([d0, d1, d2], -1).astype(np.float32),
    )


def depth2dist(z_vals, cos_angle):
    """Per-sample z depths -> inter-sample distances scaled by the ray
    angle (reference ray_utils.py:9-15)."""
    dists = np.diff(z_vals, axis=-1)
    dists = np.concatenate(
        [dists, np.full_like(dists[..., :1], 1e10)], axis=-1
    )
    return dists * cos_angle[..., None]
