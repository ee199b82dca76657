"""Spiral novel-view generator with ray-traced mesh hits.

A copy of quadraturefields_tpu/data/own_views.py (numpy only).

Parity with reference SubjectLoaderOwnViews
(nerf_synthetic.py:381-427): cameras on a z-elevated circle looking at
the origin, used for visibility baking of texels not seen from the
train set. Rays come from a simple pinhole (fov 60 like the trimesh
scene camera); hits from the in-house BVH.
"""
from __future__ import annotations

import numpy as np

from .nerf_synthetic import Rays


def spiral_positions(scale: float = 1.0, n: int = 100, z: float = 0.01):
    """Reference spiral() (nerf_synthetic.py:23-29)."""
    u = np.linspace(0.01, 2 * np.pi - 0.01, n)
    pts = np.stack(
        [np.sin(u), np.cos(u), np.full_like(u, z)], axis=1
    )
    return pts * scale


def look_at_pose(eye, target=None, up=None):
    """OpenGL c2w looking from eye at target (reference
    create_uniform_camera_poses via pyrr look_at,
    nerf_synthetic.py:32-42)."""
    target = np.zeros(3) if target is None else target
    up = np.array([0.0, 0.0, 1.0]) if up is None else up
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def create_uniform_camera_poses(distance: float = 2.0, n: int = 100,
                                z: float = 0.01):
    pts = spiral_positions(distance, n=n, z=z)
    return np.stack([look_at_pose(p) for p in pts])


class SubjectLoaderOwnViews:
    """Spiral views + dense ray grids + (optional) precomputed mesh
    hits in the [R, max_hits] row layout."""

    def __init__(self, resolution: int = 2000, mesh_intersect=None,
                 camera_scale: float = 2.0, fov_deg: float = 60.0,
                 n_views: int = 100, z: float = 0.01):
        self.mesh_intersect = mesh_intersect
        self.camera_poses = create_uniform_camera_poses(
            camera_scale, n=n_views, z=z
        )
        self.resolution = resolution
        self.WIDTH = self.HEIGHT = resolution
        self.focal = 0.5 * resolution / np.tan(0.5 * np.deg2rad(fov_deg))

    def __len__(self):
        return self.camera_poses.shape[0]

    def rays_for_view(self, index: int) -> Rays:
        c2w = self.camera_poses[index % len(self)]
        res = self.resolution
        x, y = np.meshgrid(
            np.arange(res, dtype=np.float32),
            np.arange(res, dtype=np.float32),
            indexing="xy",
        )
        cx = cy = res / 2.0
        dirs_cam = np.stack(
            [
                (x - cx + 0.5) / self.focal,
                -(y - cy + 0.5) / self.focal,
                -np.ones_like(x),
            ],
            axis=-1,
        ).reshape(-1, 3)
        dirs = dirs_cam @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(c2w[:3, 3], dirs.shape).astype(np.float32)
        return Rays(origins=origins, viewdirs=dirs.astype(np.float32))

    def __getitem__(self, index: int):
        rays = self.rays_for_view(index)
        data = {"rays": rays}
        if self.mesh_intersect is not None:
            tri_ids, ts, valid = self.mesh_intersect.intersect_rows(
                rays.origins, rays.viewdirs
            )
            data["hits"] = (tri_ids, ts, valid)
        return data


def spiral_prune_rings(distance: float = 4.0, n_per_ring: int = 10,
                       z_fracs=(0.1, 0.45, 0.8), resolution: int = 200,
                       fov_deg: float = 60.0):
    """Spiral-ring view set for prune-coverage augmentation.

    Mesh pruning keeps faces whose max render weight over the sweep
    views exceeds the threshold; with a sparse train split, faces the
    test views see but no train view ever hits are deleted as
    "invisible" regardless of threshold (measured: 6.7 dB of baked
    PSNR on the 12-view prod fixture, PERF_NOTES.md). The reference's
    own knob for this is densifying the sweep split
    (prune_mesh_after_finetuning.py:62-66 `--train_split trainval`);
    these rings are the split-independent analog, built from the
    reference's spiral visibility cameras (nerf_synthetic.py:381-427).
    Pruning needs only rays — no GT images — so the sweep can be
    arbitrarily dense.

    Each ring sits at the train-camera distance (elevation fraction
    z_frac = sin of the elevation angle), so the union covers the
    orbit band NeRF-synthetic-style test cameras are drawn from.
    """
    rings = []
    for zf in z_fracs:
        scale = distance / float(np.sqrt(1.0 + zf * zf))
        rings.append(SubjectLoaderOwnViews(
            resolution=resolution, camera_scale=scale, fov_deg=fov_deg,
            n_views=n_per_ring, z=zf,
        ))
    return rings
