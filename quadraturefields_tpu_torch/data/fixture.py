"""Procedural fixture scene: an analytic emissive volume + renderer.

The repo environment ships no NeRF-synthetic data, so tests and the
benchmark use a procedurally generated scene with a *numpy* analytic
volumetric renderer as ground truth (independent of the JAX render
path, so end-to-end tests cross-check the whole stack). The scene is a
soft-edged colored sphere (density falls off at the boundary; color
varies smoothly with position), which a hash-grid NGP fits in a few
hundred steps.

write_fixture_dataset() emits the exact NeRF-synthetic file contract
(transforms_{split}.json + PNG RGBA) so the SubjectLoader, trainers and
eval paths run unmodified against it.
"""
from __future__ import annotations

import json
import os

import numpy as np


class FixtureScene:
    """Analytic density/color volume in the [-1.5, 1.5]^3 box."""

    def __init__(self, radius=0.5, density=40.0, edge=0.05):
        self.radius = radius
        self.density = density
        self.edge = edge
        self.aabb = np.array([-1.5] * 3 + [1.5] * 3, np.float32)

    def sigma(self, x):
        r = np.linalg.norm(x, axis=-1)
        # smooth shell falloff (argument clipped to avoid exp overflow)
        z = np.clip((r - self.radius) / self.edge, -60.0, 60.0)
        return self.density * (1.0 / (1.0 + np.exp(z)))

    def color(self, x):
        # smooth position-dependent color in [0.1, 0.9]
        return 0.5 + 0.4 * np.sin(
            3.0 * x + np.array([0.0, 2.1, 4.2], x.dtype)
        )

    def render_rays(self, origins, viewdirs, step=5e-3, bkgd=1.0):
        """Brute-force numpy volumetric render (ground truth)."""
        t_near, t_far = _aabb_span(origins, viewdirs, self.aabb)
        n_steps = int(np.ceil((t_far.max() - 0.0) / step)) + 1
        n_steps = min(n_steps, 2048)
        ts = t_near[:, None] + (np.arange(n_steps) + 0.5)[None, :] * step
        valid = ts < t_far[:, None]
        pos = (
            origins[:, None, :] + viewdirs[:, None, :] * ts[..., None]
        )
        sig = self.sigma(pos) * valid
        rgb = self.color(pos)
        tau = sig * step
        trans = np.exp(-np.cumsum(tau, axis=1) + tau)
        alpha = 1.0 - np.exp(-tau)
        w = trans * alpha
        color = (w[..., None] * rgb).sum(1)
        opacity = w.sum(1, keepdims=True)
        return color + bkgd * (1.0 - opacity), opacity


def _aabb_span(origins, viewdirs, aabb):
    inv = 1.0 / np.where(np.abs(viewdirs) < 1e-10, 1e-10, viewdirs)
    t0 = (aabb[:3] - origins) * inv
    t1 = (aabb[3:] - origins) * inv
    t_min = np.maximum(np.minimum(t0, t1).max(-1), 0.0)
    t_max = np.maximum(np.maximum(t0, t1).min(-1), 0.0)
    return t_min, np.maximum(t_max, t_min)


def _look_at_poses(n_views, distance=4.0, seed=0):
    """Cameras on a sphere looking at the origin (OpenGL convention:
    camera looks down -z)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views + rng.uniform(0, 0.1)
        phi = np.pi / 2 - rng.uniform(0.2, 1.0)
        eye = distance * np.array(
            [
                np.cos(theta) * np.sin(phi),
                np.sin(theta) * np.sin(phi),
                np.cos(phi),
            ]
        )
        fwd = -eye / np.linalg.norm(eye)  # toward origin
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = true_up
        c2w[:3, 2] = -fwd  # OpenGL: -z is view dir
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def make_fixture_scene(**kw) -> FixtureScene:
    return FixtureScene(**kw)


def render_fixture_view(scene, c2w, res, focal, step=5e-3,
                        chunk: int = 4096):
    x, y = np.meshgrid(
        np.arange(res, dtype=np.float32),
        np.arange(res, dtype=np.float32),
        indexing="xy",
    )
    cx = cy = res / 2.0
    dirs_cam = np.stack(
        [
            (x - cx + 0.5) / focal,
            -(y - cy + 0.5) / focal,
            -np.ones_like(x),
        ],
        axis=-1,
    ).reshape(-1, 3)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape).astype(np.float32)
    # chunked: the full-view [rays, steps, 3] intermediates reach
    # ~6 GB at res 200 and thrash the throttled single-core host
    rgbs, ops = [], []
    dirs = dirs.astype(np.float32)
    for i in range(0, dirs.shape[0], chunk):
        rgb, opacity = scene.render_rays(
            origins[i:i + chunk], dirs[i:i + chunk], step=step
        )
        rgbs.append(rgb)
        ops.append(opacity)
    return (
        np.concatenate(rgbs).reshape(res, res, 3),
        np.concatenate(ops).reshape(res, res, 1),
    )


def write_fixture_dataset(
    root: str,
    subject_id: str = "fixture",
    res: int = 64,
    n_train: int = 12,
    n_test: int = 3,
    fov_deg: float = 50.0,
    scene: FixtureScene | None = None,
):
    """Emit a NeRF-synthetic-format dataset from the analytic scene."""
    import imageio.v2 as imageio

    scene = scene or FixtureScene()
    focal = 0.5 * res / np.tan(0.5 * np.deg2rad(fov_deg))
    camera_angle_x = 2.0 * np.arctan(0.5 * res / focal)
    data_dir = os.path.join(root, subject_id)
    os.makedirs(data_dir, exist_ok=True)
    for split, n_views, seed in (
        ("train", n_train, 0),
        ("val", max(1, n_test), 1),
        ("test", n_test, 2),
    ):
        poses = _look_at_poses(n_views, seed=seed)
        frames = []
        os.makedirs(os.path.join(data_dir, split), exist_ok=True)
        for i, c2w in enumerate(poses):
            rgb, opacity = render_fixture_view(scene, c2w, res, focal)
            rgba = np.concatenate(
                [np.clip(rgb, 0, 1), np.clip(opacity, 0, 1)], axis=-1
            )
            # stored images are premultiplied against black so that
            # pixel*alpha + bkgd*(1-alpha) reconstructs the render
            rgba[..., :3] = np.where(
                rgba[..., 3:] > 1e-6,
                np.clip(
                    (rgb - (1.0 - opacity)) / np.maximum(opacity, 1e-6),
                    0.0,
                    1.0,
                ),
                0.0,
            )
            fname = f"{split}/r_{i}"
            imageio.imwrite(
                os.path.join(data_dir, fname + ".png"),
                (rgba * 255).astype(np.uint8),
            )
            frames.append(
                {
                    "file_path": fname,
                    "transform_matrix": c2w.tolist(),
                }
            )
        with open(
            os.path.join(data_dir, f"transforms_{split}.json"), "w"
        ) as f:
            json.dump(
                {"camera_angle_x": float(camera_angle_x), "frames": frames},
                f,
            )
    return data_dir
