"""The procedural fixture scene and its views, the benchmark's traffic
data.

A frozen copy of `quadraturefields_tpu_torch/data/fixture.py`
(`FixtureScene`, `_look_at_poses`, the analytic render) and of
`chip_smoke.py`'s `FixtureViews` (the NeRF-synthetic loader's
interface: pixels drawn across all views with a seeded numpy
generator, as `SubjectLoader` draws them). The analytic render runs in
torch on the benchmark's device, in chunks, so that set-up makes the
target pixels in well under a second.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


class Rays(NamedTuple):
    origins: np.ndarray
    viewdirs: np.ndarray


class FixtureScene:
    """A soft-edged coloured sphere of radius 0.5 in the [-1.5, 1.5]^3
    box: density 40 / (1 + exp((r - 0.5) / 0.05)), colour
    0.5 + 0.4 sin(3x + (0, 2.1, 4.2))."""

    radius, density, edge = 0.5, 40.0, 0.05

    def sigma(self, x):
        r = torch.linalg.vector_norm(x, dim=-1)
        z = ((r - self.radius) / self.edge).clamp(-60.0, 60.0)
        return self.density / (1.0 + torch.exp(z))

    def color(self, x):
        phase = torch.tensor([0.0, 2.1, 4.2], dtype=x.dtype, device=x.device)
        return 0.5 + 0.4 * torch.sin(3.0 * x + phase)

    def render_rays(self, origins, viewdirs, step: float):
        """Brute-force volumetric render on a white background."""
        aabb = torch.tensor(AABB, dtype=origins.dtype, device=origins.device)
        inv = 1.0 / torch.where(viewdirs.abs() < 1e-10,
                                torch.full_like(viewdirs, 1e-10), viewdirs)
        t0 = (aabb[:3] - origins) * inv
        t1 = (aabb[3:] - origins) * inv
        t_near = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
        t_far = torch.maximum(torch.maximum(t0, t1).amin(-1).clamp_min(0.0),
                              t_near)
        n_steps = min(int(np.ceil(float(t_far.max()) / step)) + 1, 2048)
        ts = t_near[:, None] + (torch.arange(
            n_steps, dtype=origins.dtype, device=origins.device)
            + 0.5)[None, :] * step
        pos = origins[:, None, :] + viewdirs[:, None, :] * ts[..., None]
        tau = self.sigma(pos) * (ts < t_far[:, None]) * step
        trans = torch.exp(-torch.cumsum(tau, dim=1) + tau)
        w = trans * (1.0 - torch.exp(-tau))
        color = (w[..., None] * self.color(pos)).sum(1)
        return color + (1.0 - w.sum(1, keepdim=True))


def look_at_poses(n_views: int, distance: float = 4.0, seed: int = 2):
    """Cameras on a sphere looking at the origin (OpenGL convention)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views + rng.uniform(0, 0.1)
        phi = np.pi / 2 - rng.uniform(0.2, 1.0)
        eye = distance * np.array([np.cos(theta) * np.sin(phi),
                                   np.sin(theta) * np.sin(phi),
                                   np.cos(phi)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = np.cross(right, fwd)
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def camera_rays(c2w, res: int, focal: float):
    x, y = np.meshgrid(np.arange(res, dtype=np.float32),
                       np.arange(res, dtype=np.float32), indexing="xy")
    dirs_cam = np.stack([(x - res / 2.0 + 0.5) / focal,
                         -(y - res / 2.0 + 0.5) / focal,
                         -np.ones_like(x)], axis=-1).reshape(-1, 3)
    d = dirs_cam @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return o.astype(np.float32), d.astype(np.float32)


class FixtureViews:
    """Fixture views with the NeRF-synthetic loader's eval interface
    (HEIGHT, WIDTH, len, fetch_eval_view) and training interface
    (num_rays, update_num_rays, fetch_train_batch). `pixel_step` > 0
    renders the target pixels on `device`; 0 leaves them out (render
    traffic). While `recorded` holds fewer than `record` batches, each
    training batch drawn is kept there: the inputs the reference
    replays."""

    def __init__(self, n_views: int, res: int, fov_deg: float,
                 pose_seed: int, num_rays: int, seed: int,
                 pixel_step: float, device):
        self.res = self.HEIGHT = self.WIDTH = res
        focal = 0.5 * res / np.tan(0.5 * np.deg2rad(fov_deg))
        self.poses = look_at_poses(n_views, seed=pose_seed)
        rays = [camera_rays(c2w, res, focal) for c2w in self.poses]
        self._origins = np.stack([o for o, _ in rays])
        self._dirs = np.stack([d for _, d in rays])
        self._pixels = None
        if pixel_step > 0:
            scene, out = FixtureScene(), []
            with torch.no_grad():
                for o, d in zip(self._origins, self._dirs):
                    o_t = torch.as_tensor(o, device=device)
                    d_t = torch.as_tensor(d, device=device)
                    out.append(torch.cat([
                        scene.render_rays(o_t[i:i + 8192], d_t[i:i + 8192],
                                          pixel_step)
                        for i in range(0, o.shape[0], 8192)]))
            self._pixels = torch.stack(out).clamp(0.0, 1.0).cpu().numpy()
        self.num_rays = num_rays
        self.rng = np.random.default_rng(seed)
        self.record, self.recorded = 0, []

    def __len__(self):
        return len(self.poses)

    def fetch_eval_view(self, index):
        i = index % len(self.poses)
        return {"pixels": None if self._pixels is None else self._pixels[i],
                "rays": Rays(self._origins[i], self._dirs[i]),
                "color_bkgd": np.ones(3, np.float32)}

    def update_num_rays(self, num_rays: int):
        self.num_rays = int(num_rays)

    def fetch_train_batch(self):
        n = self.num_rays
        image_id = self.rng.integers(0, len(self.poses), size=n)
        x = self.rng.integers(0, self.WIDTH, size=n)
        y = self.rng.integers(0, self.HEIGHT, size=n)
        ray = y * self.WIDTH + x
        batch = {"pixels": self._pixels[image_id, ray],
                 "rays": Rays(self._origins[image_id, ray],
                              self._dirs[image_id, ray]),
                 "color_bkgd": np.ones(3, np.float32)}
        if len(self.recorded) < self.record:
            self.recorded.append(batch)
        return batch


def occupancy_from_scene(resolution: int, step: float, thre: float,
                         device):
    """The fixture's own occupancy on a res^3 grid over the box:
    density times step at the lattice points linspace(-1.5, 1.5, res),
    occupied above `thre` (chip_smoke.py's `fixture_occupancy`).
    Returns (occs [res^3] f32, binaries [res, res, res] bool)."""
    lin = torch.linspace(-1.5, 1.5, resolution, device=device)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = FixtureScene().sigma(grid.reshape(-1, 3)) * step
    return occs, (occs > thre).reshape(resolution, resolution, resolution)
