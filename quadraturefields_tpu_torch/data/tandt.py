"""Tanks & Temples (masked) loader.

Parity with reference examples/datasets/tandt_masked.py
(TanksTempleDataset): per-image pose txt files + intrinsics.txt +
rgb/mask image dirs, bbox.txt scene bounds; foreground masked against a
white background. Not used by the shipped pipeline scripts (same as the
reference) but part of the data-layer family.

Expected layout:
  <datadir>/intrinsics.txt      fx fy cx cy (first line: fx 0 cx 0 ...)
  <datadir>/pose/*.txt          4x4 c2w per image
  <datadir>/rgb/*.png           images (train_/test_ prefixes optional)
  <datadir>/bbox.txt            xyz_min xyz_max (6 or 8 numbers)
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from .nerf_synthetic import Rays


class TanksTempleDataset:
    OPENGL_CAMERA = False

    def __init__(
        self,
        datadir: str,
        num_rays: Optional[int] = None,
        split: str = "train",
        downsample: float = 1.0,
        seed: int = 42,
    ):
        import imageio.v2 as imageio

        self.split = split
        self.num_rays = num_rays
        self.training = num_rays is not None and split == "train"
        self.rng = np.random.default_rng(seed)

        with open(os.path.join(datadir, "intrinsics.txt")) as f:
            vals = [float(v) for v in f.readline().split()]
        fx = vals[0] / downsample
        fy = (vals[1] if len(vals) > 1 and vals[1] > 0 else vals[0]) \
            / downsample

        prefix = "train_" if split == "train" else "test_"
        pose_files = sorted(
            glob.glob(os.path.join(datadir, "pose", f"{prefix}*.txt"))
        ) or sorted(glob.glob(os.path.join(datadir, "pose", "*.txt")))
        img_files = sorted(
            glob.glob(os.path.join(datadir, "rgb", f"{prefix}*"))
        ) or sorted(glob.glob(os.path.join(datadir, "rgb", "*")))

        poses, images = [], []
        for pf, imf in zip(pose_files, img_files):
            poses.append(
                np.loadtxt(pf).reshape(4, 4).astype(np.float32)
            )
            img = imageio.imread(imf)
            images.append(img)
        self.camtoworlds = np.stack(poses)
        self.images = np.stack(images).astype(np.uint8)
        h, w = self.images.shape[1:3]
        self.HEIGHT, self.WIDTH = h, w
        self.K = np.array(
            [[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32
        )
        bbox_path = os.path.join(datadir, "bbox.txt")
        if os.path.exists(bbox_path):
            b = np.loadtxt(bbox_path).reshape(-1)[:6]
            self.scene_bbox = b.astype(np.float32)
        else:
            self.scene_bbox = np.array(
                [-1.5] * 3 + [1.5] * 3, np.float32
            )

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int):
        self.num_rays = int(num_rays)

    def _pixels_rgb(self, image_id, x, y):
        rgba = self.images[image_id, y, x].astype(np.float32) / 255.0
        if rgba.shape[-1] == 4:
            rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        else:
            rgb = rgba[..., :3]
        return rgb

    def _rays(self, image_id, x, y):
        c2w = self.camtoworlds[image_id]
        dirs_cam = np.stack(
            [
                (x - self.K[0, 2] + 0.5) / self.K[0, 0],
                (y - self.K[1, 2] + 0.5) / self.K[1, 1],
                np.ones_like(x),
            ],
            axis=-1,
        ).astype(np.float32)
        d = np.einsum("nij,nj->ni", c2w[:, :3, :3], dirs_cam)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:, :3, 3], d.shape).astype(np.float32)
        return o, d.astype(np.float32)

    def fetch_train_batch(self):
        n = self.num_rays
        image_id = self.rng.integers(0, len(self.images), size=n)
        x = self.rng.integers(0, self.WIDTH, size=n)
        y = self.rng.integers(0, self.HEIGHT, size=n)
        o, d = self._rays(image_id, x.astype(np.float32),
                          y.astype(np.float32))
        return {
            "pixels": self._pixels_rgb(image_id, x, y),
            "rays": Rays(origins=o, viewdirs=d),
            "color_bkgd": np.ones(3, np.float32),
        }

    def fetch_eval_view(self, index: int):
        index = index % len(self.images)
        x, y = np.meshgrid(
            np.arange(self.WIDTH), np.arange(self.HEIGHT), indexing="xy"
        )
        x, y = x.reshape(-1), y.reshape(-1)
        image_id = np.full(x.shape[0], index)
        o, d = self._rays(image_id, x.astype(np.float32),
                          y.astype(np.float32))
        return {
            "pixels": self._pixels_rgb(image_id, y=y, x=x).reshape(-1, 3),
            "rays": Rays(origins=o, viewdirs=d),
            "color_bkgd": np.ones(3, np.float32),
        }
