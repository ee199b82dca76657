"""NeRF-synthetic (Blender JSON) data loader.

Capability-parity with the reference loader
(examples/datasets/nerf_synthetic.py:138-378): transforms_{split}.json +
per-frame PNG RGBA, OpenGL camera convention, white/black/random
background compositing against the alpha channel, train-time random
pixel batches across all images, eval-time full-resolution ray grids,
and the `upsample` super-sampling mode used by stage 4. Shelly scenes
load through this class with a different data root (reference
script/run_shelly.sh:4-6).

Host-side: all arrays are numpy; trainers move batches to device with a
prefetch iterator. Ray generation is vectorized numpy (no per-pixel
loops), which is plenty for feeding a TPU given batches are generated
once per step.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np


class Rays(NamedTuple):
    origins: np.ndarray
    viewdirs: np.ndarray


def _load_renderings(root_fp: str, subject_id: str, split: str):
    """Reference _load_renderings (nerf_synthetic.py:67-104)."""
    import imageio.v2 as imageio

    data_dir = os.path.join(root_fp, subject_id)
    with open(
        os.path.join(data_dir, f"transforms_{split}.json"), "r"
    ) as fp:
        meta = json.load(fp)
    images, camtoworlds = [], []
    for frame in meta["frames"]:
        fname = os.path.join(data_dir, frame["file_path"] + ".png")
        if not os.path.exists(fname):
            fname = os.path.join(data_dir, frame["file_path"])
        images.append(imageio.imread(fname))
        camtoworlds.append(frame["transform_matrix"])
    images = np.stack(images, axis=0)
    camtoworlds = np.stack(camtoworlds, axis=0).astype(np.float32)
    h, w = images.shape[1:3]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    return images, camtoworlds, focal


class SubjectLoader:
    """Single-subject loader for training and evaluation."""

    SPLITS = ["train", "val", "trainval", "test"]
    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        near: Optional[float] = None,
        far: Optional[float] = None,
        batch_over_images: bool = True,
        mesh_intersect=None,
        upsample: int = 1,
        seed: int = 42,
    ):
        assert color_bkgd_aug in ["white", "black", "random"]
        self.upsample = int(upsample)
        self.split = split
        self.num_rays = num_rays
        self.near = self.NEAR if near is None else near
        self.far = self.FAR if far is None else far
        self.training = (num_rays is not None) and split in (
            "train",
            "trainval",
        )
        self.color_bkgd_aug = color_bkgd_aug
        self.batch_over_images = batch_over_images
        self.mesh_intersect = mesh_intersect
        self.rng = np.random.default_rng(seed)

        if split == "trainval":
            img_t, c2w_t, focal = _load_renderings(root_fp, subject_id, "train")
            img_v, c2w_v, _ = _load_renderings(root_fp, subject_id, "val")
            self.images = np.concatenate([img_t, img_v])
            self.camtoworlds = np.concatenate([c2w_t, c2w_v])
            self.focal = focal
        else:
            load_split = split if split in ("train", "test") else "train"
            self.images, self.camtoworlds, self.focal = _load_renderings(
                root_fp, subject_id, load_split
            )
        self.focal = self.focal * self.upsample
        self.images = self.images.astype(np.uint8)
        h, w = self.images.shape[1:3]
        self.WIDTH, self.HEIGHT = w * self.upsample, h * self.upsample
        self.K = np.array(
            [
                [self.focal, 0, self.WIDTH / 2.0],
                [0, self.focal, self.HEIGHT / 2.0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int):
        """Dynamic ray-batch resizing hook (reference
        nerf_synthetic.py:286-287)."""
        self.num_rays = int(num_rays)

    def _rays_from_pixels(self, image_id, x, y):
        """OpenGL-convention ray generation
        (reference nerf_synthetic.py:341-360)."""
        c2w = self.camtoworlds[image_id]  # [N, 4, 4]
        sign = -1.0 if self.OPENGL_CAMERA else 1.0
        camera_dirs = np.stack(
            [
                (x - self.K[0, 2] + 0.5) / self.K[0, 0],
                (y - self.K[1, 2] + 0.5) / self.K[1, 1] * sign,
                np.full_like(x, sign, dtype=np.float32),
            ],
            axis=-1,
        ).astype(np.float32)
        directions = np.einsum("nij,nj->ni", c2w[:, :3, :3], camera_dirs)
        origins = np.broadcast_to(
            c2w[:, :3, -1], directions.shape
        ).astype(np.float32)
        viewdirs = directions / np.linalg.norm(
            directions, axis=-1, keepdims=True
        )
        return origins, viewdirs.astype(np.float32)

    def fetch_train_batch(self):
        """Random pixel batch across images -> dict with pixels, rays,
        color_bkgd (reference fetch_data + preprocess)."""
        n = self.num_rays
        if self.batch_over_images:
            image_id = self.rng.integers(0, len(self.images), size=n)
        else:
            image_id = np.full(n, self.rng.integers(0, len(self.images)))
        x = self.rng.integers(0, self.WIDTH, size=n)
        y = self.rng.integers(0, self.HEIGHT, size=n)
        rgba = (
            self.images[
                image_id,
                (y // self.upsample).astype(int),
                (x // self.upsample).astype(int),
            ].astype(np.float32)
            / 255.0
        )
        origins, viewdirs = self._rays_from_pixels(
            image_id, x.astype(np.float32), y.astype(np.float32)
        )
        if self.color_bkgd_aug == "random":
            color_bkgd = self.rng.random(3).astype(np.float32)
        elif self.color_bkgd_aug == "white":
            color_bkgd = np.ones(3, np.float32)
        else:
            color_bkgd = np.zeros(3, np.float32)
        pixels, alpha = rgba[:, :3], rgba[:, 3:]
        pixels = pixels * alpha + color_bkgd * (1.0 - alpha)
        return {
            "pixels": pixels,
            "rays": Rays(origins=origins, viewdirs=viewdirs),
            "color_bkgd": color_bkgd,
        }

    def fetch_eval_view(self, index: int):
        """Full ray grid for one view; white background."""
        index = index % len(self.images)
        x, y = np.meshgrid(
            np.arange(self.WIDTH, dtype=np.float32),
            np.arange(self.HEIGHT, dtype=np.float32),
            indexing="xy",
        )
        x, y = x.reshape(-1), y.reshape(-1)
        image_id = np.full(x.shape[0], index)
        origins, viewdirs = self._rays_from_pixels(image_id, x, y)
        rgba = self.images[index].astype(np.float32) / 255.0
        color_bkgd = np.ones(3, np.float32)
        pixels = rgba[..., :3] * rgba[..., 3:] + color_bkgd * (
            1.0 - rgba[..., 3:]
        )
        return {
            "pixels": pixels.reshape(-1, 3),
            "rays": Rays(origins=origins, viewdirs=viewdirs),
            "color_bkgd": color_bkgd,
        }

    # torch-Dataset-style alias used by reference trainers
    def __getitem__(self, index: int):
        if self.training:
            return self.fetch_train_batch()
        return self.fetch_eval_view(index)
