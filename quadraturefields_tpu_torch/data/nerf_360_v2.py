"""mip-NeRF-360 (COLMAP) data loader.

Parity with reference examples/datasets/nerf_360_v2.py:327-537: COLMAP
sparse model via the in-house SceneManager, factor-downsampled image
dirs, similarity normalization of the camera set, OpenCV camera
convention, every-8th-image test split.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .colmap import SceneManager, similarity_from_cameras
from .nerf_synthetic import Rays


def _load_colmap(root_fp: str, subject_id: str, factor: int = 1,
                 upsample: int = 1):
    """Reference _load_colmap (nerf_360_v2.py:114-266)."""
    import imageio.v2 as imageio

    assert factor in (1, 2, 4, 8)
    data_dir = os.path.join(root_fp, subject_id)
    manager = SceneManager(os.path.join(data_dir, "sparse/0/"))
    manager.load_cameras()
    manager.load_images()

    cam = manager.cameras[1]
    K = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
        np.float64,
    )
    K[:2, :] /= factor
    K[:2, :] *= upsample

    bottom = np.array([[0, 0, 0, 1.0]])
    w2c = []
    names = []
    for k in manager.images:
        im = manager.images[k]
        w2c.append(
            np.concatenate(
                [np.concatenate([im.R(), im.tvec.reshape(3, 1)], 1), bottom]
            )
        )
        names.append(im.name)
    w2c = np.stack(w2c)
    c2w = np.linalg.inv(w2c)
    inds = np.argsort(names)
    names = [names[i] for i in inds]
    c2w = c2w[inds]

    suffix = f"_{factor}" if factor > 1 else ""
    colmap_image_dir = os.path.join(data_dir, "images")
    image_dir = os.path.join(data_dir, "images" + suffix)
    colmap_files = sorted(os.listdir(colmap_image_dir))
    image_files = sorted(os.listdir(image_dir))
    mapping = dict(zip(colmap_files, image_files))
    images = np.stack(
        [
            imageio.imread(os.path.join(image_dir, mapping[n]))
            for n in names
        ]
    )
    all_indices = np.arange(images.shape[0])
    split_indices = {
        "test": all_indices[all_indices % 8 == 0],
        "train": all_indices[all_indices % 8 != 0],
    }
    return images, c2w.astype(np.float32), K.astype(np.float32), \
        split_indices


class SubjectLoader:
    """360-v2 loader; OpenCV camera (z forward)."""

    SPLITS = ["train", "test"]
    OPENGL_CAMERA = False

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
        factor: int = 1,
        upsample: int = 1,
        seed: int = 42,
    ):
        assert split in self.SPLITS
        assert color_bkgd_aug in ["white", "black", "random"]
        self.split = split
        self.num_rays = num_rays
        self.near = near
        self.far = far
        self.upsample = int(upsample)
        self.training = (num_rays is not None) and split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self.batch_over_images = batch_over_images
        self.rng = np.random.default_rng(seed)

        images, camtoworlds, K, split_indices = _load_colmap(
            root_fp, subject_id, factor, upsample=self.upsample
        )
        T, sscale = similarity_from_cameras(
            camtoworlds, strict_scaling=False
        )
        camtoworlds = np.einsum("nij,ki->nkj", camtoworlds, T)
        camtoworlds[:, :3, 3] *= sscale
        idx = split_indices[split]
        self.images = images[idx].astype(np.uint8)
        self.camtoworlds = camtoworlds[idx].astype(np.float32)
        self.K = K
        h, w = self.images.shape[1:3]
        self.HEIGHT = h * self.upsample
        self.WIDTH = w * self.upsample

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int):
        self.num_rays = int(num_rays)

    def _rays_from_pixels(self, image_id, x, y):
        c2w = self.camtoworlds[image_id]
        camera_dirs = np.stack(
            [
                (x - self.K[0, 2] + 0.5) / self.K[0, 0],
                (y - self.K[1, 2] + 0.5) / self.K[1, 1],
                np.ones_like(x),
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
        n = self.num_rays
        if self.batch_over_images:
            image_id = self.rng.integers(0, len(self.images), size=n)
        else:
            image_id = np.full(n, self.rng.integers(0, len(self.images)))
        x = self.rng.integers(0, self.WIDTH, size=n)
        y = self.rng.integers(0, self.HEIGHT, size=n)
        rgb = (
            self.images[
                image_id,
                (y // self.upsample).astype(int),
                (x // self.upsample).astype(int),
            ][..., :3].astype(np.float32)
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
        return {
            "pixels": rgb,
            "rays": Rays(origins=origins, viewdirs=viewdirs),
            "color_bkgd": color_bkgd,
        }

    def fetch_eval_view(self, index: int):
        index = index % len(self.images)
        x, y = np.meshgrid(
            np.arange(self.WIDTH, dtype=np.float32),
            np.arange(self.HEIGHT, dtype=np.float32),
            indexing="xy",
        )
        x, y = x.reshape(-1), y.reshape(-1)
        image_id = np.full(x.shape[0], index)
        origins, viewdirs = self._rays_from_pixels(image_id, x, y)
        pixels = self.images[index][..., :3].astype(np.float32) / 255.0
        return {
            "pixels": pixels.reshape(-1, 3),
            "rays": Rays(origins=origins, viewdirs=viewdirs),
            "color_bkgd": np.ones(3, np.float32),
        }

    def __getitem__(self, index: int):
        if self.training:
            return self.fetch_train_batch()
        return self.fetch_eval_view(index)
