"""D-NeRF synthetic loader (time-conditioned Blender JSON).

Parity with reference examples/datasets/dnerf_synthetic.py: identical
to the NeRF-synthetic loader plus a per-frame `time` value (frames
without one get their index fraction) returned as `timestamps` with
each batch, feeding the T-NeRF model family (models/mlp_nerf.py).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .nerf_synthetic import Rays, SubjectLoader as _BaseLoader


def _load_renderings_with_time(root_fp: str, subject_id: str, split: str):
    import imageio.v2 as imageio

    data_dir = os.path.join(root_fp, subject_id)
    with open(
        os.path.join(data_dir, f"transforms_{split}.json"), "r"
    ) as fp:
        meta = json.load(fp)
    images, camtoworlds, timestamps = [], [], []
    n = len(meta["frames"])
    for i, frame in enumerate(meta["frames"]):
        fname = os.path.join(data_dir, frame["file_path"] + ".png")
        if not os.path.exists(fname):
            fname = os.path.join(data_dir, frame["file_path"])
        images.append(imageio.imread(fname))
        camtoworlds.append(frame["transform_matrix"])
        timestamps.append(
            frame["time"] if "time" in frame else float(i) / (n - 1)
        )
    images = np.stack(images, axis=0)
    camtoworlds = np.stack(camtoworlds, axis=0).astype(np.float32)
    timestamps = np.asarray(timestamps, np.float32)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, camtoworlds, focal, timestamps


class SubjectLoader(_BaseLoader):
    """NeRF-synthetic loader + per-frame timestamps."""

    def __init__(self, subject_id: str, root_fp: str, split: str, **kw):
        load_split = split if split in ("train", "test") else "train"
        (_, _, _, self.timestamps) = _load_renderings_with_time(
            root_fp, subject_id, load_split
        )
        super().__init__(subject_id, root_fp, split, **kw)

    def fetch_train_batch(self):
        n = self.num_rays
        image_id = self.rng.integers(0, len(self.images), size=n)
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
            "timestamps": self.timestamps[image_id][:, None],
        }

    def fetch_eval_view(self, index: int):
        data = super().fetch_eval_view(index)
        data["timestamps"] = np.full(
            (1, 1), self.timestamps[index % len(self.images)], np.float32
        )
        return data
