"""Compact COLMAP sparse-model reader (cameras/images, binary + text).

Replaces the reference's vendored pycolmap SceneManager
(examples/pycolmap/, used by nerf_360_v2._load_colmap at
nerf_360_v2.py:114-131). Reads cameras.{bin,txt} and images.{bin,txt}
from a sparse/0 directory; quaternions are COLMAP's (w, x, y, z)
world-to-camera convention.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    camera_id: int
    camera_type: int
    width: int
    height: int
    params: np.ndarray

    def _p(self, i, default=0.0):
        return float(self.params[i]) if len(self.params) > i else default

    @property
    def fx(self):
        return float(self.params[0])

    @property
    def fy(self):
        name, _ = CAMERA_MODELS[self.camera_type]
        if name in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                    "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[0])
        return float(self.params[1])

    @property
    def cx(self):
        name, _ = CAMERA_MODELS[self.camera_type]
        if name in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                    "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[1])
        return float(self.params[2])

    @property
    def cy(self):
        name, _ = CAMERA_MODELS[self.camera_type]
        if name in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                    "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[2])
        return float(self.params[3])

    # distortion params by model layout
    @property
    def k1(self):
        name, _ = CAMERA_MODELS[self.camera_type]
        if name == "SIMPLE_RADIAL":
            return self._p(3)
        if name == "RADIAL":
            return self._p(3)
        return self._p(4)

    @property
    def k2(self):
        name, _ = CAMERA_MODELS[self.camera_type]
        if name == "RADIAL":
            return self._p(4)
        return self._p(5)

    @property
    def p1(self):
        return self._p(6)

    @property
    def p2(self):
        return self._p(7)

    @property
    def k3(self):
        return self._p(6)

    @property
    def k4(self):
        return self._p(7)


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)],
            ]
        )


class SceneManager:
    """pycolmap.SceneManager drop-in subset."""

    def __init__(self, colmap_dir: str):
        self.colmap_dir = colmap_dir
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}

    def load_cameras(self):
        bin_path = os.path.join(self.colmap_dir, "cameras.bin")
        txt_path = os.path.join(self.colmap_dir, "cameras.txt")
        if os.path.exists(bin_path):
            with open(bin_path, "rb") as f:
                n = struct.unpack("<Q", f.read(8))[0]
                for _ in range(n):
                    cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
                    _, np_ = CAMERA_MODELS[model]
                    params = np.array(
                        struct.unpack(f"<{np_}d", f.read(8 * np_))
                    )
                    self.cameras[cid] = Camera(cid, model, w, h, params)
        else:
            name_to_id = {v[0]: k for k, v in CAMERA_MODELS.items()}
            with open(txt_path) as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    parts = line.split()
                    cid = int(parts[0])
                    model = name_to_id[parts[1]]
                    w, h = int(parts[2]), int(parts[3])
                    params = np.array([float(x) for x in parts[4:]])
                    self.cameras[cid] = Camera(cid, model, w, h, params)

    def load_images(self):
        bin_path = os.path.join(self.colmap_dir, "images.bin")
        txt_path = os.path.join(self.colmap_dir, "images.txt")
        if os.path.exists(bin_path):
            with open(bin_path, "rb") as f:
                n = struct.unpack("<Q", f.read(8))[0]
                for _ in range(n):
                    iid = struct.unpack("<I", f.read(4))[0]
                    qvec = np.array(struct.unpack("<4d", f.read(32)))
                    tvec = np.array(struct.unpack("<3d", f.read(24)))
                    cam_id = struct.unpack("<I", f.read(4))[0]
                    name = b""
                    while True:
                        c = f.read(1)
                        if c == b"\x00":
                            break
                        name += c
                    n2d = struct.unpack("<Q", f.read(8))[0]
                    f.read(24 * n2d)  # skip 2D points
                    self.images[iid] = Image(
                        iid, qvec, tvec, cam_id, name.decode()
                    )
        else:
            # two lines per image: pose line + observations line; the
            # observations line may be EMPTY (image with no 2D points),
            # so pairing must keep blank lines (only comments dropped)
            with open(txt_path) as f:
                lines = [ln for ln in f if not ln.startswith("#")]
            for i in range(0, len(lines), 2):
                if not lines[i].strip():
                    continue
                parts = lines[i].split()
                iid = int(parts[0])
                qvec = np.array([float(x) for x in parts[1:5]])
                tvec = np.array([float(x) for x in parts[5:8]])
                cam_id = int(parts[8])
                name = parts[9]
                self.images[iid] = Image(iid, qvec, tvec, cam_id, name)


def similarity_from_cameras(c2w, strict_scaling=False):
    """Similarity transform normalizing an OpenCV-convention camera set
    (reference nerf_360_v2.py:268-326, from nerf-factory)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]
    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)
    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.diag([-1.0, 1.0, 1.0])
    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]
    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)
    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align
    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / scale_fn(np.linalg.norm(t + translate, axis=-1))
    return transform, scale
