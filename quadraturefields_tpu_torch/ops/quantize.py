"""uint8 feature codecs for texture baking, with the reference's formulas
(ngp.py:210-281, utils.py:54-63, texture_utils.py:51-98).

Port of quadraturefields_tpu/ops/quantize.py. Each codec dispatches on
its input: numpy arrays stay numpy (the host half: the bake quantizes
millions of texels on the host), torch tensors stay torch on their
device (the decode inside the baked render path). float -> uint8
truncates toward zero in both halves, as numpy's and XLA's casts do.
"""
from __future__ import annotations

import numpy as np
import torch


class _NumpyOps:
    exp, log, cos, sin = np.exp, np.log, np.cos, np.sin
    arccos, arctan2 = np.arccos, np.arctan2

    @staticmethod
    def clip(a, lo, hi):
        return np.clip(a, lo, hi)

    @staticmethod
    def stack(arrays, axis):
        return np.stack(arrays, axis=axis)

    @staticmethod
    def norm(v):
        return np.linalg.norm(v, axis=-1, keepdims=True)

    @staticmethod
    def u8(a):
        return a.astype(np.uint8)

    @staticmethod
    def f32(a):
        return a.astype(np.float32)


class _TorchOps:
    exp, log, cos, sin = torch.exp, torch.log, torch.cos, torch.sin
    arccos, arctan2 = torch.arccos, torch.atan2

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)

    @staticmethod
    def stack(arrays, axis):
        return torch.stack(arrays, dim=axis)

    @staticmethod
    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    @staticmethod
    def u8(a):
        return a.to(torch.uint8)

    @staticmethod
    def f32(a):
        return a.to(torch.float32)


def _xp(a):
    return _TorchOps if torch.is_tensor(a) else _NumpyOps


# ---- sigma <-> alpha (texture_utils.py:51-65) ----
def compress_sigma(sigma):
    xp = _xp(sigma)
    alpha = 1.0 - xp.exp(-sigma * 0.005)
    return xp.u8(xp.clip(alpha * 255.0, 0, 255))


def inverse_of_compressed_sigma(alpha_u8):
    xp = _xp(alpha_u8)
    a = xp.f32(alpha_u8) / 255.0
    return -xp.log(xp.clip(1.0 - a, 1e-6, None)) / 0.005


# ---- colors (ngp.py:264-281) ----
def compress_colors(colors, thres: float = 12.0,
                    compress_type: str = "sigma"):
    xp = _xp(colors)
    if compress_type == "sigma":  # 'sigmoid' compression
        c = 1.0 / (1.0 + xp.exp(-colors))
    else:
        c = xp.clip(colors, -thres, thres)
        c = (c + thres) / (2.0 * thres)
    return xp.u8(c * 255.0)


def inverse_of_compressed_colors(colors_u8, thres: float = 12.0,
                                 compress_type: str = "sigma"):
    xp = _xp(colors_u8)
    c = xp.f32(colors_u8) / 255.0
    if compress_type == "sigma":
        return xp.log(xp.clip(c / (1.0 - c), 1e-8, 1e37))
    return c * 2.0 * thres - thres


# ---- lobe axis via polar angles (ngp.py:239-252) ----
def compress_polar_coordinates(vectors):
    xp = _xp(vectors)
    v = vectors / (xp.norm(vectors) + 1e-6)
    azimuth = xp.u8(xp.arctan2(v[..., 1], v[..., 0]) * 128.0 / np.pi
                    + 128.0)
    elevation = xp.u8(xp.arccos(v[..., 2]) * 256.0 / np.pi)
    return azimuth, elevation


def inverse_of_azimuth_and_elevation(azimuth_u8, elevation_u8):
    xp = _xp(azimuth_u8)
    azimuth = (xp.f32(azimuth_u8) - 128.0) / 128.0 * np.pi
    elevation = xp.f32(elevation_u8) / 256.0 * np.pi
    x = xp.cos(azimuth) * xp.sin(elevation)
    y = xp.sin(azimuth) * xp.sin(elevation)
    z = xp.cos(elevation)
    return xp.stack([x, y, z], axis=-1)


# ---- lobe sharpness lambda (ngp.py:254-262) ----
def compress_lambda(lambdas, compress_threshold: float = 7.5):
    xp = _xp(lambdas)
    log_l = xp.log(xp.clip(lambdas, 1e-5, None))
    c = xp.clip((log_l + 2.5) / compress_threshold, 0.0, 1.0)
    return xp.u8(255.0 * c)


def inverse_of_compressed_lambda(c_u8, compress_threshold: float = 7.5):
    xp = _xp(c_u8)
    log_l = xp.f32(c_u8) * compress_threshold / 255.0 - 2.5
    return xp.exp(log_l)


# ---- axis as plain uint8 (ngp.py:210-217, used by discretize path) ----
def discretize_axis(axis):
    xp = _xp(axis)
    return xp.u8((axis + 1.0) * 255.0 / 2.0)


def continuous_axis(axis_u8):
    xp = _xp(axis_u8)
    return xp.f32(axis_u8) / 255.0 * 2.0 - 1.0
