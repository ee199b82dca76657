"""Texture-map feature compression (stage 6).

Port of quadraturefields_tpu/baking/compression.py (reference
texture_utils.FeatureCompression, texture_utils.py:17-203): the SG
feature vector [diffuse(3), per-lobe (axis(3), lambda(1), color(3)) x L,
sigma] is quantized to uint8 PNG maps:
  alpha.png          [N,N]    sigma -> 1-exp(-0.005 sigma)
  diffuse.png        [N,N,3]  sigmoid or linear codec
  lambda_axis_i.png  [N,N,3]  (compressed lambda, azimuth, elevation)
  color_i.png        [N,N,3]  lobe color codec
The quantization runs on the host in numpy (ops/quantize.py's numpy
half); the decode (get_features_from_*) is torch on the maps' device,
the baked render path. The PNGs go through utils/png.py (zlib only).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.quantize import (
    compress_colors,
    compress_lambda,
    compress_polar_coordinates,
    compress_sigma,
    inverse_of_azimuth_and_elevation,
    inverse_of_compressed_colors,
    inverse_of_compressed_lambda,
    inverse_of_compressed_sigma,
)
from ..utils.png import read_png, write_png


def _png_names(path: str, num_lobes: int):
    """The maps' files under the path prefix: alpha, diffuse, the lobes'
    colours, then their (lambda, azimuth, elevation)."""
    return ([path + "alpha.png", path + "diffuse.png"]
            + [path + f"color_{i}.png" for i in range(num_lobes)]
            + [path + f"lambda_axis_{i}.png" for i in range(num_lobes)])


class FeatureCompression:
    def __init__(
        self,
        num_lobes: int,
        initialize: bool = False,
        texture_size: int | None = None,
        path: str | None = None,
        compression_type: str = "sigmoid",
        lambda_thres: float = 7.5,
    ):
        self.num_lobes = num_lobes
        self.texture_size = texture_size
        # reference naming: "sigmoid" selects the sigmoid codec which the
        # low-level fns call "sigma" (texture_utils.py:74 + ngp.py:264)
        self.compression_type = (
            "sigma" if compression_type == "sigmoid" else compression_type
        )
        self.lambda_thres = lambda_thres

        if initialize:
            n = texture_size
            self.alpha = np.zeros((n, n), np.uint8)
            self.diffuse = np.zeros((n, n, 3), np.uint8)
            self.sg_colors = [
                np.zeros((n, n, 3), np.uint8) for _ in range(num_lobes)
            ]
            self.lambdas = [
                np.zeros((n, n, 3), np.uint8) for _ in range(num_lobes)
            ]
        else:
            with ThreadPoolExecutor(8) as pool:
                maps = list(pool.map(read_png, _png_names(path, num_lobes)))
            self.alpha, self.diffuse = maps[0], maps[1]
            self.sg_colors = maps[2:2 + num_lobes]
            self.lambdas = maps[2 + num_lobes:]
            self.texture_size = self.alpha.shape[0]

    def compress(self, features):
        """features [N, 3 + 7*num_lobes + 1] -> dict of uint8 arrays
        (texture_utils.py:67-98), on the host in numpy."""
        features = np.asarray(features)
        n = features.shape[0]
        sigma = features[:, -1]
        alpha = compress_sigma(sigma)
        diffuse = compress_colors(
            features[..., :3], compress_type=self.compression_type
        )
        lobes = features[..., 3:-1].reshape(n, self.num_lobes, 7)
        azimuth, elevation = compress_polar_coordinates(lobes[..., :3])
        comp_lambda = compress_lambda(
            np.abs(lobes[..., 3]), self.lambda_thres
        )
        data = {"alpha": alpha, "diffuse": diffuse, "lambdas": [],
                "colors": []}
        for i in range(self.num_lobes):
            data["lambdas"].append(np.stack(
                [comp_lambda[..., i], azimuth[..., i], elevation[..., i]],
                axis=-1))
            data["colors"].append(compress_colors(
                lobes[..., i, 4:], compress_type=self.compression_type))
        return data

    def load_features_into_maps(self, features, indices):
        """Write compressed features into texel (row, col) positions
        (texture_utils.py:197-203)."""
        data = self.compress(features)
        r, c = np.asarray(indices[:, 0]), np.asarray(indices[:, 1])
        self.alpha[r, c] = data["alpha"]
        self.diffuse[r, c] = data["diffuse"]
        for i in range(self.num_lobes):
            self.lambdas[i][r, c] = data["lambdas"][i]
            self.sg_colors[i][r, c] = data["colors"][i]

    def save_to_file(self, path: str):
        """Every map as a PNG, written on threads (zlib releases the
        GIL; 2 + 2L maps of up to 50 MB at 4096^2)."""
        os.makedirs(os.path.dirname(path + "x"), exist_ok=True)
        maps = [self.alpha, self.diffuse, *self.sg_colors, *self.lambdas]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write_png, _png_names(path, self.num_lobes), maps))

    def as_device_arrays(self, device=None):
        """The maps as uint8 tensors on `device`: alpha [N, N], diffuse
        [N, N, 3], lambda_axis and colors [L, N, N, 3]."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return {
            "alpha": dev(self.alpha),
            "diffuse": dev(self.diffuse),
            "lambda_axis": dev(np.stack(self.lambdas)),
            "colors": dev(np.stack(self.sg_colors)),
        }

    def as_device_array_packed(self, device=None):
        """All maps channel-packed into ONE [N, N, 1+3+6L] uint8 tensor
        on `device`: the baked render path gathers one texel row a hit
        instead of 2+2L. Channel layout: [alpha, diffuse(3), per-lobe
        (lambda, azimuth, elevation, color(3))]."""
        parts = [self.alpha[..., None], self.diffuse]
        for i in range(self.num_lobes):
            parts.append(self.lambdas[i])
            parts.append(self.sg_colors[i])
        return torch.as_tensor(np.concatenate(parts, axis=-1),
                               device=device)

    def get_features_from_packed_texels(self, tex):
        """Decode a gathered [M, 1+3+6L] uint8 texel block (from
        as_device_array_packed) -> [M, 3 + 7L + 1] feature vectors, the
        contract of get_features_from_texture_map."""
        sigma = inverse_of_compressed_sigma(tex[:, 0])
        diffuse = inverse_of_compressed_colors(
            tex[:, 1:4], compress_type=self.compression_type
        )
        feats = [diffuse]
        for i in range(self.num_lobes):
            o = 4 + 6 * i
            lam = inverse_of_compressed_lambda(tex[:, o], self.lambda_thres)
            axis = inverse_of_azimuth_and_elevation(tex[:, o + 1],
                                                    tex[:, o + 2])
            color = inverse_of_compressed_colors(
                tex[:, o + 3:o + 6], compress_type=self.compression_type)
            feats += [axis, lam[:, None], color]
        feats.append(sigma[:, None])
        return torch.cat(feats, dim=-1)

    def get_features_from_texture_map(self, indices, maps=None):
        """Texel (row, col) [M, 2] -> decoded feature vectors
        [diffuse(3), lobes(7L), sigma(1)] (texture_utils.py:149-175);
        `maps` from as_device_arrays (default: on the indices' device)."""
        if maps is None:
            maps = self.as_device_arrays(indices.device)
        r, c = indices[:, 0].long(), indices[:, 1].long()
        sigma = inverse_of_compressed_sigma(maps["alpha"][r, c])
        diffuse = inverse_of_compressed_colors(
            maps["diffuse"][r, c], compress_type=self.compression_type
        )
        feats = [diffuse]
        for i in range(self.num_lobes):
            shared = maps["lambda_axis"][i][r, c]
            lam = inverse_of_compressed_lambda(shared[:, 0],
                                               self.lambda_thres)
            axis = inverse_of_azimuth_and_elevation(shared[:, 1],
                                                    shared[:, 2])
            color = inverse_of_compressed_colors(
                maps["colors"][i][r, c], compress_type=self.compression_type)
            feats += [axis, lam[:, None], color]
        feats.append(sigma[:, None])
        return torch.cat(feats, dim=-1)
