"""LPIPS perceptual metric (VGG variant), weights-gated.

Port of quadraturefields_tpu/utils/lpips.py. The reference evaluates
LPIPS(net="vgg") in every trainer (train_ngp_nerf_sg_occ.py:262-264
etc.); no torchvision or lpips package ships here, so the VGG16 feature
trunk, the unit-normalised feature differences, the linear calibration
weights and the spatial mean are written out, and the weights come from
a local npz (set QF_LPIPS_WEIGHTS or pass `weights_path`). Without
weights every call returns NaN, with one warning per process, so the
metric plumbing stays the same with or without them.

Weight file format (the JAX package's, tools/convert_lpips_weights.py):
an npz with the conv weights "features.{i}.weight" [O, I, 3, 3] and
"features.{i}.bias" [O] (torchvision VGG16 layer indices) and the
calibration vectors "lin{k}.weight" [C_k] (lpips package layout).

The convolutions are F.conv2d (JAX computes LPIPS with XLA convolutions,
not in a kernel of its own). On the card cuDNN would run them in TF32 by
default, which keeps about three decimal digits; the module switches
TF32 off for them.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (out_channels, torchvision features index)
_VGG16_CONVS = [
    (64, 0), (64, 2),
    (128, 5), (128, 7),
    (256, 10), (256, 12), (256, 14),
    (512, 17), (512, 19), (512, 21),
    (512, 24), (512, 26), (512, 28),
]
# relu indices after which LPIPS taps features (relu1_2 ... relu5_3)
_TAP_AFTER = {2, 7, 14, 21, 28}
_POOL_AFTER = {2, 7, 14, 21}  # maxpool after these conv indices (not 28)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(torch.nn.Module):
    """LPIPS(VGG) between two [H, W, 3] images in [0, 1] (tensors on any
    device, or numpy arrays): a float, NaN without weights. The weights
    move to the images' device at the first call there."""

    _warned_nan = False  # one warning per process, not per eval

    def __init__(self, weights_path: Optional[str] = None):
        super().__init__()
        weights_path = weights_path or os.environ.get("QF_LPIPS_WEIGHTS")
        self.params = None
        if weights_path and os.path.exists(weights_path):
            raw = np.load(weights_path)
            self.params = {k: torch.as_tensor(np.asarray(raw[k], np.float32))
                           for k in raw.files}

    @property
    def available(self) -> bool:
        return self.params is not None

    def _on(self, device: torch.device) -> dict:
        if next(iter(self.params.values())).device != device:
            self.params = {k: v.to(device) for k, v in self.params.items()}
        return self.params

    def _features(self, x: torch.Tensor, params: dict):
        """x [N, 3, H, W] in [-1, 1] -> the five tap activations."""
        shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
        h = (x - shift) / scale
        taps = []
        for _, idx in _VGG16_CONVS:
            h = F.conv2d(h, params[f"features.{idx}.weight"],
                         params[f"features.{idx}.bias"], padding=1)
            h = F.relu(h)
            if idx in _TAP_AFTER:
                taps.append(h)
            if idx in _POOL_AFTER:
                h = F.max_pool2d(h, 2)
        return taps

    def forward(self, img0, img1) -> float:
        if not self.available:
            if not LPIPS._warned_nan:
                LPIPS._warned_nan = True
                warnings.warn(
                    "LPIPS weights unavailable - emitting NaN for every "
                    "lpips metric. Provide an npz via QF_LPIPS_WEIGHTS "
                    "(tools/convert_lpips_weights.py builds it from the "
                    "torch `lpips` package's weights).",
                    stacklevel=2,
                )
            return float("nan")
        img0 = torch.as_tensor(img0, dtype=torch.float32)
        img1 = torch.as_tensor(img1, dtype=torch.float32,
                               device=img0.device)
        params = self._on(img0.device)
        x0 = img0.permute(2, 0, 1)[None] * 2.0 - 1.0
        x1 = img1.permute(2, 0, 1)[None] * 2.0 - 1.0
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=False,
                allow_tf32=False):
            f0s = self._features(x0, params)
            f1s = self._features(x1, params)
            total = torch.zeros((), device=img0.device)
            for k, (f0, f1) in enumerate(zip(f0s, f1s)):
                n0 = f0 / torch.sqrt((f0 ** 2).sum(dim=1, keepdim=True)
                                     + 1e-10)
                n1 = f1 / torch.sqrt((f1 ** 2).sum(dim=1, keepdim=True)
                                     + 1e-10)
                lin = params[f"lin{k}.weight"].reshape(1, -1, 1, 1)
                total = total + ((n0 - n1) ** 2 * lin).sum(dim=1).mean()
        return float(total)
