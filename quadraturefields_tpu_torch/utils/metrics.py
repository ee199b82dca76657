"""Image metrics and losses: MSE, PSNR, SSIM, smooth-L1, LPIPS.

Port of quadraturefields_tpu/utils/metrics.py. SSIM's E[x^2] - mu^2
variance cancels ~7 significant digits on flat windows, so its
convolution must run in full f32: on the card cuDNN would use TF32 by
default, which `ssim` switches off for its convolutions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse(a, b)) / np.log(10.0)


def smooth_l1_loss(pred, target, beta: float = 1.0, ray_mask=None):
    """Mean smooth-L1; `ray_mask` ([N] bool over the leading axis)
    restricts the mean to unmasked rows."""
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d**2 / beta, d - 0.5 * beta)
    if ray_mask is None:
        return loss.mean()
    m = ray_mask.to(loss.dtype)
    per_row = loss.mean(dim=tuple(range(1, loss.dim())))
    return (per_row * m).sum() / m.sum().clamp_min(1.0)


def _gaussian_kernel(size=11, sigma=1.5) -> torch.Tensor:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=torch.float32)


def ssim(img0, img1, max_val: float = 1.0, kernel_size=11, sigma=1.5):
    """Mean SSIM over channels, gaussian-windowed (torchmetrics
    defaults), VALID padding. Inputs [H, W, C] in [0, max_val]; values
    outside are clipped."""
    img0 = img0.clamp(0.0, max_val)
    img1 = img1.clamp(0.0, max_val)
    kernel = _gaussian_kernel(kernel_size, sigma).to(img0.device)
    weight = kernel[None, None]                       # [1, 1, k, k]

    def filt(x):
        x = x.permute(2, 0, 1)[:, None]               # [C, 1, H, W]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            out = F.conv2d(x, weight)
        return out[:, 0].permute(1, 2, 0)

    mu0, mu1 = filt(img0), filt(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    # clamp the moments to their ranges: variances >= 0 and
    # |covariance| <= sqrt(s00 * s11)
    s00 = (filt(img0 * img0) - mu00).clamp_min(0.0)
    s11 = (filt(img1 * img1) - mu11).clamp_min(0.0)
    bound = torch.sqrt(s00 * s11)
    s01 = torch.minimum(torch.maximum(filt(img0 * img1) - mu01, -bound),
                        bound)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return (num / den).mean()


_LPIPS_SINGLETON = None


def lpips_metric(img0, img1) -> float:
    """LPIPS(VGG) between [H, W, 3] images in [0, 1], on the images'
    device; NaN when no weights are installed (utils/lpips.py,
    QF_LPIPS_WEIGHTS). The module is built at the first call, as JAX's
    singleton is."""
    global _LPIPS_SINGLETON
    if _LPIPS_SINGLETON is None:
        from .lpips import LPIPS

        _LPIPS_SINGLETON = LPIPS()
    return float(_LPIPS_SINGLETON(img0, img1))
