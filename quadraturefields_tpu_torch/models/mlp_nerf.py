"""The sinusoidal positional encoding of the vanilla NeRF MLPs.

Port of the helpers of quadraturefields_tpu/models/mlp_nerf.py that the
SIREN field (models/field.py) uses; the vanilla and time-warped NeRF
MLPs of that file are not ported yet.
"""
from __future__ import annotations

import math

import torch


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """[x,] sin(2^k x), sin(2^k x + pi/2) for k in [min_deg, max_deg),
    the frequencies of one coordinate side by side (reference
    SinusoidalEncoder, mlp.py:168-203)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        *x.shape[:-1], (max_deg - min_deg) * x.shape[-1])
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def sinusoidal_dim(x_dim: int, min_deg: int, max_deg: int,
                   use_identity: bool = True) -> int:
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim
