"""Activation and coordinate-contraction primitives (forward).

Port of quadraturefields_tpu/ops/activations.py. The truncated backward
of trunc_exp and the radial backward of contract_to_unisphere come with
the training step.
"""
from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x); the reference's backward clamps x at 15 (not ported yet)."""
    return torch.exp(x)


def density_activation(x: torch.Tensor) -> torch.Tensor:
    """Default NGP density activation: trunc_exp(x - 1)."""
    return trunc_exp(x - 1.0)


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor):
    """mip-NeRF-360 contraction onto [0, 1]^3: aabb -> [-1,1]^3, |x|>1
    contracted to the 2-sphere shell, then rescaled to [0,1]."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2.0 - 1.0
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mask = mag > 1.0
    x = torch.where(mask, (2.0 - 1.0 / mag) * (x / mag), x)
    return x / 4.0 + 0.5


def normalize_aabb(x: torch.Tensor, aabb: torch.Tensor):
    """World coords -> [0,1]^3 through the aabb, and the in-box
    selector."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    y = (x - aabb_min) / (aabb_max - aabb_min)
    selector = ((y > 0.0) & (y < 1.0)).all(dim=-1)
    return selector, y
