"""Activation and coordinate-contraction primitives.

Port of quadraturefields_tpu/ops/activations.py. The reference's custom
backwards (examples/radiance_fields/ngp.py:146-207) are
`torch.autograd.Function`s here: trunc_exp clamps x at 15 in its
gradient, and contract_to_unisphere's gradient is the clamped radial
approximation.
"""
from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with a truncated backward: grad = g * exp(clamp(x, max=15))."""
    return _TruncExp.apply(x)


def density_activation(x: torch.Tensor) -> torch.Tensor:
    """Default NGP density activation: trunc_exp(x - 1)."""
    return trunc_exp(x - 1.0)


def _contract(x: torch.Tensor, aabb: torch.Tensor):
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2.0 - 1.0
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mask = mag > 1.0
    y = torch.where(mask, (2.0 - 1.0 / mag) * (x / mag), x) / 4.0 + 0.5
    return y, x, mag, mask


class _ContractToUnisphere(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, aabb):
        y, xn, mag, mask = _contract(x, aabb)
        ctx.save_for_backward(xn, mag, mask)
        return y

    @staticmethod
    def backward(ctx, g):
        xn, mag, mask = ctx.saved_tensors
        dev = (2.0 * mag - 1.0) / mag**2 + 2.0 * xn**2 * (
            1.0 / mag**3 - (2.0 * mag - 1.0) / mag**4
        )
        dev = torch.where(mask, dev, 1.0).clamp(min=1e-6)
        return g * dev, None


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor):
    """mip-NeRF-360 contraction onto [0, 1]^3: aabb -> [-1,1]^3, |x|>1
    contracted to the 2-sphere shell, then rescaled to [0,1]. The
    backward is the reference's radial-derivative approximation clamped
    to >= 1e-6 (it leaves out the aabb and 1/4 scale factors, as the
    reference does)."""
    return _ContractToUnisphere.apply(x, aabb)


def inverse_contraction(x: torch.Tensor, aabb: torch.Tensor):
    """Inverse of contract_to_unisphere on [0,1] input, and the mask of
    points outside the contractible shell (mag > 2)."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    x = (x - 0.5) * 4.0
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mask = mag > 1.0
    invalid = mag > 2.0
    x = torch.where(mask, 1.0 / (2.0 - mag) * x / mag, x)
    x = (x + 1.0) / 2.0
    x = x * (aabb_max - aabb_min) + aabb_min
    return x, invalid


def inv_contract_from_unisphere(y: torch.Tensor, aabb: torch.Tensor):
    """[0,1]^3 -> world coordinates, inverting contract_to_unisphere with
    the contracted radius clamped inside (1e-6, 2 - 1e-6); the unbounded
    occupancy update places its grid cells with it."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    xc = (y - 0.5) * 4.0
    m_c = torch.linalg.vector_norm(xc, dim=-1, keepdim=True)
    m_c_safe = m_c.clamp(1e-6, 2.0 - 1e-6)
    m = 1.0 / (2.0 - m_c_safe)
    x_norm = torch.where(m_c > 1.0, xc / m_c_safe * m, xc)
    x01 = (x_norm + 1.0) / 2.0
    return aabb_min + x01 * (aabb_max - aabb_min)


def normalize_aabb(x: torch.Tensor, aabb: torch.Tensor):
    """World coords -> [0,1]^3 through the aabb, and the in-box
    selector."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    y = (x - aabb_min) / (aabb_max - aabb_min)
    selector = ((y > 0.0) & (y < 1.0)).all(dim=-1)
    return selector, y
