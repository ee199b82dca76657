"""Closed-form degree-4 real spherical harmonics direction encoding.

Port of quadraturefields_tpu/ops/sh.py: the input is the tcnn
convention, directions mapped to [0,1] by (d+1)/2.
"""
from __future__ import annotations

import torch


def spherical_harmonics_deg4(dirs01: torch.Tensor) -> torch.Tensor:
    """dirs01: [N, 3] in [0, 1] ((d+1)/2-mapped). Returns [N, 16]."""
    d = dirs01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(out, dim=-1)
