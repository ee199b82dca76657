"""Closed-form O(n) mip-NeRF-360 distortion loss on packed samples.

Port of quadraturefields_tpu/ops/distortion.py (reference
flatten_eff_distloss, train_ngp_nerf_sg_occ.py:27,332-334):

  L = sum_rays [ sum_{i,j} w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 t_i ]

in O(n) per ray by segmented prefix sums (samples sorted by midpoint
within each ray, as the march leaves them), as the mean over rays.
"""
from __future__ import annotations

import torch

from .scan import exclusive_sum, mark_pack_boundaries


def flatten_eff_distloss(weights, midpoints, intervals, ray_indices,
                         n_rays: int) -> torch.Tensor:
    boundaries = mark_pack_boundaries(ray_indices)
    w = weights
    wm = w * midpoints
    # bidirectional term: 2 sum_i w_i (m_i sum_{j<i} w_j - sum_{j<i} w_j m_j)
    exc_w = exclusive_sum(w, boundaries)
    exc_wm = exclusive_sum(wm, boundaries)
    bi = 2.0 * (w * (midpoints * exc_w - exc_wm)).sum()
    uni = (w**2 * intervals).sum() / 3.0
    return (bi + uni) / n_rays
