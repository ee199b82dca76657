"""Dynamic ray-batch sizing: `bucket_num_rays`, copied from
quadraturefields_tpu/utils/batching.py.

The trainer resizes the ray batch every step to hold the sample count
near its budget (reference train_ngp_nerf_sg_occ.py:303-309). Requests
snap DOWN to a √2 grid of multiples of 256, as in the JAX package: the
port's batch sizes then equal the JAX trainer's step for step, and
flooring keeps the sample demand under the fixed compaction budget.
"""
from __future__ import annotations

import bisect

_RATIO = 2 ** 0.5


def _build_grid(lo: int = 256, hi: int = 1 << 22):
    grid, k = [], 0
    while True:
        b = int(lo * (_RATIO**k) // 256 * 256)
        if not grid or b > grid[-1]:
            grid.append(b)
        if b >= hi:
            break
        k += 1
    return grid


_GRID = _build_grid()


def bucket_num_rays(n: int, min_rays: int = 256, max_rays: int = 1 << 22):
    """Largest grid value <= n (idempotent: grid values map to
    themselves), clamped to [min_rays, max_rays]."""
    n = max(min_rays, min(int(n), max_rays))
    i = bisect.bisect_right(_GRID, n) - 1
    b = _GRID[max(i, 0)]
    return max(min_rays, min(b, max_rays))
