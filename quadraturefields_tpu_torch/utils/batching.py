"""Dynamic ray-batch sizing: `bucket_num_rays` and `snap_pack_cap`,
copied from quadraturefields_tpu/utils/batching.py.

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


def snap_pack_cap(total: int, pack_cap: int, min_cap: int = 4096):
    """Smallest grid value >= the packed-hit demand (CEILING — a cap
    below demand would truncate hits), clamped to [min_cap, pack_cap].

    Stage-4/5 steps slice the host-packed hit stream to this bucket
    before upload, so every per-hit term (field/RF encodes, their
    backward, the composite) scales with the scene's ACTUAL hit count
    instead of the static worst-case pack_cap. Same √2 grid as the ray
    buckets: ≤ ~41% waste."""
    need = max(min_cap, min(int(total), pack_cap))
    if need > _GRID[-1]:
        # past the grid ceiling the CEILING contract still holds: round
        # up to a 256 multiple instead of truncating to the top bucket
        b = -(-need // 256) * 256
    else:
        b = _GRID[bisect.bisect_left(_GRID, need)]
    return max(min_cap, min(b, pack_cap))
