"""The yardstick: the card's peaks, a kernel's least time, and the
operations of the stage-1 field from its widths.

Peaks are NVIDIA's published H100 SXM figures (dense): 3.35 TB/s of
HBM, 67 TFLOP/s in f32 outside the tensor cores. The trainer turns TF32
off and multiplies bf16-rounded operands in f32, so f32 is the peak its
GEMMs can reach. A kernel's least time is the larger of its bytes over
the HBM rate and its operations over the f32 rate, each input byte
read once and each output byte written once, on the shapes it was
launched on (the pattern of `chip_smoke.py`'s `bound`, `encode_bound`
and `rows_touched`).
"""
from __future__ import annotations

from ..reference.ngp import Grid
from .weights import mlp_shapes

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S)


def encode_flops(grid: Grid) -> int:
    """Interpolation of one point: a multiply-add per corner feature of
    every level (4 corners tet, 8 cube, whatever the layout stores)."""
    return 2 * grid.n_levels * grid.corners * grid.n_features


def field_flops(grid: Grid) -> int:
    """The forward FLOPs of one sample: interpolation and both MLPs."""
    macs = sum(a * b for a, b in mlp_shapes(grid).values())
    return encode_flops(grid) + 2 * macs


def train_flops(grid: Grid) -> int:
    """A training sample: forward, and a backward of twice its work."""
    return 3 * field_flops(grid)


def encode_least_s(grid: Grid, n: int, rows: int) -> float:
    """K2 on n points: x in, each touched table row read once, the
    [n, L*F] features out."""
    return least_s(n * 12 + rows * grid.row_width * 4
                   + n * grid.output_dim * 4, n * encode_flops(grid))


def table_grad_least_s(grid: Grid, n: int, rows: int) -> float:
    """A fused table gradient on n points: x and the cotangent g
    [n, L*F] in, each touched gradient row written once; a multiply-add
    per corner feature."""
    return least_s(n * 12 + n * grid.output_dim * 4
                   + rows * grid.row_width * 4, n * encode_flops(grid))
