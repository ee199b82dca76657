"""The value-space table gradient with bf16 values (K8's interface).

Port of quadraturefields_tpu/ops/hashgrid_backward.py:sorted_table_grad,
which the JAX package keeps as a measured record and does not wire into
the encoder. It sums (row, lane0, v0, v1) contributions of the packed
value layout (flat value id = row * 128 + lane, feature 0 at the even
lane0, feature 1 beside it) into a flat [total_values] f32 gradient. The
TPU kernel multiplies a bf16 one-hot by bf16 values and sums in f32, so
v0 and v1 are rounded to bf16 here first. Entry = (row * 128 + lane0) / 2
then goes through the pair segment sum of ops/hashgrid_sorted.py (the
CUDA kernel csrc/table_grad.cu on the card, one index_add_ on the CPU).
"""
from __future__ import annotations

import torch

from . import hashgrid_sorted

LANES = 128


def sorted_table_grad(row_ids: torch.Tensor, lane0: torch.Tensor,
                      v0: torch.Tensor, v1: torch.Tensor,
                      total_values: int) -> torch.Tensor:
    """row_ids, lane0 [M] int (lane0 even), v0, v1 [M] f32 ->
    [total_values] f32."""
    entries = (row_ids.to(torch.int64) * LANES + lane0.to(torch.int64)) // 2
    n_entries = -(-total_values // LANES) * (LANES // 2)
    v0 = v0.to(torch.bfloat16).to(torch.float32).contiguous()
    v1 = v1.to(torch.bfloat16).to(torch.float32).contiguous()
    out = hashgrid_sorted.sorted_table_grad(entries, v0, v1, n_entries)
    return out.reshape(-1)[:total_values]
