"""Carry weights and occupancy state across from the JAX package.

The JAX `ngp_init` tree, fetched as numpy arrays, is
{"table": [E, F], "mlp_base": {"layers": [{"w": [in, out]}, ...]},
"mlp_head": {"layers": [{"w": [in, out], "b": [out]}, ...]}}. The port
uses the same tree with torch tensors and keeps every `w` as
[in, out] (y = x @ w), so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import OccGridState


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def params_from_jax(np_tree, device=None):
    """JAX ngp params (numpy leaves) -> the port's params dict."""
    return _tree_to_torch(np_tree, device)


def occ_state_from_jax(occs, binaries, aabb, device=None) -> OccGridState:
    """The fields of a JAX OccGridState (numpy) -> the port's state."""
    return OccGridState(
        occs=torch.as_tensor(np.array(occs, np.float32), device=device),
        binaries=torch.as_tensor(np.array(binaries, bool), device=device),
        aabb=torch.as_tensor(np.array(aabb, np.float32), device=device),
    )
