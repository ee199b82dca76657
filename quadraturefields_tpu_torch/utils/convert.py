"""Carry weights and occupancy state across from the JAX package.

The JAX `ngp_init` tree, fetched as numpy arrays, is
{"table": [E, F] (a cell-layout table is [E, 8F], row slot c*F + f in
both packages), "mlp_base": {"layers": [{"w": [in, out]}, ...]},
"mlp_head": {"layers": [{"w": [in, out], "b": [out]}, ...]}}. The port
uses the same tree with torch tensors and keeps every `w` as
[in, out] (y = x @ w), so nothing is transposed. The stage-2 field tree
{"table", "decoder": {"layers": [...]}} and the vanilla and time-warped
NeRF MLPs' trees {"base": {"hidden": [...], "out"}, ...} carry across the
same way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import OccGridState


def _tree_to_torch(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def params_from_jax(np_tree, device=None):
    """JAX ngp params (numpy leaves) -> the port's params dict."""
    return _tree_to_torch(np_tree, device)


def field_params_from_jax(np_tree, device=None):
    """JAX field params (`field_init`'s tree, numpy leaves) -> the
    port's."""
    return _tree_to_torch(np_tree, device)


def mlp_nerf_params_from_jax(np_tree, device=None):
    """JAX vanilla_nerf_init's or tnerf_init's tree (numpy leaves; an MLP
    without an output layer has "out": None) -> the port's
    (models/mlp_nerf.py)."""
    return _tree_to_torch(np_tree, device)


def occ_state_from_jax(occs, binaries, aabb, device=None) -> OccGridState:
    """The fields of a JAX OccGridState (numpy) -> the port's state."""
    return OccGridState(
        occs=torch.as_tensor(np.array(occs, np.float32), device=device),
        binaries=torch.as_tensor(np.array(binaries, bool), device=device),
        aabb=torch.as_tensor(np.array(aabb, np.float32), device=device),
    )
