"""Checkpoints as torch.save of plain dicts of tensors and numbers.

The JAX package writes orbax pytree checkpoints; reading those needs
orbax, so the port keeps its own format: the same tree, with tensors
moved to the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_cpu(state), path)


def load_checkpoint(path: str, map_location=None):
    """The saved tree; tensors land on `map_location` (default CPU)."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def save_grid_npy(path: str, arr) -> None:
    """An array (a tensor on any device, or numpy) as a .npy file."""
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().numpy()
    np.save(path, np.asarray(arr))
