"""Dense grid export: field, |grad field| and density on an N^3 lattice.

Port of quadraturefields_tpu/utils/grid_export.py (reference
examples/field_utils.py:276-341): evaluate a 2x-supersampled lattice
(2N points per axis, coords = linspace(-1, 1) * scale) and average-pool
2x2x2 blocks down, streaming z-slices in pairs so that the supersampled
volume never exists whole. Axis order (x, y, z) and the artifact
contract are the JAX package's:

  grids_valid.npy          float32 [N, N, N]
  grads_valid.npy          float16 [N, N, N]  (|grad| clipped to 65504)
  density_grids_valid.npy  float16 [N, N, N]

Each slice is evaluated on the device in chunks of `chunk` points and
pooled there; only the pooled [N, N] slice comes back to the host. The
field gradient takes autograd, so the field export runs under
torch.enable_grad().
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _lattice(n: int, scale: float, z: float, device) -> torch.Tensor:
    """The [n * n, 3] points (x, y, z) * scale of one z-slice, x-major."""
    lin = torch.linspace(-1.0, 1.0, n, device=device)
    gx, gy = torch.meshgrid(lin, lin, indexing="ij")
    coords = torch.stack(
        [gx.reshape(-1), gy.reshape(-1),
         torch.full((n * n,), float(z), device=device)], dim=1)
    return coords * scale


def _avgpool2(pair: torch.Tensor) -> torch.Tensor:
    """[2, 2N, 2N] -> [N, N], the mean of each 2x2x2 block."""
    _, h, w = pair.shape
    return pair.reshape(2, h // 2, 2, w // 2, 2).mean(dim=(0, 2, 4))


def _chunked(fn, coords: torch.Tensor, chunk: int):
    """fn over `coords` in chunks of `chunk` points; each output of fn
    concatenated."""
    outs = [fn(coords[b:b + chunk]) for b in range(0, coords.shape[0], chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def extract_field_grid(field_with_grad_fn, prefix: str, scale: float,
                       grid_size: int = 1024, chunk: int = 1 << 20,
                       device=None):
    """field_with_grad_fn(coords [M, 3] on `device`) -> (field [M],
    |grad| [M]). Writes grids_valid.npy and grads_valid.npy under
    `prefix`; returns the two arrays."""
    n = 2 * grid_size
    zs = np.linspace(-1.0, 1.0, n)
    grids = np.zeros((grid_size,) * 3, np.float32)
    grads = np.zeros((grid_size,) * 3, np.float16)
    pair_f = torch.zeros((2, n, n), device=device)
    pair_g = torch.zeros((2, n, n), device=device)
    with torch.enable_grad():
        for j in range(n):
            f, g = _chunked(field_with_grad_fn,
                            _lattice(n, scale, zs[j], device), chunk)
            pair_f[j % 2] = f.reshape(n, n)
            pair_g[j % 2] = g.reshape(n, n).clamp(0.0, 65504.0)
            if j % 2 == 1:
                grids[:, :, j // 2] = _avgpool2(pair_f).cpu().numpy()
                grads[:, :, j // 2] = (_avgpool2(pair_g).cpu().numpy()
                                       .astype(np.float16))
    os.makedirs(prefix, exist_ok=True)
    np.save(os.path.join(prefix, "grids_valid.npy"), grids)
    np.save(os.path.join(prefix, "grads_valid.npy"), grads)
    return grids, grads


def extract_field_grid_h5(field_with_grad_fn, path: str, scale: float,
                          grid_size: int = 1024, chunk: int = 1 << 20,
                          device=None):
    """Chunked h5 export of the field and |grad| grids (reference
    field_utils.py:160-225, the memory-bounded form of the 360 scenes):
    z-slices streamed into the datasets "grids" (f4) and "grads" (f2),
    no supersampling."""
    import h5py

    n = grid_size
    zs = np.linspace(-1.0, 1.0, n)
    with h5py.File(path, "w") as h5, torch.enable_grad():
        dset_f = h5.create_dataset("grids", (n, n, n), dtype="f4")
        dset_g = h5.create_dataset("grads", (n, n, n), dtype="f2")
        for j in range(n):
            f, g = _chunked(field_with_grad_fn,
                            _lattice(n, scale, zs[j], device), chunk)
            dset_f[:, :, j] = f.reshape(n, n).cpu().numpy()
            dset_g[:, :, j] = (g.reshape(n, n).clamp(0.0, 65504.0).cpu()
                               .numpy().astype(np.float16))
    return path


def extract_density_grid(density_fn, prefix: str, scale: float,
                         grid_size: int = 1024, chunk: int = 1 << 20,
                         device=None):
    """density_fn(coords [M, 3] on `device`) -> sigma [M]. Writes
    density_grids_valid.npy under `prefix`; returns the array."""
    n = 2 * grid_size
    zs = np.linspace(-1.0, 1.0, n)
    grids = np.zeros((grid_size,) * 3, np.float16)
    pair = torch.zeros((2, n, n), device=device)
    with torch.no_grad():
        for j in range(n):
            sigma = _chunked(density_fn, _lattice(n, scale, zs[j], device),
                             chunk)
            pair[j % 2] = sigma.reshape(n, n).clamp(0.0, 65504.0)
            if j % 2 == 1:
                grids[:, :, j // 2] = (_avgpool2(pair).cpu().numpy()
                                       .astype(np.float16))
    os.makedirs(prefix, exist_ok=True)
    np.save(os.path.join(prefix, "density_grids_valid.npy"), grids)
    return grids
