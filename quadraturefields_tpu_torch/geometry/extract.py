"""Stage 3: mesh extraction from the exported field/density grids.

Port of quadraturefields_tpu/geometry/extract.py (reference
examples/marching_cubes.py:16-82 + examples/downsample_mesh.py:11-20).
The grid filters run on the device (Gaussian smooth, trilinear
occupancy upsample, sin(omega*q)) in the JAX package's order of
operations; the isosurface runs on the host (marching tetrahedra in the
port's copy of the C++ library; the reference uses skimage
marching_cubes). Mesh vertices are emitted in the reference's
normalized [-1, 1] cube (marching_cubes.py:66-67,77-78).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .meshio import Mesh, save_ply
from .native import decimate_vertex_clustering, marching_tetrahedra


def gaussian_kernel_1d(kernel_size: int = 5, sigma: float = 100.0):
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth_3d(grid: torch.Tensor, kernel_size: int = 5,
                       sigma: float = 100.0) -> torch.Tensor:
    """Separable 3-D Gaussian blur with zero 'same' padding, axis 0, 1,
    then 2 (reference field_utils.GaussianSmoothing with kernel 5, sigma
    100: at that sigma it is effectively a 5^3 box filter). The
    convolutions run in f32 with TF32 off: sin(omega*q) downstream turns
    a TF32 rounding of the blur into a shift of the level set."""
    k = torch.as_tensor(gaussian_kernel_1d(kernel_size, sigma),
                        device=grid.device).view(1, 1, -1)
    pad = kernel_size // 2
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        for axis in range(3):
            g = grid.movedim(axis, -1)
            shape = g.shape
            out = F.conv1d(g.reshape(-1, 1, shape[-1]), k, padding=pad)
            grid = out.reshape(shape).movedim(-1, axis)
    return grid


def upsample_trilinear_aligned(grid: torch.Tensor, out_shape) -> torch.Tensor:
    """Trilinear upsample with align_corners=True semantics (torch
    nn.Upsample in marching_cubes.py:30), one axis at a time with the
    JAX package's index formula: out coord i maps to i*(in-1)/(out-1)."""
    g = grid.to(torch.float32)
    for axis in range(3):
        n_in, n_out = g.shape[axis], out_shape[axis]
        if n_in == n_out:
            continue
        pos = (torch.arange(n_out, device=g.device) * (n_in - 1)) \
            .to(torch.float32) / (n_out - 1)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n_in - 1)
        shape = [1] * g.dim()
        shape[axis] = n_out
        w = (pos - lo).reshape(shape)
        g = (g.index_select(axis, lo) * (1 - w)
             + g.index_select(axis, hi) * w)
    return g


def extract_mesh(
    out_dir: str,
    sigma: float = 100.0,
    include_grad: bool = True,
    omega: float = 100.0,
    thres: float = 0.0,
    combine: bool = True,
    grad_thres: float = 0.01,
    density_thres: float = 10.0,
    grids=None,
    grads=None,
    binaries=None,
    nerf_density=None,
    save: bool = True,
    device="cuda",
):
    """Reference marching_cubes.py flow:
      1. Gaussian-smooth the field grid;
      2. upsample occupancy binaries to the grid res (trilinear,
         align_corners) as a validity mask d;
      3. normalize grid*d to [-1, 1];
      4. quantity = grid * d * (|grad| > grad_thres);
      5. quadrature surface = isosurface of sin(omega*quantity) at
         `thres`; optionally union with the NeRF density surface at
         `density_thres`.
    Steps 1-4 and the sine run on `device`. Returns the combined Mesh
    (vertices in [-1, 1]^3) and writes mesh.ply / mesh_nerf.ply when
    `save`.
    """
    if grids is None:
        grids = np.load(os.path.join(out_dir, "grids_valid.npy"))
    if grads is None:
        grads = np.load(os.path.join(out_dir, "grads_valid.npy"))
    if binaries is None:
        binaries = np.load(os.path.join(out_dir, "binaries.npy"))[0]

    n = grids.shape[0]
    with torch.no_grad():
        grid = gaussian_smooth_3d(
            torch.as_tensor(np.asarray(grids, np.float32), device=device),
            5, sigma)
        d = upsample_trilinear_aligned(
            torch.as_tensor(np.asarray(binaries), device=device), (n, n, n))
        gd = grid * d
        gmin = gd.min()
        del gd
        grid = grid - gmin
        gmax = (grid * d).max()
        grid = grid / (gmax + 1e-6)
        grid = (grid - 0.5) * 2.0
        quantity = grid * d
        del grid, d
        if include_grad:
            g = torch.as_tensor(np.asarray(grads), device=device)
            quantity = quantity * (g.to(torch.float32) > grad_thres)
            del g
        surface = torch.sin(omega * quantity).cpu().numpy()
        del quantity

    meshes = []
    verts, faces = marching_tetrahedra(surface, level=thres)
    quad_mesh = Mesh(
        (verts / (n - 1) - 0.5) * 2.0, faces
    )
    meshes.append(quad_mesh)

    if combine:
        if nerf_density is None:
            nerf_density = np.load(
                os.path.join(out_dir, "density_grids_valid.npy")
            )
        dverts, dfaces = marching_tetrahedra(
            np.asarray(nerf_density, np.float32), level=density_thres
        )
        nd = nerf_density.shape[0]
        density_mesh = Mesh((dverts / (nd - 1) - 0.5) * 2.0, dfaces)
        if save:
            save_ply(os.path.join(out_dir, "mesh_nerf.ply"), density_mesh)
        meshes.append(density_mesh)

    mesh = meshes[0]
    for m in meshes[1:]:
        mesh = mesh.concat(m)
    if save:
        save_ply(os.path.join(out_dir, "mesh.ply"), mesh)
    return mesh


def downsample_mesh(mesh: Mesh, vx: float = 150.0) -> Mesh:
    """Vertex-clustering simplification at voxel 1/vx (reference
    downsample_mesh.py:13-20)."""
    verts, faces = decimate_vertex_clustering(
        mesh.vertices, mesh.faces, 1.0 / vx
    )
    return Mesh(verts, faces)
