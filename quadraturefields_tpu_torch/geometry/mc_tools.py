"""Mesh/visibility tooling (reference examples/mc_utils.py parity).

Port of quadraturefields_tpu/geometry/mc_tools.py: utilities off the
shipped script path but part of the reference's toolbox: visibility
pruning by ray-tracing train views (mc_utils.py:272-345),
transmittance-visibility grids (mc_utils.py:348-570), binary-grid
expansion (mc_utils.py:159-179), mesh cleanup (mc_utils.py:222-244).
"""
from __future__ import annotations

import numpy as np
import torch

from .extract import upsample_trilinear_aligned
from .intersect import MeshIntersection
from .meshio import Mesh


def expand_binaries(binaries, M: int = 1024, device="cuda"):
    """Upsample an occupancy binary grid to M^3 (mc_utils.py:159-179)."""
    with torch.no_grad():
        d = upsample_trilinear_aligned(
            torch.as_tensor(np.asarray(binaries), device=device), (M, M, M))
        return (d > 0.0).cpu().numpy()


def clean_mesh(mesh: Mesh) -> Mesh:
    """Drop degenerate faces + unreferenced vertices
    (mc_utils.py:222-244 subset)."""
    a = mesh.vertices[mesh.faces[:, 0]]
    b = mesh.vertices[mesh.faces[:, 1]]
    c = mesh.vertices[mesh.faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    keep = area > 1e-12
    return Mesh(mesh.vertices, mesh.faces[keep]) \
        .remove_unreferenced_vertices()


def prune_mesh_train_visibility(
    mesh: Mesh, datasets, max_hits: int = 5, complement: bool = False
) -> Mesh:
    """Keep faces hit by at least one train-view ray (or the complement)
    (mc_utils.py:272-345). `datasets` yields dicts with "rays"."""
    mi = MeshIntersection(
        mesh=mesh, simplify_mesh=False, num_intersections=max_hits
    )
    visible = np.zeros((mesh.faces.shape[0],), bool)
    for data in datasets:
        rays = data["rays"]
        tri_ids, _, valid = mi.intersect_rows(
            np.asarray(rays.origins), np.asarray(rays.viewdirs)
        )
        visible[tri_ids[valid]] = True
    keep = ~visible if complement else visible
    return Mesh(mesh.vertices, mesh.faces[keep]) \
        .remove_unreferenced_vertices()


@torch.no_grad()
def grid_transmittance(
    density_fn,
    aabb,
    datasets,
    grid_size: int = 256,
    render_step_size: float = 5e-3,
    trans_thre: float = 1e-3,
    chunk: int = 8192,
    device="cuda",
):
    """Max-over-views transmittance per grid cell: march train rays
    through an all-occupied grid, scatter each sample's transmittance
    into its cell with a max (mc_utils.grid_transmittance[_synthetic],
    mc_utils.py:348-570). density_fn(x [N, 3]) -> [N, 1]. Returns the
    [grid_size]^3 f32 grid on the host."""
    from ..ops import scan
    from ..ops.grid import (
        OccGridConfig,
        max_march_steps,
        occ_grid_init,
        occ_grid_sampling,
    )

    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    occ_state = occ_grid_init(aabb_t, OccGridConfig(resolution=8), device)
    max_steps = max_march_steps(np.asarray(aabb), render_step_size)
    res = grid_size

    def view_pass(origins, viewdirs):
        samples = occ_grid_sampling(
            occ_state, origins, viewdirs,
            render_step_size=render_step_size, max_steps=max_steps,
            max_samples_total=chunk * 64,
        )
        idx = samples.ray_indices.clamp(0, origins.shape[0] - 1).long()
        t_mid = (samples.t_starts + samples.t_ends)[:, None] / 2.0
        pos = origins[idx] + viewdirs[idx] * t_mid
        sigmas = torch.where(samples.valid, density_fn(pos)[..., 0], 0.0)
        boundaries = scan.mark_pack_boundaries(samples.ray_indices)
        trans, _ = scan.render_transmittance_from_density(
            samples.t_starts, samples.t_ends, sigmas, boundaries)
        unit = (pos - aabb_t[:3]) / (aabb_t[3:] - aabb_t[:3])
        cell = (unit * res).to(torch.int32).clamp(0, res - 1).long()
        flat = cell[:, 0] * res * res + cell[:, 1] * res + cell[:, 2]
        flat = torch.where(samples.valid, flat, res**3)
        grid = torch.zeros((res**3 + 1,), dtype=torch.float32,
                           device=device)
        grid.scatter_reduce_(0, flat,
                             torch.where(samples.valid, trans, 0.0),
                             reduce="amax")
        return grid[:-1]

    out = torch.zeros((res**3,), dtype=torch.float32, device=device)
    for data in datasets:
        rays = data["rays"]
        o = np.asarray(rays.origins, np.float32)
        d = np.asarray(rays.viewdirs, np.float32)
        for i in range(0, o.shape[0], chunk):
            oc, dc = o[i:i + chunk], d[i:i + chunk]
            if oc.shape[0] < chunk:
                pad = chunk - oc.shape[0]
                oc = np.concatenate([oc, np.zeros((pad, 3), np.float32)])
                dc = np.concatenate(
                    [dc, np.tile([[0, 0, 1.0]], (pad, 1))]
                ).astype(np.float32)
            g = view_pass(torch.as_tensor(oc, device=device),
                          torch.as_tensor(dc, device=device))
            out = torch.maximum(out, g)
    return out.reshape(res, res, res).cpu().numpy()
