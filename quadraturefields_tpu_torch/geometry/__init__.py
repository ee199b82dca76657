from .native import (
    BVH,
    marching_tetrahedra,
    decimate_vertex_clustering,
    segment_mesh,
)
from .meshio import load_ply, save_ply, Mesh

__all__ = [
    "BVH",
    "marching_tetrahedra",
    "decimate_vertex_clustering",
    "segment_mesh",
    "load_ply",
    "save_ply",
    "Mesh",
]
