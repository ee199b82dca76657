"""CLI: stage-3 mesh simplification (reference
examples/downsample_mesh.py): mesh.ply -> smp_mesh.ply at voxel 1/vx.

  python -m quadraturefields_tpu_torch.cli.downsample_mesh <mesh.ply> <vx>

The decimation runs on the host: `device` is read by nothing and is
accepted only so that every stage's main() has the same signature.
"""
from __future__ import annotations

import os
import sys

from ..geometry.extract import downsample_mesh
from ..geometry.meshio import load_ply, save_ply


def main(argv=None, device: str = "cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    mesh_path = argv[0]
    vx = float(argv[1])
    mesh = load_ply(mesh_path)
    smp = downsample_mesh(mesh, vx=vx)
    out = os.path.join(os.path.dirname(mesh_path), "smp_mesh.ply")
    save_ply(out, smp)
    print("smp_mesh:", smp.vertices.shape, smp.faces.shape, "->", out)
    return smp


if __name__ == "__main__":
    main()
