"""CLI: stage-3 mesh extraction (reference examples/marching_cubes.py,
positional sys.argv contract preserved):

  python -m quadraturefields_tpu_torch.cli.marching_cubes <root> <sigma> \
      <include_grad> <omega> <thres> <axis> <combine> <grad_thres> \
      <density_thres>

The grid filters run on the CUDA card unless main() is given another
device.
"""
from __future__ import annotations

import sys

from ..geometry.extract import extract_mesh


def main(argv=None, device: str = "cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    root = argv[0]
    sigma = float(argv[1])
    include_grad = argv[2] == "True"
    omega = float(argv[3])
    thres = float(argv[4])
    _axis = int(argv[5])  # unused by the reference flow too
    combine = argv[6] == "True"
    grad_thres = float(argv[7])
    density_thres = float(argv[8])
    mesh = extract_mesh(
        root,
        sigma=sigma,
        include_grad=include_grad,
        omega=omega,
        thres=thres,
        combine=combine,
        grad_thres=grad_thres,
        density_thres=density_thres,
        device=device,
    )
    print("Combined mesh: Faces", mesh.faces.shape,
          "Vertices:", mesh.vertices.shape)
    return mesh


if __name__ == "__main__":
    main()
