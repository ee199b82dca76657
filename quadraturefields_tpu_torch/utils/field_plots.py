"""Field slice plots (reference field_utils.plot_field,
field_utils.py:78-157): the mid-plane slice across each axis of the
field value, |grad| and sin(omega * field), saved as PNGs during stage-2
training. Port of quadraturefields_tpu/utils/field_plots.py; matplotlib
is imported only when a plot is drawn."""
from __future__ import annotations

import os

import numpy as np
import torch


def plot_field(field_with_grad_fn, prefix: str, scale: float = 0.5,
               grid_size: int = 512, omega: float = 100.0, step: int = 0,
               device=None):
    """field_with_grad_fn(coords [M, 3] on `device`) -> (field [M],
    |grad| [M]); writes field_axis{0,1,2}_step{step}.png under prefix."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(prefix, exist_ok=True)
    lin = np.linspace(-1.0, 1.0, grid_size, dtype=np.float32) * scale
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    for axis in range(3):
        coords = np.zeros((grid_size * grid_size, 3), np.float32)
        plane = [a for a in range(3) if a != axis]
        coords[:, plane[0]] = gx.reshape(-1)
        coords[:, plane[1]] = gy.reshape(-1)
        f, g = field_with_grad_fn(torch.as_tensor(coords, device=device))
        f = f.detach().cpu().numpy().reshape(grid_size, grid_size)
        g = g.detach().cpu().numpy().reshape(grid_size, grid_size)
        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        for ax, img, title in zip(
            axes,
            [f, g, np.sin(omega * f)],
            ["field", "|grad|", "sin(omega*field)"],
        ):
            im = ax.imshow(img, cmap="jet")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, fraction=0.046)
        fig.savefig(
            os.path.join(prefix, f"field_axis{axis}_step{step}.png"),
            dpi=80, bbox_inches="tight",
        )
        plt.close(fig)
