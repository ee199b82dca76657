"""Seeded weights of the stage-1 field, made on the device.

Two draws from one `torch.Generator` on the device: the hash table, and
one flat buffer cut into every MLP matrix. Each MLP matrix is
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the init of the port's `mlp_init`;
the table is U(-scale, scale): the init's 1e-4 for training, a larger
scale for a served model. A served model's density is then fitted to
the scene (`fit_density`), so that its rays stop where a model that has
learnt the scene stops them.
"""
from __future__ import annotations

import math

import torch

from ..reference import ngp
from ..reference.ngp import Grid

FIT_SEED_OFFSET = 3

HIDDEN = 64
GEO_FEAT = 15


def mlp_shapes(grid: Grid) -> dict:
    """The "mlp"-head NGP's matrices: base L*F -> 64 -> 16, head
    15 -> 64 -> 64 -> 3, none with a bias."""
    return {
        "mlp_base.0": (grid.output_dim, HIDDEN),
        "mlp_base.1": (HIDDEN, 1 + GEO_FEAT),
        "mlp_head.0": (GEO_FEAT, HIDDEN),
        "mlp_head.1": (HIDDEN, HIDDEN),
        "mlp_head.2": (HIDDEN, 3),
    }


def make_weights(grid: Grid, table_scale: float, seed: int,
                 device) -> dict:
    """Named f32 leaves {"table", "mlp_base.i", "mlp_head.i"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((grid.total_entries, grid.row_width),
                       generator=gen, device=device)
    leaves = {"table": table.mul_(2.0 * table_scale).sub_(table_scale)}
    shapes = mlp_shapes(grid)
    flat = torch.rand(sum(a * b for a, b in shapes.values()),
                      generator=gen, device=device)
    at = 0
    for name, (fan_in, fan_out) in shapes.items():
        bound = 1.0 / math.sqrt(fan_in)
        w = flat[at:at + fan_in * fan_out].view(fan_in, fan_out)
        leaves[name] = w.mul(2.0 * bound).sub(bound)
        at += fan_in * fan_out
    return leaves


@torch.no_grad()
def fit_density(leaves: dict, field: ngp.Field, aabb, binaries, sigma,
                seed: int, n_points: int) -> float:
    """Fit the density the field serves to the scene's `sigma`: the base
    MLP's density column (the last matrix's first) by least squares, in
    float64 on the host, so that the density activation of its output
    matches sigma(x), floored at 0.01, at `n_points` points drawn from
    the seed in the occupied cells of `binaries` (the only places the
    march samples). The table and every other weight stay as drawn.
    Returns the fit's RMS error in log density."""
    dev = binaries.device
    gen = torch.Generator(device=dev).manual_seed(seed + FIT_SEED_OFFSET)
    occupied = torch.nonzero(binaries.reshape(-1)).reshape(-1)
    pick = occupied[torch.randint(occupied.numel(), (n_points,),
                                  generator=gen, device=dev)]
    res = binaries.shape[0]
    cell = torch.stack([pick // (res * res), (pick // res) % res, pick % res],
                       dim=-1).to(torch.float32)
    unit = (cell + torch.rand((n_points, 3), generator=gen, device=dev)) / res
    x = aabb[:3] + unit * (aabb[3:] - aabb[:3])
    h = ngp.encode(field.precision.read_table(leaves["table"]),
                   unit.contiguous(), field.grid, field.payload)
    rnd = field.precision.round
    hidden = rnd(torch.relu(rnd(h) @ rnd(leaves["mlp_base.0"])))
    # density_activation(out) = exp(out - 1)
    target = 1.0 + torch.log(sigma(x).clamp_min(1e-2))
    a, b = hidden.double().cpu(), target.double().cpu()
    col = torch.linalg.lstsq(a, b[:, None], driver="gelsd").solution[:, 0]
    leaves["mlp_base.1"][:, 0] = col.to(leaves["mlp_base.1"])
    return float((a @ col - b).square().mean().sqrt())


def program_leaves(params) -> dict:
    """The port's parameter tree ({"table", "mlp_base": {"layers":
    [{"w"}]}, "mlp_head": ...}) as named leaves, the same tensors."""
    out = {"table": params["table"]}
    for part in ("mlp_base", "mlp_head"):
        for i, layer in enumerate(params[part]["layers"]):
            if set(layer) != {"w"}:
                raise ValueError(f"{part}.{i} has {sorted(layer)}, the "
                                 "benchmark's field has weights only")
            out[f"{part}.{i}"] = layer["w"]
    return out


@torch.no_grad()
def load_into(params, leaves: dict) -> None:
    """Copy the benchmark's leaves into the program's own, in place, so
    that its optimiser keeps the same tensors."""
    mine = program_leaves(params)
    if set(mine) != set(leaves):
        raise ValueError(f"the program's leaves {sorted(mine)} are not "
                         f"the benchmark's {sorted(leaves)}")
    for name, t in mine.items():
        if t.shape != leaves[name].shape:
            raise ValueError(f"{name}: {tuple(t.shape)} against "
                             f"{tuple(leaves[name].shape)}")
        t.copy_(leaves[name])
