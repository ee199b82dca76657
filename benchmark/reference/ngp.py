"""Plain PyTorch reference of the stage-1 NGP field.

The hash-grid encode (corner layout, tet or cube corners; cell layout),
its table gradient, the MLPs with operands rounded to the compute dtype
and an f32 product, the density activation and the "mlp" colour head.
A frozen copy of the plain paths of `quadraturefields_tpu_torch`
(ops/hashgrid.py, ops/hashgrid_sorted.py `factor_rows`, ops/mlp.py,
ops/activations.py, models/ngp.py, as the benchmark was first written),
with nothing of that package imported.

`Precision` says how MLP operands are rounded (bf16, as the
configurations state, or fp8 for a control: the nearest precision
below) and in what the f32 table is read (bf16 for a control).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                    for k in (0, 1)], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Grid:
    """The hash grid of a configuration: tcnn levels from resolution 16
    to 4096; the cell layout counts log2_hashmap_size in corners."""

    n_levels: int
    n_features: int
    log2_hashmap_size: int
    layout: str = "corner"
    interp: str = "tet"
    base_resolution: int = 16
    max_resolution: int = 4096

    @property
    def log2_rows(self) -> int:
        if self.layout == "cell":
            return max(self.log2_hashmap_size - 3, 4)
        return self.log2_hashmap_size

    @property
    def level_scales(self):
        s = math.exp((math.log(self.max_resolution)
                      - math.log(self.base_resolution))
                     / (self.n_levels - 1))
        return tuple(self.base_resolution * (s**l) - 1.0
                     for l in range(self.n_levels))

    @property
    def level_resolutions(self):
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @property
    def level_sizes(self):
        sizes = []
        for res in self.level_resolutions:
            n_axis = res - 1 if self.layout == "cell" else res
            size = min(n_axis**3, 1 << self.log2_rows)
            sizes.append((size + 7) // 8 * 8)
        return tuple(sizes)

    @property
    def level_offsets(self):
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def total_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def row_width(self) -> int:
        return 8 * self.n_features if self.layout == "cell" \
            else self.n_features

    @property
    def corners(self) -> int:
        return 8 if self.interp == "cube" else 4

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def level_index(coords, res: int, size: int):
    """Flat row of integer corner coords [..., 3] on one level: dense
    when res^3 <= size, else the xor-prime hash masked to size."""
    c = coords.to(torch.int64)
    if res**3 <= size:
        return c[..., 0] + c[..., 1] * res + c[..., 2] * (res * res)
    h = c[..., 0] * PRIMES[0]
    h = h ^ (c[..., 1] * PRIMES[1])
    h = h ^ (c[..., 2] * PRIMES[2])
    return h & (size - 1)


def tet_ranks(frac):
    """Descending rank of each fraction, ties to the lower axis."""
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    rx = (fy > fx).to(torch.int64) + (fz > fx).to(torch.int64)
    ry = (fx >= fy).to(torch.int64) + (fz > fy).to(torch.int64)
    rz = (fx >= fz).to(torch.int64) + (fy >= fz).to(torch.int64)
    return torch.stack([rx, ry, rz], dim=1)


def kuhn_weights(frac):
    """(ranks [N, 3], the 4 Kuhn weights [N, 4] 1-f1, f1-f2, f2-f3, f3)."""
    r = tet_ranks(frac)
    zero = torch.zeros((), dtype=torch.float32, device=frac.device)
    f1 = torch.where(r == 0, frac, zero).sum(dim=1)
    f2 = torch.where(r == 1, frac, zero).sum(dim=1)
    f3 = torch.where(r == 2, frac, zero).sum(dim=1)
    return r, torch.stack([1.0 - f1, f1 - f2, f2 - f3, f3], dim=1)


def cube_weights(frac):
    """The 8 trilinear weights in CORNERS order."""
    corners = torch.as_tensor(CORNERS, device=frac.device)
    w = torch.ones((frac.shape[0], 8), dtype=torch.float32,
                   device=frac.device)
    for axis in range(3):
        on = corners[None, :, axis].bool()
        f = frac[:, None, axis]
        w = w * torch.where(on, f, 1.0 - f)
    return w


def corner_rows_weights(x, grid: Grid):
    """Corner layout: (rows [N, L*C] int64, weights [N, L*C])."""
    x = x.to(torch.float32)
    corners = torch.as_tensor(CORNERS, device=x.device)
    rows, weights = [], []
    for l in range(grid.n_levels):
        scale = torch.tensor(grid.level_scales[l], dtype=torch.float32)
        pos = x * scale + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        base = pos_floor.to(torch.int64)
        res = grid.level_resolutions[l]
        if grid.interp == "cube":
            c = (base[:, None, :] + corners[None]).clamp(0, res - 1)
            w = cube_weights(frac)
        else:
            r, w = kuhn_weights(frac)
            e1 = (r == 0).to(torch.int64)
            e2 = (r == 1).to(torch.int64)
            c = torch.stack([torch.zeros_like(base), e1, e1 + e2,
                             torch.ones_like(base)], dim=1) + base[:, None]
            c = c.clamp(0, res - 1)
        rows.append(level_index(c, res, grid.level_sizes[l])
                    + grid.level_offsets[l])
        weights.append(w)
    return torch.cat(rows, dim=1), torch.cat(weights, dim=1)


def cell_levels(x, grid: Grid):
    """Cell layout, per level: (row [N] int64, fraction [N, 3] in [0, 1])."""
    x = x.to(torch.float32)
    for l in range(grid.n_levels):
        scale = torch.tensor(grid.level_scales[l], dtype=torch.float32)
        pos = x * scale + 0.5
        n_axis = grid.level_resolutions[l] - 1
        cell = torch.floor(pos).to(torch.int64).clamp(0, n_axis - 1)
        frac = (pos - cell.to(torch.float32)).clamp(0.0, 1.0)
        yield (level_index(cell, n_axis, grid.level_sizes[l])
               + grid.level_offsets[l]), frac


def cell_kuhn(frac):
    """Kuhn weights [N, 4] in slot order (0, s1, s2, 7) and s1, s2."""
    r, wk = kuhn_weights(frac)
    bit = torch.tensor([4, 2, 1], dtype=torch.int64, device=frac.device)
    s1 = ((r == 0).to(torch.int64) * bit).sum(dim=1)
    s2 = ((r <= 1).to(torch.int64) * bit).sum(dim=1)
    return wk, s1, s2


def cell_w8(frac, grid: Grid):
    """The 8 dense corner weights of a level's fractions."""
    if grid.interp == "cube":
        return cube_weights(frac)
    wk, s1, s2 = cell_kuhn(frac)
    slots = torch.stack([torch.zeros_like(s1), s1, s2,
                         torch.full_like(s1, 7)], dim=1)
    return torch.zeros((frac.shape[0], 8), dtype=torch.float32,
                       device=frac.device).scatter(1, slots, wk)


def bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def factor_rows(wk, s1, s2, g):
    """The bf16 factor payload of one level: [N, 8F] rows holding
    bf16(bf16(wk[:, t]) * bf16(g[:, f])) at column slot_t * F + f."""
    m, F = g.shape
    slots = torch.stack([torch.zeros_like(s1), s1, s2,
                         torch.full_like(s1, 7)], dim=1)
    prod = bf16(bf16(wk)[:, :, None] * bf16(g)[:, None, :])
    cols = slots[:, :, None] * F + torch.arange(F, device=g.device)
    rows = torch.zeros((m, 8 * F), dtype=torch.float32, device=g.device)
    rows.scatter_add_(1, cols.reshape(m, 4 * F), prod.reshape(m, 4 * F))
    return rows


def corner_encode(table, x, grid: Grid):
    """Corner layout: the weighted sum of each level's corner rows,
    x [N, 3] in [0, 1] -> [N, L*F]. Its table gradient is autograd's:
    the scatter-add of w * g into the corner rows, in f32."""
    x = x.clamp(0.0, 1.0)
    n, L, C, F = x.shape[0], grid.n_levels, grid.corners, grid.n_features
    rows, w = corner_rows_weights(x, grid)
    feats = table[rows]
    return (feats * w[..., None]).reshape(n, L, C, F).sum(dim=2) \
        .reshape(n, L * F)


def cell_encode_plain(table, x, grid: Grid):
    x = x.clamp(0.0, 1.0)
    n, F = x.shape[0], grid.n_features
    outs = []
    for idx, frac in cell_levels(x, grid):
        rows = table[idx].reshape(n, 8, F)
        outs.append((rows * cell_w8(frac, grid)[:, :, None]).sum(dim=1))
    return torch.cat(outs, dim=1)


class _CellEncode(torch.autograd.Function):
    """The cell encode whose table gradient takes the bf16 factor
    payload (a tet grid with F >= 4 and grad_payload "bf16factor", as
    the configuration states), summed in f32; other payloads sum the
    f32 contribution rows."""

    @staticmethod
    def forward(ctx, table, x, grid, factor):
        ctx.grid, ctx.factor = grid, factor
        ctx.save_for_backward(x)
        ctx.table_shape = table.shape
        return cell_encode_plain(table, x, grid)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grid = ctx.grid
        x = x.clamp(0.0, 1.0)
        n, L, F = x.shape[0], grid.n_levels, grid.n_features
        g3 = g.to(torch.float32).reshape(n, L, F)
        out = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=x.device)
        for l, (idx, frac) in enumerate(cell_levels(x, grid)):
            if ctx.factor:
                wk, s1, s2 = cell_kuhn(frac)
                contrib = factor_rows(wk, s1, s2, g3[:, l])
            else:
                contrib = (cell_w8(frac, grid)[:, :, None]
                           * g3[:, l][:, None, :]).reshape(n, 8 * F)
            out.index_add_(0, idx, contrib)
        return out, None, None, None


def cell_encode(table, x, grid: Grid, payload: str):
    factor = (payload == "bf16factor" and grid.interp == "tet"
              and grid.n_features >= 4 and grid.n_features % 2 == 0)
    return _CellEncode.apply(table, x, grid, factor)


def encode(table, x, grid: Grid, payload: str = "f32"):
    if grid.layout == "cell":
        return cell_encode(table, x, grid, payload)
    return corner_encode(table, x, grid)


def rows_touched(x, grid: Grid) -> int:
    """Distinct table rows that encoding x [N, 3] in [0, 1] reads."""
    x = x.clamp(0.0, 1.0)
    if grid.layout == "cell":
        rows = torch.stack([idx for idx, _ in cell_levels(x, grid)], dim=1)
    else:
        rows, _ = corner_rows_weights(x, grid)
    touched = torch.zeros(grid.total_entries, dtype=torch.bool,
                          device=x.device)
    touched[rows.reshape(-1)] = True
    return int(touched.sum())


# ---- MLPs in a stated precision ----

def _scaled_fp8(t, dtype, top: float):
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Operands rounded to e4m3 and their gradients to e5m2, each with
    one scale a tensor (its largest magnitude at the format's largest
    finite value): the usual FP8 training recipe, the nearest precision
    below bf16."""

    @staticmethod
    def forward(ctx, t):
        return _scaled_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_fp8(g, torch.float8_e5m2, 57344.0)


def round_fp8(t):
    return _Fp8.apply(t)


@dataclasses.dataclass(frozen=True)
class Precision:
    """How MLP operands are rounded before an f32 product, and in what
    the hash table's values are read."""

    operands: str = "bfloat16"   # "bfloat16" | "fp8"
    table: str = "float32"       # "float32" | "bfloat16"

    def round(self, t):
        if self.operands == "fp8":
            return round_fp8(t)
        return t.to(getattr(torch, self.operands)).to(torch.float32)

    def read_table(self, table):
        if self.table == "float32":
            return table
        return table.to(getattr(torch, self.table)).to(torch.float32)


def dense(w, x, precision: Precision):
    """x @ w, both operands rounded, the product and the sum in f32."""
    return precision.round(x) @ precision.round(w)


def mlp(weights, x, precision: Precision):
    """ReLU after every hidden layer, linear output, no biases."""
    h = x
    for w in weights[:-1]:
        h = torch.relu(dense(w, h, precision))
    return dense(weights[-1], h, precision)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def density_activation(x):
    """trunc_exp(x - 1): exp forward, its argument clamped at 15 in the
    gradient."""
    return _TruncExp.apply(x - 1.0)


@dataclasses.dataclass(frozen=True)
class Field:
    """An NGP field with the "mlp" head (num_lobes 0) on a bounded
    aabb: base MLP L*F -> 64 -> 16 (density, 15 geo features), head
    15 -> 64 -> 64 -> 3, sigmoid."""

    grid: Grid
    payload: str = "f32"
    precision: Precision = Precision()

    def density(self, params, x, aabb, return_feat=False):
        y = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
        inside = ((y > 0.0) & (y < 1.0)).all(dim=-1)
        h = encode(self.precision.read_table(params["table"]),
                   y.contiguous(), self.grid, self.payload)
        out = mlp(params["mlp_base"], h, self.precision)
        density = density_activation(out[..., :1]) * inside[..., None]
        if return_feat:
            return density, out[..., 1:]
        return density

    def forward(self, params, x, aabb):
        """(rgb [N, 3], density [N, 1])."""
        density, feat = self.density(params, x, aabb, return_feat=True)
        rgb = torch.sigmoid(mlp(params["mlp_head"], feat, self.precision))
        return rgb, density
