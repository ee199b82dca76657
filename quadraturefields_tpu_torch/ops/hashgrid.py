"""Multiresolution hash-grid encoding (instant-NGP style), PyTorch port.

Port of quadraturefields_tpu/ops/hashgrid.py: `HashGridConfig` and its
level math (tcnn's formula scale_l = N_min * growth^l - 1,
res_l = ceil(scale_l) + 1, dense levels padded to a multiple of 8,
hashed levels 2^log2_T rows), the table init, the dense /
xor-prime-hash level indexing, cube and Kuhn-tet weights, and the
encode with its gradient, for both table layouts.

`hashgrid_encode` is differentiable in the table and in x.

Corner layout (one table row per grid corner): for tensors on the card
the forward launches csrc/hashgrid_encode.cu (`qf_hashgrid_encode`) and
the table gradient the fused kernel of the same file
(`qf_hashgrid_encode_bwd`, or `qf_hashgrid_encode_bwd_stochastic` for
grad_mode "stochastic"); CPU tensors run the plain versions,
`encode_plain`, `table_grad_plain` and `table_grad_stochastic_plain`.

Cell layout (one row of 8F floats per grid cell, all 8 corners' features
in the row, c*F + f): the forward is plain PyTorch on both devices
(`encode_cell_plain`, one row gather per level; JAX has no TPU kernel
for it either). The table gradient follows JAX's `_cell_bwd` routing
(`_cell_grad_route`) onto one of three segment sums: K7
(`tet_factor_grad_x`: the fused entry of csrc/cell_factor_grad.cu,
which computes each (point, level)'s cell row and Kuhn weights from x
itself), K6 (`cell_pair_grad_x`) or K5 (`cell_row_grad_x`), the fused
entries of csrc/cell_table_grad.cu, from x as K7's, for F in
CELL_GRAD_X_FEATURES (other F take K6's and K5's stream entries,
`sorted_pair_grad` and `sorted_row_grad`), each a CUDA kernel on the
card and its plain version on the CPU.
The position gradient is taken by autograd through the weights. Under
create_graph the encode's VJP is itself differentiable, to any order
(`_HashGridEncodeGrad`, JAX's differentiated custom VJP): the table
gradient of the position gradient, a stream of per-corner
contributions, goes to `scatter_rows`: K1's stream interface (corner)
or K5's stream entry (cell). One
known difference from JAX, on a set of measure zero: the weights clip
the cell fraction to [0, 1], and at a tie (frac exactly 0 or 1, i.e. x
on a grid knot) jax.grad(jnp.clip) gives 0.5 where torch.clamp gives 1,
so d_x differs on the knots.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr
from . import hashgrid_sorted

# tcnn spatial-hash primes (the first coordinate is unmultiplied).
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Same fields and defaults as the JAX config, so configs carry over.

    Corner layout: `grad_mode` "auto", "exact" and "sorted" all give the
    exact table gradient (one kernel on the card); "stochastic" adds each
    (point, level)'s cotangent to one corner picked with probability
    equal to its weight (its own kernel on the card). Cell layout: `grad_mode` and `grad_payload`
    pick the gradient as JAX's `_cell_bwd` does (`_cell_grad_route`);
    "auto" is "sorted" for tensors on the card unless 3 * E > n * L,
    else "exact", and "stochastic" is "exact"."""

    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865
    dtype: str = "float32"
    interp: str = "cube"      # "cube" (8 corners) | "tet" (Kuhn, 4)
    grad_mode: str = "auto"
    layout: str = "corner"    # "corner" | "cell"
    # cell layout only: "f32" | "bf16sim" | "bf16pair" | "bf16factor"
    grad_payload: str = "f32"

    @property
    def corners(self) -> int:
        return 8 if self.interp == "cube" else 4

    @property
    def row_width(self) -> int:
        if self.layout == "cell":
            return 8 * self.n_features
        return self.n_features

    @staticmethod
    def from_max_resolution(
        max_resolution: int,
        n_levels: int = 16,
        base_resolution: int = 16,
        n_features: int = 2,
        log2_hashmap_size: int = 19,
        dtype: str = "float32",
        interp: str = "cube",
        grad_mode: str = "auto",
        layout: str = "corner",
        grad_payload: str = "f32",
    ) -> "HashGridConfig":
        """per_level_scale = exp((ln max_res - ln base_res)/(L-1))."""
        s = math.exp(
            (math.log(max_resolution) - math.log(base_resolution))
            / (n_levels - 1)
        )
        return HashGridConfig(
            n_levels=n_levels,
            n_features=n_features,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution,
            per_level_scale=s,
            dtype=dtype,
            interp=interp,
            grad_mode=grad_mode,
            layout=layout,
            grad_payload=grad_payload,
        )

    @property
    def level_scales(self) -> Tuple[float, ...]:
        return tuple(
            self.base_resolution * (self.per_level_scale**l) - 1.0
            for l in range(self.n_levels)
        )

    @property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        hashmap_size = 1 << self.log2_hashmap_size
        sizes = []
        for res in self.level_resolutions:
            n_axis = res - 1 if self.layout == "cell" else res
            size = min(n_axis**3, hashmap_size)
            sizes.append((size + 7) // 8 * 8)
        return tuple(sizes)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def total_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def hashgrid_init(generator: torch.Generator, cfg: HashGridConfig,
                  device=None) -> torch.Tensor:
    """Table init U(-1e-4, 1e-4), tcnn's default for grid encodings."""
    table = torch.rand(
        (cfg.total_entries, cfg.row_width), generator=generator,
        device=device, dtype=torch.float32,
    )
    table = table * 2e-4 - 1e-4
    return table.to(getattr(torch, cfg.dtype))


def _level_indices(coords: torch.Tensor, res: int, size: int):
    """Flat table index (int64) of integer corner coords [..., 3] in
    [0, res-1] for one level: dense stride indexing when res^3 <= size,
    else the xor-prime hash masked to the power-of-two size. The hash
    is taken in int64: its low 32 bits equal the uint32 product."""
    c = coords.to(torch.int64)
    if res**3 <= size:
        return c[..., 0] + c[..., 1] * res + c[..., 2] * (res * res)
    h = c[..., 0] * _PRIMES[0]
    h = h ^ (c[..., 1] * _PRIMES[1])
    h = h ^ (c[..., 2] * _PRIMES[2])
    return h & (size - 1)


# The 8 trilinear corners: corner c = (c>>2 & 1, c>>1 & 1, c & 1).
_CORNERS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
    dtype=np.int64,
)


def _tet_ranks(frac: torch.Tensor):
    """Descending rank of each fractional coordinate with the JAX
    tie-break: rank_i = #(strictly greater) + #(equal, lower index)."""
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    rx = (fy > fx).to(torch.int64) + (fz > fx).to(torch.int64)
    ry = (fx >= fy).to(torch.int64) + (fz > fy).to(torch.int64)
    rz = (fx >= fz).to(torch.int64) + (fy >= fz).to(torch.int64)
    return torch.stack([rx, ry, rz], dim=1)


def _cube_weights(frac: torch.Tensor) -> torch.Tensor:
    """The 8 trilinear weights [N, 8] of fractions [N, 3], in the corner
    order of _CORNERS: ((w_x) * w_y) * w_z."""
    corners = torch.as_tensor(_CORNERS, device=frac.device)
    w = torch.ones((frac.shape[0], 8), dtype=torch.float32,
                   device=frac.device)
    for axis in range(3):
        on = corners[None, :, axis].bool()
        f = frac[:, None, axis]
        w = w * torch.where(on, f, 1.0 - f)
    return w


def _kuhn_weights(frac: torch.Tensor):
    """The descending ranks r [N, 3] of fractions [N, 3] and the 4 Kuhn
    simplex weights [N, 4]: 1 - f1, f1 - f2, f2 - f3, f3 for the sorted
    fractions f1 >= f2 >= f3."""
    r = _tet_ranks(frac)
    zero = torch.zeros((), dtype=torch.float32, device=frac.device)
    f1 = torch.where(r == 0, frac, zero).sum(dim=1)
    f2 = torch.where(r == 1, frac, zero).sum(dim=1)
    f3 = torch.where(r == 2, frac, zero).sum(dim=1)
    return r, torch.stack([1.0 - f1, f1 - f2, f2 - f3, f3], dim=1)


def _corner_indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """All-level corner table indices and interpolation weights.

    Returns (idx [N, L*C] int64, w [N, L*C] f32), C = 8 (cube) or 4
    (tet), in the JAX corner order.
    """
    x = x.to(torch.float32)
    corners = torch.as_tensor(_CORNERS, device=x.device)
    idx_all, w_all = [], []
    for l in range(cfg.n_levels):
        scale = torch.tensor(cfg.level_scales[l], dtype=torch.float32)
        pos = x * scale + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        base = pos_floor.to(torch.int64)
        res = cfg.level_resolutions[l]
        if cfg.interp == "cube":
            c = (base[:, None, :] + corners[None]).clamp(0, res - 1)
            w = _cube_weights(frac)
        else:
            r, w = _kuhn_weights(frac)
            e_first = (r == 0).to(torch.int64)
            e_second = (r == 1).to(torch.int64)
            c = torch.stack(
                [torch.zeros_like(base), e_first, e_first + e_second,
                 torch.ones_like(base)],
                dim=1,
            ) + base[:, None]
            c = c.clamp(0, res - 1)
        idx = _level_indices(c, res, cfg.level_sizes[l]) \
            + cfg.level_offsets[l]
        idx_all.append(idx)
        w_all.append(w)
    return torch.cat(idx_all, dim=1), torch.cat(w_all, dim=1)


def encode_plain(table: torch.Tensor, x: torch.Tensor,
                 cfg: HashGridConfig) -> torch.Tensor:
    """The plain PyTorch encode: gather the corner rows, weight, sum over
    corners. x [N, 3] -> [N, L*F] f32."""
    x = x.clamp(0.0, 1.0)
    n = x.shape[0]
    L, C, F = cfg.n_levels, cfg.corners, cfg.n_features
    idx, w = _corner_indices_weights(x, cfg)
    feats = table[idx].to(torch.float32)               # [N, L*C, F]
    out = (feats * w[..., None]).reshape(n, L, C, F).sum(dim=2)
    return out.reshape(n, L * F)


ENCODE_KERNEL = CudaKernel(
    "hashgrid_encode",
    "qf_hashgrid_encode",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="quadraturefields_tpu/ops/hashgrid_pallas.py:130",
)


def _level_arrays(cfg: HashGridConfig):
    return (
        np.asarray(cfg.level_scales, np.float32),
        np.asarray(cfg.level_resolutions, np.int32),
        np.asarray(cfg.level_sizes, np.int64),
        np.asarray(cfg.level_offsets[:-1], np.int64),
    )


def _check_x(x: torch.Tensor, cfg: HashGridConfig) -> None:
    check_cuda_tensor(x, "x", torch.float32, x.device, 2)
    if x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    if cfg.n_features not in (1, 2, 4, 8):
        raise ValueError(
            f"kernel takes F in (1, 2, 4, 8), got {cfg.n_features}")


def _launch_levels(kernel: CudaKernel, x, src, dst, cfg: HashGridConfig):
    scales, res, sizes, offsets = _level_arrays(cfg)
    kernel.launch(
        x.device, ptr(x), ptr(src), ptr(dst), x.shape[0], cfg.n_levels,
        cfg.n_features, int(cfg.interp == "tet"),
        scales.ctypes.data_as(ctypes.c_void_p),
        res.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
    )


def encode_kernel(table: torch.Tensor, x: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """Launch csrc/hashgrid_encode.cu on CUDA tensors x [N, 3] f32 and
    table [E, F] f32; returns [N, L*F] f32."""
    _check_x(x, cfg)
    check_cuda_tensor(table, "table", torch.float32, x.device, 2)
    F = cfg.n_features
    if table.shape != (cfg.total_entries, F):
        raise ValueError(
            f"table is {tuple(table.shape)}, config needs "
            f"{(cfg.total_entries, F)}"
        )
    if table.data_ptr() % (4 * F):
        raise ValueError(f"table must be {4 * F}-byte aligned")
    n = x.shape[0]
    out = torch.empty((n, cfg.output_dim), dtype=torch.float32,
                      device=x.device)
    if n:
        _launch_levels(ENCODE_KERNEL, x, table, out, cfg)
    return out


def table_grad_plain(x: torch.Tensor, g: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """The plain table gradient of the encode: w * g at every corner of
    every (point, level), summed per table row with one index_add_ (the
    JAX "exact" scatter, ops/hashgrid.py:813-829). x [N, 3], g [N, L*F]
    -> [E, F], summed in f32 (f64 for f64 g, a reference sum)."""
    n = x.shape[0]
    L, C, F = cfg.n_levels, cfg.corners, cfg.n_features
    idx, w = _corner_indices_weights(x.clamp(0.0, 1.0), cfg)
    dtype = torch.promote_types(g.dtype, torch.float32)
    g = g.to(dtype).reshape(n, L, 1, F)
    contrib = w.reshape(n, L, C, 1) * g                  # [N, L, C, F]
    d_table = torch.zeros((cfg.total_entries, F), dtype=dtype,
                          device=x.device)
    d_table.index_add_(0, idx.reshape(-1), contrib.reshape(-1, F))
    return d_table


# JAX's _hash_u01 multipliers: one per coordinate, the level's, the
# mixing round's
_HASH_X = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
_HASH_LEVEL = 0x27D4EB2F
_HASH_MIX = 0x2C1B3C6D
_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant b,
    in 16-bit halves so that no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] in f32 with XLA's bits: torch.clamp keeps
    -0.0, jnp.clip gives +0.0, and "+ 0" makes it +0.0."""
    return x.to(torch.float32).clamp(0.0, 1.0) + 0.0


def _hash_u01(x: torch.Tensor, n_levels: int) -> torch.Tensor:
    """JAX's _hash_u01 (ops/hashgrid.py:685-701), bit for bit: uniforms
    [L, N] in [0, 1) from the bit patterns of x [N, 3] f32 and the level.
    uint32 arithmetic in int64, each product masked to 32 bits."""
    xb = x.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _MASK32                               # [N, 3]
    h = (_mul32(xb[:, 0], _HASH_X[0]) ^ _mul32(xb[:, 1], _HASH_X[1])
         ^ _mul32(xb[:, 2], _HASH_X[2]))
    lv = _mul32(torch.arange(n_levels, dtype=torch.int64, device=x.device),
                _HASH_LEVEL)
    h = h[None, :] ^ lv[:, None]                                  # [L, N]
    h = h ^ (h >> 15)
    h = _mul32(h, _HASH_MIX)
    h = h ^ (h >> 12)
    return (h >> 8).to(torch.float32) * 2.0**-24


def stochastic_picks_plain(x: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """The table row [N, L] int64 that grad_mode "stochastic" picks for
    each (point, level) of x [N, 3] (ops/hashgrid.py:791-812): corner
    c = #{k < C-1 : u >= w_0 + ... + w_k}, u = _hash_u01 of the clipped
    x, the cumulative weights summed in corner order in f32."""
    n, L, C = x.shape[0], cfg.n_levels, cfg.corners
    xc = _clip01(x)
    u = _hash_u01(xc, L).T                                        # [N, L]
    idx, w = _corner_indices_weights(xc, cfg)
    idx, w = idx.reshape(n, L, C), w.reshape(n, L, C)
    cdf = torch.zeros_like(u)
    sel = torch.zeros((n, L), dtype=torch.int64, device=x.device)
    for k in range(C - 1):
        cdf = cdf + w[:, :, k]
        sel = sel + (u >= cdf).to(torch.int64)
    return torch.gather(idx, 2, sel[:, :, None])[:, :, 0]


def table_grad_stochastic_plain(x: torch.Tensor, g: torch.Tensor,
                                cfg: HashGridConfig) -> torch.Tensor:
    """The stochastic table gradient: each (point, level)'s unweighted
    cotangent g [N, L*F] added to the one row stochastic_picks_plain
    picks, with one index_add_ -> [E, F], summed in f32 (f64 for f64 g,
    a reference sum). An unbiased estimate of table_grad_plain."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    rows = stochastic_picks_plain(x, cfg)
    dtype = torch.promote_types(g.dtype, torch.float32)
    d_table = torch.zeros((cfg.total_entries, F), dtype=dtype,
                          device=x.device)
    d_table.index_add_(0, rows.reshape(-1), g.to(dtype).reshape(n * L, F))
    return d_table


ENCODE_BWD_KERNEL = CudaKernel(
    "hashgrid_encode_bwd",
    "qf_hashgrid_encode_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:54",
    library="hashgrid_encode",
)


def table_grad_kernel(x: torch.Tensor, g: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """Launch the fused table-gradient kernel of csrc/hashgrid_encode.cu
    on CUDA tensors x [N, 3] f32 and g [N, L*F] f32 -> [E, F] f32."""
    _check_x(x, cfg)
    check_cuda_tensor(g, "g", torch.float32, x.device, 2)
    if g.shape != (x.shape[0], cfg.output_dim):
        raise ValueError(f"g is {tuple(g.shape)}, expected "
                         f"{(x.shape[0], cfg.output_dim)}")
    align = 4 * min(cfg.n_features, 4)
    if g.data_ptr() % align:
        raise ValueError(f"g must be {align}-byte aligned")
    d_table = torch.zeros((cfg.total_entries, cfg.n_features),
                          dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _launch_levels(ENCODE_BWD_KERNEL, x, g, d_table, cfg)
    return d_table


ENCODE_BWD_STOCHASTIC_KERNEL = CudaKernel(
    "hashgrid_encode_bwd_stochastic",
    "qf_hashgrid_encode_bwd_stochastic",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="quadraturefields_tpu/ops/hashgrid.py:791",
    library="hashgrid_encode",
)


def table_grad_stochastic_kernel(x: torch.Tensor, g: torch.Tensor,
                                 cfg: HashGridConfig, with_picks=False):
    """Launch the stochastic table gradient of csrc/hashgrid_encode.cu on
    CUDA tensors x [N, 3] f32 and g [N, L*F] f32 -> [E, F] f32; with
    `with_picks`, (gradient, the picked rows [N, L] int64)."""
    _check_x(x, cfg)
    check_cuda_tensor(g, "g", torch.float32, x.device, 2)
    n, L = x.shape[0], cfg.n_levels
    if g.shape != (n, cfg.output_dim):
        raise ValueError(f"g is {tuple(g.shape)}, expected "
                         f"{(n, cfg.output_dim)}")
    align = 4 * min(cfg.n_features, 4)
    if g.data_ptr() % align:
        raise ValueError(f"g must be {align}-byte aligned")
    d_table = torch.zeros((cfg.total_entries, cfg.n_features),
                          dtype=torch.float32, device=x.device)
    picks = (torch.empty((n, L), dtype=torch.int64, device=x.device)
             if with_picks else None)
    if n:
        scales, res, sizes, offsets = _level_arrays(cfg)
        ENCODE_BWD_STOCHASTIC_KERNEL.launch(
            x.device, ptr(x), ptr(g), ptr(d_table),
            ctypes.c_void_p(0 if picks is None else picks.data_ptr()), n, L,
            cfg.n_features, int(cfg.interp == "tet"),
            *(a.ctypes.data_as(ctypes.c_void_p)
              for a in (scales, res, sizes, offsets)))
    return (d_table, picks) if with_picks else d_table


# ---- cell layout (JAX ops/hashgrid.py:286-634) ----

def _cell_levels(x: torch.Tensor, cfg: HashGridConfig):
    """Per level: (cell row index [N] int64, cell fraction [N, 3] f32
    clipped to [0, 1]). The cell is clipped to the grid, so a point on
    the upper face interpolates to the boundary corner."""
    x = x.to(torch.float32)
    for l in range(cfg.n_levels):
        scale = torch.tensor(cfg.level_scales[l], dtype=torch.float32)
        pos = x * scale + 0.5
        n_axis = cfg.level_resolutions[l] - 1          # cells per axis
        cell = torch.floor(pos).to(torch.int64).clamp(0, n_axis - 1)
        frac = (pos - cell.to(torch.float32)).clamp(0.0, 1.0)
        idx = _level_indices(cell, n_axis, cfg.level_sizes[l]) \
            + cfg.level_offsets[l]
        yield idx, frac


def _cell_kuhn(frac: torch.Tensor):
    """The Kuhn simplex of each cell fraction: weights wk [N, 4] in the
    corner order (0, s1, s2, 7) and the two dynamic corner slots s1, s2
    [N] int32 (slot id = i*4 + j*2 + k; s1 in {1, 2, 4}, s2 in
    {3, 5, 6})."""
    r, wk = _kuhn_weights(frac)
    bit = torch.tensor([4, 2, 1], dtype=torch.int64, device=frac.device)
    s1 = ((r == 0).to(torch.int64) * bit).sum(dim=1)
    s2 = ((r <= 1).to(torch.int64) * bit).sum(dim=1)
    return wk, s1.to(torch.int32), s2.to(torch.int32)


def _cell_w8(frac: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """The 8 dense corner weights [N, 8] of one level's cell fractions:
    slot c = i*4 + j*2 + k holds corner (i, j, k), the order of
    _CORNERS. "tet" places the 4 Kuhn weights in their slots and zeros
    in the other 4."""
    if cfg.interp == "cube":
        return _cube_weights(frac)
    wk, s1, s2 = _cell_kuhn(frac)
    slots = torch.stack([torch.zeros_like(s1), s1, s2,
                         torch.full_like(s1, 7)], dim=1)
    return torch.zeros((frac.shape[0], 8), dtype=torch.float32,
                       device=frac.device).scatter(1, slots.long(), wk)


def _cell_indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """One table row per (point, level) and its 8 dense corner weights.

    Returns (idx [N, L] int64, w8 [N, L*8] f32), as _cell_w8 per level.
    """
    idx_all, w_all = [], []
    for idx, frac in _cell_levels(x, cfg):
        idx_all.append(idx[:, None])
        w_all.append(_cell_w8(frac, cfg))
    return torch.cat(idx_all, dim=1), torch.cat(w_all, dim=1)


def _cell_tet_levels(x: torch.Tensor, cfg: HashGridConfig):
    """Row index [N, L] and the sparse Kuhn data of every (point,
    level): wk [N, L, 4] and the dynamic slots s1, s2 [N, L] int32."""
    idx, wk, s1, s2 = [], [], [], []
    for i, frac in _cell_levels(x, cfg):
        w, a, b = _cell_kuhn(frac)
        idx.append(i)
        wk.append(w)
        s1.append(a)
        s2.append(b)
    return (torch.stack(idx, dim=1), torch.stack(wk, dim=1),
            torch.stack(s1, dim=1), torch.stack(s2, dim=1))


def _cell_tet_sparse(x: torch.Tensor, cfg: HashGridConfig):
    """(wk [N, L, 4], s1 [N, L], s2 [N, L]), as JAX's _cell_tet_sparse."""
    return _cell_tet_levels(x, cfg)[1:]


CELL_FACTOR_GRAD_X_KERNEL = CudaKernel(
    "cell_factor_grad",
    "qf_cell_factor_grad_x",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:301",
    library="cell_factor_grad",
)


def tet_factor_grad_x_plain(x: torch.Tensor, g: torch.Tensor,
                            cfg: HashGridConfig) -> torch.Tensor:
    """K7's function from positions: the cell table gradient [E, 8F] of
    x [N, 3] in [0, 1] and the cotangent g [N, L*F] with the bf16 factor
    payload (hashgrid_sorted.factor_rows), level by level: each level's
    cell rows and Kuhn weights (_cell_levels, _cell_kuhn), its [N, 8F]
    contribution rows, one index_add_. The same sums, in the same order
    per row, as the stream route `sorted_tet_factor_grad` on
    `_cell_tet_levels` (levels own disjoint rows). Sums in f32 (f64 for
    f64 g, a reference sum)."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    dtype = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros((cfg.total_entries, 8 * F), dtype=dtype,
                      device=x.device)
    g3 = g.reshape(n, L, F)
    for l, (idx, frac) in enumerate(_cell_levels(x, cfg)):
        wk, s1, s2 = _cell_kuhn(frac)
        out.index_add_(0, idx, hashgrid_sorted.factor_rows(wk, s1, s2,
                                                           g3[:, l]))
    return out


# the F that the fused cell table gradients (K7, K5) take
CELL_GRAD_X_FEATURES = (2, 4, 8, 16)


def launch_cell_grad_x(kernel: CudaKernel, x: torch.Tensor,
                       g: torch.Tensor, cfg: HashGridConfig,
                       *extra) -> torch.Tensor:
    """Launch a fused cell table gradient of csrc/cell_grad.cuh's
    interface (K7's or K5's entry, or another checkout's build of one)
    on CUDA tensors x [N, 3] f32 and g [N, L*F] f32, F in
    CELL_GRAD_X_FEATURES, with the entry's `extra` int arguments after
    the row count -> [E, 8F] f32."""
    check_cuda_tensor(x, "x", torch.float32, x.device, 2)
    check_cuda_tensor(g, "g", torch.float32, x.device, 2)
    n, F, E = x.shape[0], cfg.n_features, cfg.total_entries
    if x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    if g.shape != (n, cfg.output_dim):
        raise ValueError(f"g is {tuple(g.shape)}, expected "
                         f"{(n, cfg.output_dim)}")
    if F not in CELL_GRAD_X_FEATURES:
        raise ValueError(f"F = {F} not in {CELL_GRAD_X_FEATURES}")
    if E >= 2**31:
        raise ValueError(f"{E} rows: the kernel takes < 2^31")
    if g.data_ptr() % (8 if F == 2 else 16):
        raise ValueError(f"g must be {8 if F == 2 else 16}-byte aligned")
    out = torch.zeros((E, 8 * F), dtype=torch.float32, device=x.device)
    if n:
        scales, res, sizes, offsets = _level_arrays(cfg)
        n_axis = res - 1
        kernel.launch(
            x.device, ptr(x), ptr(g), ptr(out), n, cfg.n_levels, F,
            *(a.ctypes.data_as(ctypes.c_void_p)
              for a in (scales, n_axis, sizes, offsets)), E, *extra)
    return out


def tet_factor_grad_x_kernel(x: torch.Tensor, g: torch.Tensor,
                             cfg: HashGridConfig) -> torch.Tensor:
    """Launch the fused K7 (csrc/cell_factor_grad.cu) on CUDA tensors x
    [N, 3] f32 in [0, 1] and g [N, L*F] f32, F in CELL_GRAD_X_FEATURES
    -> [E, 8F] f32."""
    return launch_cell_grad_x(CELL_FACTOR_GRAD_X_KERNEL, x, g, cfg)


def tet_factor_grad_x(x: torch.Tensor, g: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """The cell table gradient on K7's route (tet, bf16 factor payload)
    from positions x [N, 3] in [0, 1] and the cotangent g [N, L*F] f32:
    the fused kernel for CUDA tensors, its plain version on the CPU."""
    if x.device.type == "cpu":
        return tet_factor_grad_x_plain(x, g, cfg)
    return tet_factor_grad_x_kernel(x, g, cfg)


CELL_ROW_GRAD_X_KERNEL = CudaKernel(
    "cell_row_grad_x",
    "qf_cell_row_grad_x",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:175",
    library="cell_table_grad",
)


def _cell_rows_plain(x: torch.Tensor, g: torch.Tensor,
                     cfg: HashGridConfig, bf16: bool) -> torch.Tensor:
    """The cell table gradient [E, 8F] of x [N, 3] and the cotangent g
    [N, L*F] from f32 contribution rows, level by level: each level's
    cell rows and 8 dense weights (_cell_levels, _cell_w8), its [N, 8F]
    rows w8[c] * g[f] at column c*F + f, each rounded to bf16 when
    `bf16`, and one index_add_. The products are taken in f32, as the
    kernels take them, and summed in f32 (f64 for f64 g, a reference
    sum; its values are f32's)."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    dtype = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros((cfg.total_entries, 8 * F), dtype=dtype,
                      device=x.device)
    g3 = g.to(torch.float32).reshape(n, L, 1, F)
    for l, (idx, frac) in enumerate(_cell_levels(x, cfg)):
        rows = (_cell_w8(frac, cfg)[:, :, None] * g3[:, l]).reshape(n, 8 * F)
        if bf16:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        out.index_add_(0, idx, rows.to(dtype))
    return out


def cell_row_grad_x_plain(x: torch.Tensor, g: torch.Tensor,
                          cfg: HashGridConfig) -> torch.Tensor:
    """K5's function from positions: the cell table gradient [E, 8F] of
    x [N, 3] and the cotangent g [N, L*F] on the rows route, the rows
    rounded to bf16 for the "bf16sim" payload (_cell_rows_plain). The
    same sums, in the same order per row, as the stream route
    (_cell_indices_weights, the [N*L, 8F] rows, sorted_row_grad; levels
    own disjoint rows)."""
    return _cell_rows_plain(x, g, cfg, cfg.grad_payload == "bf16sim")


def cell_row_grad_x_kernel(x: torch.Tensor, g: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """Launch K5's fused entry (csrc/cell_table_grad.cu) on CUDA tensors x
    [N, 3] f32 and g [N, L*F] f32, F in CELL_GRAD_X_FEATURES -> [E, 8F]
    f32; tet or cube weights by cfg.interp, products rounded to bf16 for
    the "bf16sim" payload."""
    return launch_cell_grad_x(CELL_ROW_GRAD_X_KERNEL, x, g, cfg,
                              int(cfg.interp == "tet"),
                              int(cfg.grad_payload == "bf16sim"))


def cell_row_grad_x(x: torch.Tensor, g: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """The cell table gradient on K5's route from positions x [N, 3] and
    the cotangent g [N, L*F] f32: the fused kernel for CUDA tensors, its
    plain version on the CPU."""
    if x.device.type == "cpu":
        return cell_row_grad_x_plain(x, g, cfg)
    return cell_row_grad_x_kernel(x, g, cfg)


CELL_PAIR_GRAD_X_KERNEL = CudaKernel(
    "cell_pair_grad_x",
    "qf_cell_pair_grad_x",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int],
    replaces="quadraturefields_tpu/ops/hashgrid_sorted.py:238",
    library="cell_table_grad",
)


def cell_pair_grad_x_plain(x: torch.Tensor, g: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """K6's function from positions: the cell table gradient [E, 8F] of
    x [N, 3] and the cotangent g [N, L*F] on the bf16pair route. K6's
    lo/hi pair lane c*F/2 + p carries bf16(w8[c] * g[2p]) and
    bf16(w8[c] * g[2p + 1]) into columns c*F + 2p and c*F + 2p + 1, so
    these are the rows of K5's bf16sim payload (_cell_rows_plain with
    every product rounded to bf16), whatever cfg.grad_payload says. The
    same sums, in the same order per row, as the lo/hi stream route
    (_cell_indices_weights, then sorted_pair_grad)."""
    return _cell_rows_plain(x, g, cfg, bf16=True)


def cell_pair_grad_x_kernel(x: torch.Tensor, g: torch.Tensor,
                            cfg: HashGridConfig) -> torch.Tensor:
    """Launch K6's fused entry (csrc/cell_table_grad.cu) on CUDA tensors
    x [N, 3] f32 and g [N, L*F] f32, F in CELL_GRAD_X_FEATURES -> [E, 8F]
    f32; tet or cube weights by cfg.interp, every product rounded to
    bf16."""
    return launch_cell_grad_x(CELL_PAIR_GRAD_X_KERNEL, x, g, cfg,
                              int(cfg.interp == "tet"))


def cell_pair_grad_x(x: torch.Tensor, g: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """The cell table gradient on K6's route from positions x [N, 3] and
    the cotangent g [N, L*F] f32: the fused kernel for CUDA tensors, its
    plain version on the CPU."""
    if x.device.type == "cpu":
        return cell_pair_grad_x_plain(x, g, cfg)
    return cell_pair_grad_x_kernel(x, g, cfg)


def encode_cell_plain(table: torch.Tensor, x: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """The cell-layout encode: per level one gather of the [N, 8F] cell
    rows and the weighted sum over the 8 corners. x [N, 3] -> [N, L*F]
    f32. Plain PyTorch on every device."""
    x = x.clamp(0.0, 1.0)
    n, F = x.shape[0], cfg.n_features
    idx, w8 = _cell_indices_weights(x, cfg)
    outs = []
    for l in range(cfg.n_levels):
        rows = table[idx[:, l]].to(torch.float32).reshape(n, 8, F)
        outs.append((rows * w8[:, 8 * l:8 * l + 8, None]).sum(dim=1))
    return torch.cat(outs, dim=1)


def _cell_grad_route(cfg: HashGridConfig, n: int, on_card: bool) -> str:
    """Which segment sum the cell table gradient of n points takes, as
    JAX's `_cell_bwd` routes it (ops/hashgrid.py:513-604): "factor"
    (K7), "pair" (K6) or "rows" (K5). "auto" is "sorted" on the card
    (JAX: on an accelerator) unless the table outweighs the stream
    (3 * E > n * L), else "exact"; every mode but "sorted" is "exact".
    Only "sorted" reaches the bf16 factor and pair payloads; the rest
    (f32, bf16sim, and the F = 2 or cube bf16factor requests) sum f32
    contribution rows, which is the same function in both modes."""
    mode, F = cfg.grad_mode, cfg.n_features
    if mode == "auto":
        sweep_heavy = cfg.total_entries * 3 > n * cfg.n_levels
        mode = "sorted" if (on_card and not sweep_heavy) else "exact"
    if mode != "sorted":
        return "rows"
    if (cfg.grad_payload == "bf16factor" and cfg.interp == "tet"
            and F >= 4 and F % 2 == 0):
        return "factor"
    if cfg.grad_payload == "bf16pair" and F % 2 == 0:
        return "pair"
    return "rows"


def _cell_table_grad(x, g, cfg: HashGridConfig):
    """The cell table gradient [E, 8F] f32 of clamped x [N, 3] and the
    output's cotangent g [N, L*F] f32, on the route of
    _cell_grad_route. The rows and pair routes take K5's and K6's fused
    entries for F in CELL_GRAD_X_FEATURES and their stream entries for
    any other F; the streams' contributions are point-major (n, l)."""
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    E = cfg.total_entries
    g2 = g.reshape(n * L, F)
    route = _cell_grad_route(cfg, n, on_card=x.device.type == "cuda")
    if route == "factor":
        return tet_factor_grad_x(x, g, cfg)
    if F in CELL_GRAD_X_FEATURES:
        if route == "rows":
            return cell_row_grad_x(x, g, cfg)
        return cell_pair_grad_x(x, g, cfg)
    idx, w8 = _cell_indices_weights(x, cfg)
    w8 = w8.reshape(n * L, 8, 1)
    if route == "pair":
        # lane k = c * F/2 + p carries feature 2p (lo) and 2p + 1 (hi)
        lo = (w8 * g2[:, None, 0::2]).reshape(n * L, 4 * F)
        hi = (w8 * g2[:, None, 1::2]).reshape(n * L, 4 * F)
        return hashgrid_sorted.sorted_pair_grad(idx.reshape(-1), lo, hi, E)
    contrib = (w8 * g2[:, None, :]).reshape(n * L, 8 * F)
    if cfg.grad_payload == "bf16sim":
        contrib = contrib.to(torch.bfloat16).to(torch.float32)
    return hashgrid_sorted.sorted_row_grad(idx.reshape(-1), contrib, E)


def _encode_forward(table, x, cfg: HashGridConfig):
    if cfg.layout == "cell":
        return encode_cell_plain(table, x, cfg)
    if x.device.type == "cpu":
        return encode_plain(table, x, cfg)
    return encode_kernel(table, x, cfg)


def _table_grad(x, g, cfg: HashGridConfig):
    if cfg.layout == "cell":
        return _cell_table_grad(x, g, cfg)
    if cfg.grad_mode == "stochastic":
        if x.device.type == "cpu":
            return table_grad_stochastic_plain(x, g, cfg)
        return table_grad_stochastic_kernel(x, g, cfg)
    if x.device.type == "cpu":
        return table_grad_plain(x, g, cfg)
    return table_grad_kernel(x, g, cfg)


def _indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """(rows, weights) of either layout: the corner rows [N, L*C] and
    weights [N, L*C] (_corner_indices_weights), or the cell rows [N, L]
    and their 8 dense corner weights [N, L*8] (_cell_indices_weights)."""
    if cfg.layout == "cell":
        return _cell_indices_weights(x, cfg)
    return _corner_indices_weights(x, cfg)


def scatter_rows(idx, vals, cfg: HashGridConfig):
    """The table-shaped sum of per-corner contributions vals [N, L, C, F]
    f32 at the rows idx of _indices_weights -> [E, row width] f32: in
    the cell layout the [N*L, 8F] rows go to K5's stream entry
    (sorted_row_grad), in the corner layout the contributions go to K1's
    stream interface (sorted_table_grad), which sums feature pairs, so
    an odd F raises. A kernel on the card, its plain version on the
    CPU."""
    n, L, F = idx.shape[0], cfg.n_levels, cfg.n_features
    E = cfg.total_entries
    if cfg.layout == "cell":
        return hashgrid_sorted.sorted_row_grad(
            idx.reshape(-1), vals.reshape(n * L, 8 * F), E)
    if F % 2:
        raise ValueError(f"the corner table gradient of a stream sums "
                         f"feature pairs (K1's stream interface): F = {F} "
                         f"is odd")
    # row r's feature pair p is entry r * F/2 + p of an [E * F/2, 2] table
    pairs = F // 2
    entry = (idx.reshape(-1, 1) * pairs
             + torch.arange(pairs, device=idx.device)).reshape(-1)
    vals = vals.reshape(-1, 2)
    out = hashgrid_sorted.sorted_table_grad(
        entry, vals[:, 0].contiguous(), vals[:, 1].contiguous(), E * pairs)
    return out.reshape(E, F)


class _GatherRows(torch.autograd.Function):
    """The f32 features [N, L, C, F] of every corner of every (point,
    level) at the rows of _indices_weights (C = 8 in the cell layout,
    the corner slots of each cell row), with the table gradient summed
    by scatter_rows; differentiable to any order (_ScatterRows)."""

    @staticmethod
    def forward(ctx, table, idx, cfg):
        ctx.cfg, ctx.dtype = cfg, table.dtype
        ctx.save_for_backward(idx)
        n, L, F = idx.shape[0], cfg.n_levels, cfg.n_features
        return table[idx].to(torch.float32).reshape(n, L, -1, F)

    @staticmethod
    def backward(ctx, v):
        (idx,) = ctx.saved_tensors
        return (_ScatterRows.apply(v, idx, ctx.cfg).to(ctx.dtype), None,
                None)


class _ScatterRows(torch.autograd.Function):
    """scatter_rows with its adjoint, the gather, as its gradient."""

    @staticmethod
    def forward(ctx, vals, idx, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(idx)
        return scatter_rows(idx, vals.contiguous(), cfg)

    @staticmethod
    def backward(ctx, v):
        (idx,) = ctx.saved_tensors
        return _GatherRows.apply(v, idx, ctx.cfg), None, None


def _dl_dw(table, idx, g, cfg: HashGridConfig) -> torch.Tensor:
    """dL/dw [N, L*C] = sum_f table[row_c, f] * g[f] per corner of every
    (point, level): the cotangent of the interpolation weights."""
    n, L, F = idx.shape[0], cfg.n_levels, cfg.n_features
    feats = _GatherRows.apply(table, idx, cfg)
    return (feats * g.to(torch.float32).reshape(n, L, 1, F)).sum(dim=3) \
        .reshape(n, -1)


def _position_grad(table, x, g, cfg: HashGridConfig):
    """dL/dx through the interpolation weights (ops/hashgrid.py:830-842,
    the cell layout's :613-633): dL/dw (_dl_dw) pulled back through the
    weights' dependence on x by autograd, as JAX does with jax.vjp. x is
    the clamped input, and the weights clamp it again. Payload-
    independent."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        idx, w = _indices_weights(xx.clamp(0.0, 1.0), cfg)
        (d_x,) = torch.autograd.grad(w, xx, _dl_dw(table.detach(), idx, g,
                                                   cfg))
    return d_x


def _weights_jvp(x: torch.Tensor, u: torch.Tensor, cfg: HashGridConfig):
    """(rows, s) of x [N, 3]: the rows of _indices_weights and s = (dw/dx)
    u [N, L*C], the derivative of every interpolation weight along u
    [N, 3] in the same layout, by forward-mode autograd through the
    weights; differentiable in x and u by reverse mode."""
    def weights(xx):
        idx, w = _indices_weights(xx.clamp(0.0, 1.0), cfg)
        return w, idx

    _, s, idx = torch.func.jvp(weights, (x,), (u.to(torch.float32),),
                               has_aux=True)
    return idx, s


def _wanted(ctx, i: int) -> bool:
    """Whether the running backward pass needs the gradient of the
    Function's input i: autograd.grad(field, x) asks for no table
    gradient, a backward(inputs=params) for no position gradient. The
    engine answers for nodes that are not leaves (hashgrid_encode hands
    the Function views of leaves); for a leaf under autograd.grad it
    cannot, and the gradient is computed."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    try:
        return node is None or torch._C._will_engine_execute_node(node)
    except RuntimeError:
        return True


def _encode_grads(table, x, g, cfg: HashGridConfig, want_table: bool,
                  want_x: bool):
    """The encode's VJP at clamped x [N, 3] for the cotangent g [N, L*F]
    f32: (dL/dtable [E, row width] or None, dL/dx [N, 3] or None)."""
    d_table = _table_grad(x, g, cfg).to(table.dtype) if want_table else None
    d_x = _position_grad(table, x, g, cfg) if want_x else None
    return d_table, d_x


class _HashGridEncodeGrad(torch.autograd.Function):
    """The encode's VJP as a differentiable function of (table, x, g):
    its forward is _encode_grads (the fused table gradient and the
    position gradient). Its backward takes the cotangents u of dL/dx and
    U of dL/dtable and returns the gradients in (table, x, g) of
    psi = <u, dL/dx> + <U, dL/dtable> = sum s * dL/dw + sum w * dL/dw(U),
    s = (dw/dx) u (_weights_jvp), by autograd through the weights and
    _GatherRows, as JAX differentiates its custom VJP (ops/hashgrid.py
    :705-842) and tiny-cuda-nn's grid encoding computes
    backward_backward_input:
      table: s[l, c] * g[l, f] at each corner row, s = (dw/dx) u, a
             segment sum on the card (scatter_rows);
      g:     sum_c s[l, c] * table[row_c, f], plus the encode of U at x;
      x:     the weights' second derivative against dL/dw along u, plus
             U's dL/dw pulled back through the weights (zero almost
             everywhere for tet weights in the first term).
    Under create_graph these are differentiable again (the third order,
    as the params gradient of field_double_grad under back_prop=True)."""

    @staticmethod
    def forward(ctx, table, x, g, cfg, want_table, want_x):
        ctx.cfg = cfg
        ctx.save_for_backward(table, x, g)
        return _encode_grads(table, x, g, cfg, want_table, want_x)

    @staticmethod
    def backward(ctx, u_table, u_x):
        cfg, create = ctx.cfg, torch.is_grad_enabled()
        want = [_wanted(ctx, i) for i in range(3)]
        # the saved tensors themselves under create_graph, so that the
        # gradients stay in the graph; else fresh leaves where wanted
        table, x, g = (t if create and t.requires_grad
                       else t.detach().requires_grad_(need)
                       for t, need in zip(ctx.saved_tensors, want))
        with torch.enable_grad():
            psi = []
            if u_x is not None:
                idx, s = _weights_jvp(x, u_x, cfg)
                psi.append((s * _dl_dw(table, idx, g, cfg)).sum())
            if u_table is not None:
                idx, w = _indices_weights(x.clamp(0.0, 1.0), cfg)
                psi.append((w * _dl_dw(u_table, idx, g, cfg)).sum())
            psi = sum(psi)
            inputs = [t for t, need in zip((table, x, g), want) if need]
            grads = iter(torch.autograd.grad(
                psi, inputs, create_graph=create, allow_unused=True)
                if inputs and psi.requires_grad else ())
        return (*(next(grads, None) if need else None for need in want),
                None, None, None)


class _HashGridEncode(torch.autograd.Function):
    """Encode with its VJP: the table gradient (a kernel on the card)
    and the position gradient, each only where the backward pass needs
    it. The VJP is _HashGridEncodeGrad, a Function of its own, so under
    create_graph the position gradient can be differentiated again
    (back_prop=True of the quadrature field)."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(table, x)
        return _encode_forward(table, x.clamp(0.0, 1.0).contiguous(), cfg)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.to(torch.float32).contiguous()
        want_table, want_x = _wanted(ctx, 0), _wanted(ctx, 1)
        xc = x.clamp(0.0, 1.0).contiguous()
        d_table, d_x = _HashGridEncodeGrad.apply(table, xc, g, cfg,
                                                 want_table, want_x)
        return d_table, d_x, None


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions x [N, 3] in [0,1]^3 -> features [N, L*F] f32.

    Out-of-range coordinates clamp to the unit cube. CUDA tensors go
    through the kernels, CPU tensors through the plain versions.
    Differentiable in `table` and `x`.
    """
    if cfg.layout not in ("corner", "cell"):
        raise ValueError(f"unknown layout: {cfg.layout!r}")
    if cfg.grad_mode not in ("auto", "exact", "sorted", "stochastic"):
        raise ValueError(f"unknown grad_mode: {cfg.grad_mode!r}")
    if not (torch.is_grad_enabled()
            and (table.requires_grad or x.requires_grad)):
        return _encode_forward(table, x, cfg)
    # views, so that the engine can say which gradients a pass needs
    return _HashGridEncode.apply(table.view_as(table), x.view_as(x), cfg)


def hashgrid_encode_batched(table, x, cfg: HashGridConfig,
                            chunk: int = 2**20):
    """Chunked encode for very large point sets (dense grid export)."""
    n = x.shape[0]
    if n <= chunk:
        return hashgrid_encode(table, x, cfg)
    pieces = [hashgrid_encode(table, x[i:i + chunk], cfg)
              for i in range(0, n, chunk)]
    return torch.cat(pieces, dim=0)
