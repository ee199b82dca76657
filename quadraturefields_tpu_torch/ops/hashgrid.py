"""Multiresolution hash-grid encoding (instant-NGP style), PyTorch port.

Port of quadraturefields_tpu/ops/hashgrid.py, corner layout:
`HashGridConfig` and its level math (tcnn's formula
scale_l = N_min * growth^l - 1, res_l = ceil(scale_l) + 1, dense levels
padded to a multiple of 8, hashed levels 2^log2_T rows), the table init,
the dense / xor-prime-hash level indexing, cube and Kuhn-tet corner
weights, and the encode with its gradient.

`hashgrid_encode` is differentiable in the table and in x. For tensors
on the card its forward launches csrc/hashgrid_encode.cu
(`qf_hashgrid_encode`) and its table gradient the fused kernel of the
same file (`qf_hashgrid_encode_bwd`); for CPU tensors both run their
plain PyTorch versions, `encode_plain` and `table_grad_plain`. The cell
layout is not ported yet.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._cuda import CudaKernel, check_cuda_tensor, ptr

# tcnn spatial-hash primes (the first coordinate is unmultiplied).
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Same fields and defaults as the JAX config, so configs carry over.
    `grad_mode` "auto", "exact" and "sorted" all give the exact table
    gradient (one kernel on the card); "stochastic" is not ported yet.
    `grad_payload` matters only to the cell layout."""

    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865
    dtype: str = "float32"
    interp: str = "cube"      # "cube" (8 corners) | "tet" (Kuhn, 4)
    grad_mode: str = "auto"
    layout: str = "corner"    # "corner" | "cell" (not ported yet)
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


def _corner_indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """All-level corner table indices and interpolation weights.

    Returns (idx [N, L*C] int64, w [N, L*C] f32), C = 8 (cube) or 4
    (tet), in the JAX corner order.
    """
    n = x.shape[0]
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
            w = torch.ones((n, 8), dtype=torch.float32, device=x.device)
            for axis in range(3):
                on = corners[None, :, axis].bool()
                f = frac[:, None, axis]
                w = w * torch.where(on, f, 1.0 - f)
        else:
            r = _tet_ranks(frac)
            e_first = (r == 0).to(torch.int64)
            e_second = (r == 1).to(torch.int64)
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            f1 = torch.where(r == 0, frac, zero).sum(dim=1)
            f2 = torch.where(r == 1, frac, zero).sum(dim=1)
            f3 = torch.where(r == 2, frac, zero).sum(dim=1)
            w = torch.stack([1.0 - f1, f1 - f2, f2 - f3, f3], dim=1)
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
    if g.data_ptr() % 8:
        raise ValueError("g must be 8-byte aligned")
    d_table = torch.zeros((cfg.total_entries, cfg.n_features),
                          dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _launch_levels(ENCODE_BWD_KERNEL, x, g, d_table, cfg)
    return d_table


def _encode_forward(table, x, cfg: HashGridConfig):
    if x.device.type == "cpu":
        return encode_plain(table, x, cfg)
    return encode_kernel(table, x, cfg)


def _table_grad(x, g, cfg: HashGridConfig):
    if x.device.type == "cpu":
        return table_grad_plain(x, g, cfg)
    return table_grad_kernel(x, g, cfg)


def _position_grad(table, x, g, cfg: HashGridConfig):
    """dL/dx through the interpolation weights (ops/hashgrid.py:830-842):
    dL/dw[c] = sum_f table[row_c, f] * g[f], pulled back through the
    weights' dependence on x by autograd, as JAX does with jax.vjp. x is
    the clamped input, and the weights clamp it again."""
    n = x.shape[0]
    L, C, F = cfg.n_levels, cfg.corners, cfg.n_features
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        idx, w = _corner_indices_weights(xx.clamp(0.0, 1.0), cfg)
        feats = table.detach()[idx].to(torch.float32)      # [N, L*C, F]
        g3 = g.to(torch.float32).reshape(n, L, 1, F)
        dl_dw = (feats.reshape(n, L, C, F) * g3).sum(dim=3)
        (d_x,) = torch.autograd.grad(w, xx, dl_dw.reshape(n, L * C))
    return d_x


class _HashGridEncode(torch.autograd.Function):
    """Encode with its VJP: the table gradient (the fused kernel on the
    card) and, only when asked for, the position gradient."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        xc = x.clamp(0.0, 1.0).contiguous()
        ctx.cfg = cfg
        ctx.save_for_backward(table, xc)
        return _encode_forward(table, xc, cfg)

    @staticmethod
    def backward(ctx, g):
        table, xc = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.to(torch.float32).contiguous()
        d_table = d_x = None
        if ctx.needs_input_grad[0]:
            d_table = _table_grad(xc, g, cfg).to(table.dtype)
        if ctx.needs_input_grad[1]:
            d_x = _position_grad(table, xc, g, cfg)
        return d_table, d_x, None


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions x [N, 3] in [0,1]^3 -> features [N, L*F] f32.

    Out-of-range coordinates clamp to the unit cube. CUDA tensors go
    through the kernels, CPU tensors through the plain versions.
    Differentiable in `table` and `x`.
    """
    if cfg.layout != "corner":
        raise NotImplementedError("the cell layout is not ported yet")
    if cfg.grad_mode not in ("auto", "exact", "sorted", "stochastic"):
        raise ValueError(f"unknown grad_mode: {cfg.grad_mode!r}")
    if not (torch.is_grad_enabled()
            and (table.requires_grad or x.requires_grad)):
        return _encode_forward(table, x, cfg)
    if cfg.grad_mode == "stochastic":
        raise NotImplementedError(
            'grad_mode "stochastic" is not ported yet')
    return _HashGridEncode.apply(table, x, cfg)


def hashgrid_encode_batched(table, x, cfg: HashGridConfig,
                            chunk: int = 2**20):
    """Chunked encode for very large point sets (dense grid export)."""
    n = x.shape[0]
    if n <= chunk:
        return hashgrid_encode(table, x, cfg)
    pieces = [hashgrid_encode(table, x[i:i + chunk], cfg)
              for i in range(0, n, chunk)]
    return torch.cat(pieces, dim=0)
