"""Instant-NGP radiance fields (SG-appearance, plain and density-only).

Port of quadraturefields_tpu/models/ngp.py. Parameters are the same
plain dict as the JAX `ngp_init` tree: {"table": [E, F] (corner layout)
or [E, 8F] (cell layout), "mlp_base": {"layers": [...]}, "mlp_head":
{"layers": [...]}}, so utils/convert.py carries JAX weights across
unchanged. The cell layout counts log2_hashmap_size in corners, as JAX
does: its grid gets 2^(log2_T - 3) rows a hashed level, the same
parameter budget. Matmuls run in
the config's compute dtype with f32 results (ops/mlp.py); density and
compositing math stays f32.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.activations import contract_to_unisphere, density_activation
from ..ops.hashgrid import HashGridConfig, hashgrid_encode, hashgrid_init
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.sh import spherical_harmonics_deg4


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    # "sg" shared-axis lobes | "sg_old" per-channel lobes | "mlp" | "none"
    head: str = "sg"
    num_dim: int = 3
    use_viewdirs: bool = False
    unbounded: bool = False
    base_resolution: int = 16
    max_resolution: int = 4096
    geo_feat_dim: int = 15
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    num_g_lobes: int = 3
    hidden_size: int = 64
    num_layers: int = 2  # hidden layers in the head decoder
    discretize: bool = False
    compute_dtype: str = "bfloat16"
    table_dtype: str = "float32"
    interp: str = "cube"
    grad_mode: str = "auto"
    layout: str = "corner"
    grad_payload: str = "f32"

    @property
    def hashgrid(self) -> HashGridConfig:
        log2_t = self.log2_hashmap_size
        if self.layout == "cell":
            log2_t = max(log2_t - 3, 4)
        return HashGridConfig.from_max_resolution(
            self.max_resolution,
            n_levels=self.n_levels,
            base_resolution=self.base_resolution,
            n_features=self.n_features,
            log2_hashmap_size=log2_t,
            dtype=self.table_dtype,
            interp=self.interp,
            grad_mode=self.grad_mode,
            layout=self.layout,
            grad_payload=self.grad_payload,
        )

    @property
    def head_output_dim(self) -> int:
        if self.head == "sg":
            return 3 + self.num_g_lobes * 7
        if self.head == "sg_old":
            return 3 + self.num_g_lobes * 15
        if self.head == "mlp":
            return 3
        return 0

    @property
    def dir_enc_dim(self) -> int:
        return 16 if self.use_viewdirs else 0

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def density_field_config(**kw) -> NGPConfig:
    """NGPDensityField defaults (reference ngp.py:815-825): no head, a
    5-level 2^17 grid to resolution 128, density only."""
    base = dict(
        head="none", max_resolution=128, n_levels=5, log2_hashmap_size=17,
        geo_feat_dim=0,
    )
    base.update(kw)
    return NGPConfig(**base)


def ngp_init(generator: torch.Generator, cfg: NGPConfig, device=None):
    """Table U(-1e-4, 1e-4); tcnn-style bias-free 64-wide base MLP with
    one hidden layer; the head decoder per `cfg.head`."""
    params = {
        "table": hashgrid_init(generator, cfg.hashgrid, device),
        "mlp_base": mlp_init(
            generator, cfg.hashgrid.output_dim, 1 + cfg.geo_feat_dim,
            hidden_dim=64, num_hidden_layers=1, bias=False, device=device,
        ),
    }
    if cfg.head in ("sg", "sg_old"):
        params["mlp_head"] = mlp_init(
            generator, cfg.dir_enc_dim + cfg.geo_feat_dim,
            cfg.head_output_dim, hidden_dim=cfg.hidden_size,
            num_hidden_layers=cfg.num_layers, bias=True, device=device,
        )
    elif cfg.head == "mlp":
        params["mlp_head"] = mlp_init(
            generator, cfg.dir_enc_dim + cfg.geo_feat_dim, 3,
            hidden_dim=cfg.hidden_size, num_hidden_layers=2, bias=False,
            device=device,
        )
    return params


def ngp_normalize(x: torch.Tensor, aabb: torch.Tensor, cfg: NGPConfig):
    """World -> [0,1]^3 and the in-bounds selector."""
    if cfg.unbounded:
        y = contract_to_unisphere(x, aabb)
        selector = torch.ones(x.shape[:-1], dtype=torch.bool,
                              device=x.device)
    else:
        aabb_min, aabb_max = aabb[:3], aabb[3:]
        y = (x - aabb_min) / (aabb_max - aabb_min)
        selector = ((y > 0.0) & (y < 1.0)).all(dim=-1)
    return selector, y


def ngp_query_density(params, x, aabb, cfg: NGPConfig,
                      return_feat: bool = False):
    """density [N,1] (zeroed outside the box) and optionally the geo
    features [N, geo_feat_dim]."""
    selector, y = ngp_normalize(x, aabb, cfg)
    h = hashgrid_encode(params["table"], y.contiguous(), cfg.hashgrid)
    out = mlp_apply(params["mlp_base"], h, compute_dtype=cfg.cdtype)
    density = density_activation(out[..., :1]) * selector[..., None]
    if return_feat:
        return density, out[..., 1:]
    return density


def _spherical_gaussian_mixture(feats, dirs, num_lobes: int):
    """sum over lobes of c * exp(lambda * (axis.dir - 1)); feats
    [N, num_lobes*7] laid out per lobe [axis(3), lambda(1), color(3)]."""
    n = feats.shape[0]
    lobes = feats.reshape(n, num_lobes, 7)
    axis = lobes[..., :3]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    lam = lobes[..., 3].abs()
    c = lobes[..., 4:7]
    dot = (axis * dirs[:, None, :]).sum(dim=-1)
    g = torch.exp(lam * (dot - 1.0))[..., None]
    return (c * g).sum(dim=1)


def _sg_mixture_old(feats, dirs, num_lobes: int):
    """Per lobe 3 x [axis(3), lambda(1), amplitude(1)], one 5-tuple per
    color channel; a = |amp| * exp(-lambda*(1-axis.dir))."""
    n = feats.shape[0]
    lobes = feats.reshape(n, num_lobes, 3, 5)
    axis = lobes[..., :3]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    lam = lobes[..., 3].abs()
    amp = lobes[..., 4].abs()
    dot = (axis * dirs[:, None, None, :]).sum(dim=-1)
    g = amp * torch.exp(-lam * (1.0 - dot))
    return g.sum(dim=1)


def ngp_head_apply(params, embedding, dirs, cfg: NGPConfig):
    """Geo features (+ optional SH-encoded dirs) -> rgb in [0,1]."""
    if cfg.use_viewdirs:
        d_enc = spherical_harmonics_deg4((dirs + 1.0) / 2.0)
        h = torch.cat([d_enc, embedding], dim=-1)
    else:
        h = embedding
    raw = mlp_apply(params["mlp_head"], h, compute_dtype=cfg.cdtype)
    if cfg.head == "sg":
        sg = _spherical_gaussian_mixture(raw[:, 3:], dirs, cfg.num_g_lobes)
        return torch.sigmoid(raw[:, :3] + sg)
    if cfg.head == "sg_old":
        # the reference evaluates the old mixture on the [0,1]-remapped
        # direction when use_viewdirs is on; kept for checkpoint parity
        d_mix = (dirs + 1.0) / 2.0 if cfg.use_viewdirs else dirs
        sg = _sg_mixture_old(raw[:, 3:], d_mix, cfg.num_g_lobes)
        return torch.sigmoid(raw[:, :3] + sg)
    return torch.sigmoid(raw)


def ngp_forward(params, x, dirs, aabb, cfg: NGPConfig):
    """(rgb [N,3], density [N,1])."""
    density, embedding = ngp_query_density(params, x, aabb, cfg,
                                           return_feat=True)
    rgb = ngp_head_apply(params, embedding, dirs, cfg)
    return rgb, density


def ngp_features(params, x, aabb, cfg: NGPConfig):
    """Per-point bakeable features [head_output_dim + 1]: raw head
    output concat density (reference ngp.py:445-454)."""
    density, embedding = ngp_query_density(params, x, aabb, cfg,
                                           return_feat=True)
    raw = mlp_apply(params["mlp_head"], embedding, compute_dtype=cfg.cdtype)
    return torch.cat([raw.to(torch.float32), density], dim=-1)


def ngp_features_to_rgb(features, dirs, cfg: NGPConfig):
    """Decode baked features (no MLP) -> rgb: the real-time render path
    (reference ngp.py:456-461 sg, ngp.py:642-645 sg_old on raw dirs)."""
    diffuse = features[:, :3]
    if cfg.head == "sg_old":
        sg = _sg_mixture_old(features[:, 3:], dirs, cfg.num_g_lobes)
    else:
        sg = _spherical_gaussian_mixture(features[:, 3:], dirs,
                                         cfg.num_g_lobes)
    return torch.sigmoid(diffuse + sg)


def ngp_sg_old_head_output_dim(num_lobes: int) -> int:
    """3 + num_lobes * 3 * (3+1+1), reference ngp.py:553."""
    return 3 + num_lobes * 15


def ngp_sg_old_features_to_rgb(features, dirs, num_lobes: int):
    """features_to_rgb of the older NGPRadianceFieldSG layout
    (ngp.py:642-645)."""
    diffuse = features[:, :3]
    return torch.sigmoid(
        diffuse + _sg_mixture_old(features[:, 3:], dirs, num_lobes))
