"""Vanilla positional-encoding NeRF MLPs (+ time-warped T-NeRF).

Port of quadraturefields_tpu/models/mlp_nerf.py (reference
examples/radiance_fields/mlp.py: VanillaNeRFRadianceField,
TNeRFRadianceField, SinusoidalEncoder), unused by the pipeline scripts
but part of the model family; the SIREN field (models/field.py) uses its
sinusoidal encoding. Plain functions on a params tree of tensors, as
JAX's: every layer is {"w": [in, out], "b": [out]} (y = x @ w + b), so
JAX's weights carry over untransposed (utils/convert.py). Xavier-uniform
init like the reference, f32 matmuls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """[x,] sin(2^k x), sin(2^k x + pi/2) for k in [min_deg, max_deg),
    the frequencies of one coordinate side by side (reference
    SinusoidalEncoder, mlp.py:168-203)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        *x.shape[:-1], (max_deg - min_deg) * x.shape[-1])
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def sinusoidal_dim(x_dim: int, min_deg: int, max_deg: int,
                   use_identity: bool = True) -> int:
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


def _xavier_linear(generator: torch.Generator, fan_in: int, fan_out: int,
                   out_uniform_b: Optional[float] = None, device=None):
    """{"w": [fan_in, fan_out], "b": zeros}: w ~ U(-b, b) with the Xavier
    bound b = sqrt(6 / (fan_in + fan_out)), or U(0, out_uniform_b)."""
    u = torch.rand((fan_in, fan_out), generator=generator, device=device)
    if out_uniform_b is not None:
        w = u * out_uniform_b
    else:
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        w = u * (2.0 * bound) - bound
    return {"w": w, "b": torch.zeros((fan_out,), device=device)}


def _mlp_init(generator, input_dim, output_dim, net_depth, net_width,
              skip_layer, out_uniform_b=None, device=None):
    """net_depth hidden layers of net_width (after hidden layer i, for
    i > 0 a multiple of skip_layer, the input is concatenated back), and
    an output layer when output_dim is not None."""
    layers = []
    in_features = input_dim
    for i in range(net_depth):
        layers.append(_xavier_linear(generator, in_features, net_width,
                                     device=device))
        if skip_layer is not None and i % skip_layer == 0 and i > 0:
            in_features = net_width + input_dim
        else:
            in_features = net_width
    out = None
    if output_dim is not None:
        out = _xavier_linear(generator, in_features, output_dim,
                             out_uniform_b, device=device)
    return {"hidden": layers, "out": out}


def _mlp_apply(params, x: torch.Tensor, skip_layer) -> torch.Tensor:
    inputs = x
    for i, layer in enumerate(params["hidden"]):
        x = torch.relu(x @ layer["w"] + layer["b"])
        if skip_layer is not None and i % skip_layer == 0 and i > 0:
            x = torch.cat([x, inputs], dim=-1)
    if params["out"] is not None:
        x = x @ params["out"]["w"] + params["out"]["b"]
    return x


@dataclasses.dataclass(frozen=True)
class VanillaNeRFConfig:
    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128
    max_freq: int = 4  # position encoding degrees

    @property
    def pos_dim(self):
        return sinusoidal_dim(3, 0, self.max_freq)

    @property
    def view_dim(self):
        return sinusoidal_dim(3, 0, 4)


def vanilla_nerf_init(generator: torch.Generator, cfg: VanillaNeRFConfig,
                      device=None):
    base = _mlp_init(generator, cfg.pos_dim, None, cfg.net_depth,
                     cfg.net_width, cfg.skip_layer, device=device)
    # the base's output width: net_width (+ the input if its last layer
    # was followed by a skip)
    last_skip = (
        cfg.skip_layer is not None
        and (cfg.net_depth - 1) % cfg.skip_layer == 0
        and cfg.net_depth - 1 > 0
    )
    hidden_features = cfg.net_width + (cfg.pos_dim if last_skip else 0)
    return {
        "base": base,
        "sigma": _xavier_linear(generator, hidden_features, 1,
                                device=device),
        "bottleneck": _xavier_linear(generator, hidden_features,
                                     cfg.net_width, device=device),
        "rgb": _mlp_init(
            generator, cfg.net_width + cfg.view_dim, 3,
            cfg.net_depth_condition, cfg.net_width_condition, None,
            device=device,
        ),
    }


def vanilla_nerf_query_density(params, x, cfg: VanillaNeRFConfig):
    h = _mlp_apply(params["base"], sinusoidal_encode(x, 0, cfg.max_freq),
                   cfg.skip_layer)
    return torch.relu(h @ params["sigma"]["w"] + params["sigma"]["b"])


def vanilla_nerf_forward(params, x, condition, cfg: VanillaNeRFConfig):
    """(rgb [..., 3] in (0, 1), density [..., 1]) of positions x and
    view directions `condition`."""
    h = _mlp_apply(params["base"], sinusoidal_encode(x, 0, cfg.max_freq),
                   cfg.skip_layer)
    raw_sigma = h @ params["sigma"]["w"] + params["sigma"]["b"]
    bottleneck = h @ params["bottleneck"]["w"] + params["bottleneck"]["b"]
    cond = sinusoidal_encode(condition, 0, 4)
    raw_rgb = _mlp_apply(params["rgb"], torch.cat([bottleneck, cond], dim=-1),
                         None)
    return torch.sigmoid(raw_rgb), torch.relu(raw_sigma)


@dataclasses.dataclass(frozen=True)
class TNeRFConfig:
    nerf: VanillaNeRFConfig = VanillaNeRFConfig()

    @property
    def warp_in_dim(self):
        return sinusoidal_dim(3, 0, 4) + sinusoidal_dim(1, 0, 4)


def tnerf_init(generator: torch.Generator, cfg: TNeRFConfig, device=None):
    return {
        "warp": _mlp_init(generator, cfg.warp_in_dim, 3, 4, 64, 2,
                          out_uniform_b=1e-4, device=device),
        "nerf": vanilla_nerf_init(generator, cfg.nerf, device=device),
    }


def tnerf_warp(params, x, t, cfg: TNeRFConfig):
    """Time-conditioned warp field (mlp.py:274-285): x + MLP(x, t)."""
    enc = torch.cat([sinusoidal_encode(x, 0, 4), sinusoidal_encode(t, 0, 4)],
                    dim=-1)
    return x + _mlp_apply(params["warp"], enc, 2)


def tnerf_query_density(params, x, t, cfg: TNeRFConfig):
    return vanilla_nerf_query_density(
        params["nerf"], tnerf_warp(params, x, t, cfg), cfg.nerf)


def tnerf_forward(params, x, t, condition, cfg: TNeRFConfig):
    return vanilla_nerf_forward(
        params["nerf"], tnerf_warp(params, x, t, cfg), condition, cfg.nerf)
