"""Quadrature field: a hash-grid scalar field with an ELU decoder.

Port of quadraturefields_tpu/models/field.py (reference
examples/field.py:130-491), with the same parameter tree:
{"table": [E, F] (or [E, 8F] in the cell layout), "decoder": {"layers":
[{"w": [in, out], "b": [out]}, ...]}}. Semantics kept:

  * the domain [-scale, scale]^3 maps to [0, 1]^3;
  * unless `back_prop` is set, the hash-grid input is detached (JAX's
    stop_gradient), so the position gradient flows only through the
    x_norm half of the decoder input concat([x_norm, features]);
  * the grid growth factor is b = exp(ln(max_res * scale / min_res) /
    (L - 1)): the scale enters the top resolution.

`field_with_grad` takes the position gradient with
`torch.autograd.grad(field, x, ones, create_graph=True)`, which stays
differentiable in the parameters, so the stage-2 loss backpropagates
through it. With the encode's input detached, that first-order pass
never enters the encode's backward: the loss's backward calls it once,
for the table (the fused table-gradient kernel K1 on the card). With
`back_prop=True` the first-order pass takes the encode's position
gradient, which the loss then differentiates again
(ops/hashgrid.py `_HashGridEncodeGrad`): once a step the table gradient
of the position gradient (K1's stream interface on the card, K5's
stream entry in the cell layout) beside the fused first-order one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.hashgrid import HashGridConfig, hashgrid_encode, hashgrid_init
from ..ops.mlp import mlp_apply, mlp_init
from .mlp_nerf import sinusoidal_dim, sinusoidal_encode


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """The JAX config, field for field."""

    scale: float = 1.5
    back_prop: bool = False
    log2_hashmap_size: int = 19
    n_levels: int = 16
    max_resolution: int = 512
    min_resolution: int = 16
    output_dim: int = 1
    hidden_size: int = 32
    num_features: int = 2
    nl: str = "elu"  # "elu" | "relu"
    bias: bool = True
    bias_last: bool = True
    compute_dtype: str = "float32"
    table_dtype: str = "float32"
    interp: str = "cube"
    grad_mode: str = "auto"
    # the cell layout counts log2_hashmap_size in corners, as for the NGP
    layout: str = "corner"
    grad_payload: str = "f32"

    @property
    def hashgrid(self) -> HashGridConfig:
        b = math.exp(
            math.log(self.max_resolution * self.scale / self.min_resolution)
            / (self.n_levels - 1)
        )
        log2_t = self.log2_hashmap_size
        if self.layout == "cell":
            log2_t = max(log2_t - 3, 4)
        return HashGridConfig(
            n_levels=self.n_levels,
            n_features=self.num_features,
            log2_hashmap_size=log2_t,
            base_resolution=self.min_resolution,
            per_level_scale=b,
            dtype=self.table_dtype,
            interp=self.interp,
            grad_mode=self.grad_mode,
            layout=self.layout,
            grad_payload=self.grad_payload,
        )

    @property
    def activation(self):
        return F.elu if self.nl == "elu" else torch.relu

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def field_init(generator: torch.Generator, cfg: FieldConfig, device=None):
    return {
        "table": hashgrid_init(generator, cfg.hashgrid, device),
        "decoder": mlp_init(
            generator,
            cfg.hashgrid.output_dim + 3,
            cfg.output_dim,
            hidden_dim=cfg.hidden_size,
            num_hidden_layers=2,
            bias=cfg.bias,
            bias_last=cfg.bias_last,
            device=device,
        ),
    }


def field_apply(params, x: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """x [N, 3] in [-scale, scale] world coordinates -> field
    [N, output_dim] f32 (reference Field.density + Field.field,
    field.py:186-227)."""
    x_norm = (x + cfg.scale) / (2.0 * cfg.scale)
    enc_in = x_norm if cfg.back_prop else x_norm.detach()
    h = hashgrid_encode(params["table"], enc_in.contiguous(), cfg.hashgrid)
    out = mlp_apply(
        params["decoder"],
        torch.cat([x_norm, h], dim=-1),
        activation=cfg.activation,
        compute_dtype=cfg.cdtype,
    )
    return out.to(torch.float32)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def _with_input_grad(apply_fn, params, x, create_graph: bool):
    """(f, d(sum f)/dx) of f = apply_fn(params, x): a vjp with a ones
    cotangent. create_graph keeps both differentiable in the params;
    without it the params are detached, so no graph is kept to them."""
    if not create_graph:
        params = _detached(params)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        field = apply_fn(params, xx)
        (grad,) = torch.autograd.grad(field, xx, torch.ones_like(field),
                                      create_graph=create_graph)
    if not create_graph:
        field, grad = field.detach(), grad.detach()
    return field, grad


def field_with_grad(params, x: torch.Tensor, cfg: FieldConfig,
                    create_graph: bool = True):
    """(field [N, output_dim], dfield/dx [N, 3]): the gradient of the
    summed field at the input points (Field.forward(x,
    return_grad=True), field.py:206-223; for output_dim 1 the spatial
    gradient). create_graph (the default, as the stage-2 loss needs)
    keeps both differentiable in the params; False (the grid export)
    returns detached tensors."""
    return _with_input_grad(lambda p, xx: field_apply(p, xx, cfg), params,
                            x, create_graph)


def field_double_grad(params, x: torch.Tensor, cfg: FieldConfig):
    """[N, 3, 3] second derivative of the scalar field at x, rows
    d(grad_i)/dx (Field.field_double_grad, field.py:240-251);
    differentiable in the params (under back_prop through the encode's
    third derivative, ops/hashgrid.py `_HashGridEncodeGrad`)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        field = field_apply(params, xx, cfg)
        (grad,) = torch.autograd.grad(field, xx, torch.ones_like(field),
                                      create_graph=True)
        rows = [torch.autograd.grad(grad[:, i], xx,
                                    torch.ones_like(grad[:, i]),
                                    create_graph=True)[0]
                for i in range(3)]
    return torch.stack(rows, dim=1)


def compute_abs_loss(field_grad: torch.Tensor) -> torch.Tensor:
    """Mean L1 norm of the field gradient (Field.compute_abs_loss,
    field.py:261-264)."""
    return field_grad.abs().sum(dim=1).mean()


def compute_double_field_loss(field_double_der: torch.Tensor):
    """Mean |second derivative| (Field.compute_double_field_loss,
    field.py:266-270)."""
    return field_double_der.abs().mean()


@dataclasses.dataclass(frozen=True)
class FieldMLPConfig:
    """SIREN field variant (reference FieldMLP, field.py:274-413):
    positional encoding and a sine-activated MLP, no hash grid."""

    scale: float = 1.5
    output_dim: int = 1
    hidden_size: int = 256
    num_layers: int = 6
    w0_initial: float = 30.0
    pe_degrees: int = 3


def field_mlp_init(generator: torch.Generator, cfg: FieldMLPConfig,
                   device=None):
    """SIREN init: the first layer U(-1/n, 1/n), the others and the
    output U(-sqrt(6/n)/w0, sqrt(6/n)/w0), biases 0."""

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return u * (2.0 * bound) - bound

    fan_in = sinusoidal_dim(3, 0, cfg.pe_degrees)
    layers = []
    for i in range(cfg.num_layers):
        bound = (1.0 / fan_in if i == 0
                 else math.sqrt(6.0 / fan_in) / cfg.w0_initial)
        layers.append({
            "w": uniform((fan_in, cfg.hidden_size), bound),
            "b": torch.zeros((cfg.hidden_size,), device=device),
        })
        fan_in = cfg.hidden_size
    bound = math.sqrt(6.0 / fan_in) / cfg.w0_initial
    out = {"w": uniform((fan_in, cfg.output_dim), bound),
           "b": torch.zeros((cfg.output_dim,), device=device)}
    return {"layers": layers, "out": out}


def field_mlp_apply(params, x: torch.Tensor, cfg: FieldMLPConfig):
    """x [N, 3] world -> field [N, output_dim] through sin activations."""
    h = sinusoidal_encode(x, 0, cfg.pe_degrees)
    for i, layer in enumerate(params["layers"]):
        h = torch.sin((cfg.w0_initial if i == 0 else 1.0)
                      * (h @ layer["w"] + layer["b"]))
    return h @ params["out"]["w"] + params["out"]["b"]


def field_mlp_with_grad(params, x: torch.Tensor, cfg: FieldMLPConfig,
                        create_graph: bool = True):
    return _with_input_grad(lambda p, xx: field_mlp_apply(p, xx, cfg),
                            params, x, create_graph)


@dataclasses.dataclass(frozen=True)
class DeltaFieldConfig:
    """DeltaField (reference field.py:415-491): a bare hash grid whose
    per-point feature sum is the field (no decoder); min_res 128."""

    scale: float = 1.5
    log2_hashmap_size: int = 19
    n_levels: int = 16
    max_resolution: int = 512
    min_resolution: int = 128
    table_dtype: str = "float32"

    @property
    def hashgrid(self) -> HashGridConfig:
        b = math.exp(
            math.log(self.max_resolution * self.scale / self.min_resolution)
            / (self.n_levels - 1)
        )
        return HashGridConfig(
            n_levels=self.n_levels,
            n_features=2,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.min_resolution,
            per_level_scale=b,
            dtype=self.table_dtype,
        )


def delta_field_init(generator: torch.Generator, cfg: DeltaFieldConfig,
                     device=None):
    return {"table": hashgrid_init(generator, cfg.hashgrid, device)}


def delta_field_apply(params, x: torch.Tensor, cfg: DeltaFieldConfig):
    """x in [-scale, scale] -> the sum of its encoded features [N]
    (DeltaField.density, field.py:458-473)."""
    x_norm = (x + cfg.scale) / (2.0 * cfg.scale)
    h = hashgrid_encode(params["table"], x_norm.contiguous(), cfg.hashgrid)
    return h.sum(dim=1)


def field_loss(weights, weights_rev, field_grad, view_dirs, mask=None):
    """| max(w, w_rev) - |grad_f . d| |, averaged over the valid samples
    (Field.compute_field_loss, field.py:253-259). The weights are
    detached; `mask` drops the packed buffer's padding."""
    view_dirs = view_dirs / torch.linalg.vector_norm(
        view_dirs, dim=1, keepdim=True).clamp_min(1e-12)
    target = torch.maximum(weights.detach(), weights_rev.detach())
    proj = (field_grad * view_dirs).sum(dim=1).abs()
    err = (target - proj).abs()
    if mask is None:
        return err.mean()
    denom = mask.sum(dtype=torch.float32).clamp_min(1.0)
    return torch.where(mask, err, 0.0).sum() / denom
