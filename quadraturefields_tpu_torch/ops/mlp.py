"""Small MLP blocks as plain parameter dicts and a pure apply function.

Port of quadraturefields_tpu/ops/mlp.py with the same parameter layout:
{"layers": [{"w": [in, out], "b": [out]}, ...]}, so `y = x @ w + b`.
With a bf16 compute dtype the JAX package rounds both operands to bf16
but keeps an f32 product (preferred_element_type=float32). A torch bf16
matmul would round its result to bf16, so `_dense` instead upcasts the
bf16-rounded operands to f32 and multiplies in f32: every product of
two bf16 values is exact in f32, and the sum is f32. That needs an f32
matmul without TF32, PyTorch's default
(torch.backends.cuda.matmul.allow_tf32 is False); the stage-1 trainer
sets it so.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _linear_init(generator, fan_in, fan_out, bias: bool, device):
    """torch nn.Linear default: U(-b, b), b = 1/sqrt(fan_in), the same
    bound for the bias."""
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return u * (2.0 * bound) - bound

    layer = {"w": uniform((fan_in, fan_out))}
    if bias:
        layer["b"] = uniform((fan_out,))
    return layer


def mlp_init(
    generator: torch.Generator,
    input_dim: int,
    output_dim: int,
    hidden_dim: int = 64,
    num_hidden_layers: int = 1,
    bias: bool = True,
    skip: Sequence[int] = (),
    bias_last: bool = True,
    device=None,
):
    """num_hidden_layers hidden layers + output; a layer i in `skip`
    (i > 0) takes [input, h] concatenated."""
    layers = []
    for i in range(num_hidden_layers):
        if i == 0:
            fan_in = input_dim
        elif i in skip:
            fan_in = hidden_dim + input_dim
        else:
            fan_in = hidden_dim
        layers.append(
            _linear_init(generator, fan_in, hidden_dim, bias, device)
        )
    layers.append(
        _linear_init(generator, hidden_dim, output_dim, bias and bias_last,
                     device)
    )
    return {"layers": layers}


def _dense(layer, x: torch.Tensor, compute_dtype: torch.dtype):
    """x @ w (+ b): operands rounded to compute_dtype, result f32."""
    w = layer["w"].to(compute_dtype).to(torch.float32)
    y = x.to(compute_dtype).to(torch.float32) @ w
    if "b" in layer:
        y = y + layer["b"]
    return y


def mlp_apply(
    params,
    x: torch.Tensor,
    activation: Callable = torch.relu,
    skip: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.bfloat16,
    return_h: bool = False,
):
    """Hidden activations after every hidden layer, linear output."""
    layers = params["layers"]
    h = x
    for i, layer in enumerate(layers[:-1]):
        if i > 0 and i in skip:
            h = torch.cat([x, h], dim=-1)
        h = activation(_dense(layer, h, compute_dtype))
    out = _dense(layers[-1], h, compute_dtype)
    if return_h:
        return out, h
    return out
