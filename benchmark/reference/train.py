"""Plain PyTorch reference of stage-1 training steps from a given state.

Each step renders the batch with the stratified march on the given
occupancy binaries, takes the smooth-L1 loss plus the occ regulariser,
backpropagates with autograd and steps Adam (eps 1e-15, the weight
decay added to the gradient, the reference's linear warm-up of the
learning rate), written out here. A frozen copy of the semantics of the
port's `Stage1Trainer` (train/stage1_ngp.py, utils/optim.py,
utils/metrics.py), with nothing of the port imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ngp import Field
from .render import March, render_train


def schedule(step: int, base_lr: float, max_steps: int,
             warmup: int = 100, start: float = 0.01,
             gamma: float = 0.33) -> float:
    """The reference learning rate of update `step`, in float32: a
    linear warm-up from `start`, then `gamma` at 1/2, 3/4 and 9/10 of
    max_steps."""
    f32 = np.float32
    s = f32(step)
    lin = f32(start) + f32(1.0 - start) * min(s, f32(warmup)) / f32(warmup)
    decay = f32(1.0)
    for m in (max_steps // 2, max_steps * 3 // 4, max_steps * 9 // 10):
        decay = decay * (f32(gamma) if s >= m else f32(1.0))
    return float(f32(base_lr) * lin * decay)


def smooth_l1(pred, target, beta: float = 1.0):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d**2 / beta, d - 0.5 * beta).mean()


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The optimiser and loss of a configuration."""

    lr: float = 1e-2
    max_steps: int = 20000
    weight_decay: float = 1e-6
    o_lambda: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15


class Adam:
    """torch.optim.Adam's update, leaf by leaf, in f32, from the moments
    `m` and `v` after `t` updates (zeros and 0 unless given)."""

    def __init__(self, leaves: dict, recipe: Recipe, m=None, v=None,
                 t: int = 0):
        self.recipe = recipe
        self.m = dict(m) if m else {k: torch.zeros_like(p)
                                    for k, p in leaves.items()}
        self.v = dict(v) if v else {k: torch.zeros_like(p)
                                    for k, p in leaves.items()}
        self.t = int(t)

    def gradient(self, p, grad):
        """The gradient as the optimiser takes it (decay added)."""
        return grad + self.recipe.weight_decay * p

    def step(self, leaves: dict, grads: dict, lr: float) -> dict:
        b1, b2 = self.recipe.betas
        self.t += 1
        bc1, bc2 = 1 - b1**self.t, 1 - b2**self.t
        out = {}
        for k, p in leaves.items():
            g = self.gradient(p, grads[k])
            self.m[k] = self.m[k] * b1 + (1 - b1) * g
            self.v[k] = self.v[k] * b2 + (1 - b2) * g * g
            denom = self.v[k].sqrt() / (bc2**0.5) + self.recipe.eps
            out[k] = p - (lr / bc1) * self.m[k] / denom
        return out


def as_params(leaves: dict) -> dict:
    """Leaves named "table", "mlp_base.i", "mlp_head.i" -> the field's
    parameter dict."""
    def layers(prefix):
        n = sum(1 for k in leaves if k.startswith(prefix + "."))
        return [leaves[f"{prefix}.{i}"] for i in range(n)]

    return {"table": leaves["table"], "mlp_base": layers("mlp_base"),
            "mlp_head": layers("mlp_head")}


def loss_of(field: Field, leaves: dict, aabb, binaries, batch: dict,
            march: March, recipe: Recipe):
    rgb, opacity = render_train(
        field, as_params(leaves), aabb, binaries, batch["origins"],
        batch["viewdirs"], batch["t_jitter"], batch["bkgd"], march)
    reg = (recipe.o_lambda * (-opacity * torch.log(opacity + 1e-10))).mean()
    return smooth_l1(rgb, batch["pixels"]) + reg


def train_steps(field: Field, leaves: dict, aabb, binaries, batches,
                march: March, recipe: Recipe, adam: Adam | None = None,
                start_step: int = 0):
    """Run len(batches) steps from `leaves` (detached f32 tensors) with
    `adam` (a fresh one unless given), the first at update `start_step`
    of the schedule. Returns (losses, the first step's gradients as the
    optimiser takes them, the leaves after the last step)."""
    adam = adam or Adam(leaves, recipe)
    losses, first = [], None
    for k, batch in enumerate(batches):
        cur = {n: v.detach().requires_grad_(True) for n, v in leaves.items()}
        loss = loss_of(field, cur, aabb, binaries, batch, march, recipe)
        grads = torch.autograd.grad(loss, list(cur.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(v) if g is None else g)
                 for (n, v), g in zip(cur.items(), grads)}
        if first is None:
            first = {n: adam.gradient(leaves[n], g) for n, g in grads.items()}
        leaves = adam.step({n: v.detach() for n, v in cur.items()}, grads,
                           schedule(start_step + k, recipe.lr,
                                    recipe.max_steps))
        losses.append(float(loss.detach()))
    return losses, first, leaves
