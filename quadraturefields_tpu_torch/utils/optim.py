"""Optimizer and schedule of the reference trainers.

Port of quadraturefields_tpu/utils/optim.py. The reference recipe
(train_ngp_nerf_sg_occ.py:240-261): Adam(lr=1e-2, eps=1e-15,
weight_decay per scene) with ChainedScheduler(LinearLR(start_factor=0.01,
total_iters=100), MultiStepLR(milestones=[1/2, 3/4, 9/10] * max_steps,
gamma=0.33)). torch's Adam adds weight_decay * p to the gradient before
the moments, which is exactly optax's add_decayed_weights ahead of
scale_by_adam in the JAX chain; one parameter group holds every leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def reference_lr_schedule(base_lr: float, max_steps: int,
                          warmup_iters: int = 100,
                          start_factor: float = 0.01, gamma: float = 0.33,
                          milestones=None):
    """step -> learning rate, evaluated in float32 as the JAX schedule
    is: a linear warm-up from start_factor over warmup_iters steps, then
    a factor gamma at each milestone."""
    if milestones is None:
        milestones = [max_steps // 2, max_steps * 3 // 4,
                      max_steps * 9 // 10]
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        lin = f32(start_factor) + f32(1.0 - start_factor) * min(
            s, f32(warmup_iters)) / f32(warmup_iters)
        decay = f32(1.0)
        for m in milestones:
            decay = decay * (f32(gamma) if s >= m else f32(1.0))
        return float(f32(base_lr) * lin * decay)

    return schedule


def make_ngp_optimizer(params, max_steps: int, lr: float = 1e-2,
                       eps: float = 1e-15, weight_decay: float = 1e-6,
                       warmup_iters: int = 100, start_step: int = 0,
                       milestones=None):
    """(Adam over the leaf tensors `params`, its LambdaLR). Step the
    scheduler after each optimizer step, so update k uses schedule(k),
    as optax's update count does; `start_step` offsets k for a trainer
    that is already past step 0. `warmup_iters` and `milestones` shape
    the schedule (reference_lr_schedule)."""
    schedule = reference_lr_schedule(lr, max_steps, warmup_iters,
                                     milestones=milestones)
    opt = torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999), eps=eps,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: schedule(k + start_step) / lr)
    return opt, sched
