"""Ray-batch data parallelism over torch.distributed ranks: the port of
quadraturefields_tpu/parallel/dp.py for stages 1 and 2.

Rays are independent and the parameters small (the hash tables), so
every rank holds the parameters whole and marches, compacts and
composites its own slice of the ray batch with its share of the sample
budget (`local_rcfg`); the sample compaction never crosses ranks. The
trainers' own loss runs on that slice (Stage1Trainer and Stage2Trainer
`_train_step_impl`), and between backward and the optimizer step one
all-reduce of one flat buffer combines the ranks' losses and gradients
(`allreduce_grads`, JAX's one psum a step). Every rank then runs the
same Adam update on the same sums, so the parameters stay identical on
every rank, bit for bit. The occupancy refresh evaluates each rank's
slice of the partition's points and all-gathers them (`make_dp_occ_eval`).

The functions take the process group's collectives as they come: the
backend is the caller's (NCCL for CUDA tensors; gloo also takes them,
through the host), and a failed collective raises. Each rank launches
the same kernels as the single-device step: the encode (K2), the
occupancy bits (K4), the per-ray segment sum (K3) and the fused table
gradient (K1).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..render.renderer import RenderConfig


def local_rcfg(rcfg: RenderConfig, world: int) -> RenderConfig:
    """The rank's share of the sample budget (at least 256), so that the
    ranks' budgets sum to the single device's (JAX dp.py:73-81)."""
    return dataclasses.replace(
        rcfg, max_samples_total=max(256, rcfg.max_samples_total // world))


def allreduce_grads(leaves, w, scalars: torch.Tensor) -> torch.Tensor:
    """In one all-reduce (SUM) of one flat buffer: each leaf's gradient
    replaced by the sum over the ranks of w times it (a zero gradient
    where the loss does not reach the leaf, which Adam's weight decay
    still moves, as optax's chain does in JAX), and `scalars`, already
    weighted by the caller, summed. Returns the summed scalars.

    With w = 1 / world the gradient is the ranks' mean (pmean: exact,
    their slices being equal); with per-rank means whose denominators
    differ (valid-sample counts), w = n_rank / n_total makes the sum the
    global mean."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    n = scalars.numel()
    flat = torch.cat([scalars.reshape(-1).to(torch.float32),
                      *(p.grad.reshape(-1) for p in leaves)])
    flat[n:].mul_(w)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = n
    for p in leaves:
        k = p.numel()
        p.grad.copy_(flat[offset:offset + k].view_as(p))
        offset += k
    return flat[:n]


def psum_count(n: torch.Tensor, group=None) -> torch.Tensor:
    """Integer counts (a scalar or a vector) summed exactly (int64) over
    the ranks of `group` (the default group when None), in n's shape."""
    total = n.detach().to(torch.int64).reshape(-1).clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.reshape(n.shape)


@torch.no_grad()
def broadcast_params(leaves) -> None:
    """Every rank's parameters set to rank 0's, in one broadcast: the
    ranks start from identical parameters."""
    flat = torch.cat([p.reshape(-1) for p in leaves])
    dist.broadcast(flat, src=0)
    offset = 0
    for p in leaves:
        n = p.numel()
        p.copy_(flat[offset:offset + n].view_as(p))
        offset += n


def make_dp_occ_eval(occ_eval_fn):
    """The occupancy refresh's evaluation over the ranks (JAX's
    make_dp_occ_update): each rank evaluates `occ_eval_fn` ([n, 3]
    points -> [n] occupancies) on its slice of the partition's points,
    padded to a whole number of slices, and an all-gather brings them
    back, cut to n. Every rank then runs occ_grid_update's EMA and
    threshold math on the same inputs, so the refreshed state is the
    same on every rank, and the single device's."""
    world = dist.get_world_size()
    rank = dist.get_rank()

    def fn(x):
        n = x.shape[0]
        shard = -(-n // world)
        xp = torch.nn.functional.pad(x, (0, 0, 0, shard * world - n))
        occ = occ_eval_fn(xp[rank * shard:(rank + 1) * shard]).contiguous()
        parts = [torch.empty_like(occ) for _ in range(world)]
        dist.all_gather(parts, occ)
        return torch.cat(parts)[:n]

    return fn
