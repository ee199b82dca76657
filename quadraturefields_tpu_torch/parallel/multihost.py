"""The process group, each rank's device, each rank's slice of the ray
batch, and the 2-D layout of data x sample parallelism: the parts of
quadraturefields_tpu/parallel/multihost.py and of its mesh set-up
(parallel/dp.py's make_mesh, parallel/sp.py's 2-D Mesh) that the port
uses, on torch.distributed.

A data-parallel run is one process per rank, launched by torchrun:

    torchrun --nproc_per_node N -m quadraturefields_tpu_torch.cli.train_ngp \\
        --num_devices N ...

torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
`maybe_initialize_distributed` joins the group from them. Every rank's
data loader is seeded alike, so every rank draws the same global batch,
and each keeps its own contiguous slice of it (`shard_batch`), as JAX's
`put_process_batch` has each process materialize its slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch
import torch.distributed as dist


def maybe_initialize_distributed(backend: str) -> bool:
    """Join the process group of a torchrun launch with `backend`
    ("nccl" for CUDA tensors, "gloo" for CPU ones; the caller names it,
    and nothing here picks another). Returns False when WORLD_SIZE is
    unset or 1 (a single-process run), True when the group is (already)
    initialized."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    init_distributed(backend)
    return True


def init_distributed(backend: str, timeout=None) -> None:
    """Join the process group that torchrun's environment names (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) with `backend`,
    whatever its size; with nccl the rank's card, cuda:LOCAL_RANK,
    becomes the current device first. `timeout` (a timedelta) bounds
    each collective."""
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **kwargs)


def rank_device(device="cuda") -> torch.device:
    """The rank's device: "cuda" without an index is cuda:LOCAL_RANK;
    an explicit index, or the CPU, is kept as the caller gave it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def world_and_rank(num_devices: int) -> tuple[int, int]:
    """(world size, rank) of the process group that a trainer with
    `num_devices` > 1 trains over. JAX builds its mesh from the first
    num_devices devices; here every device is a rank, so num_devices must
    equal the group's size. Raises instead of training on one device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"num_devices={num_devices} needs a torch.distributed process "
            f"group of {num_devices} ranks (WORLD_SIZE is unset or 1): "
            f"launch with torchrun --nproc_per_node {num_devices}")
    world = dist.get_world_size()
    if world != num_devices:
        raise ValueError(
            f"num_devices={num_devices} but the process group has {world} "
            f"ranks: pass --num_devices equal to --nproc_per_node")
    return world, dist.get_rank()


def process_local_slice(global_n: int, world: int, rank: int):
    """(start, size) of the contiguous leading-axis slice of a
    [global_n, ...] batch that `rank` of `world` ranks holds. global_n
    must divide by world (the batching buckets are multiples of 256)."""
    if global_n % world != 0:
        raise ValueError(
            f"global batch {global_n} not divisible by {world} ranks")
    size = global_n // world
    return rank * size, size


def shard_batch(arrays: Sequence, world: int, rank: int) -> tuple:
    """Each array's slice for `rank`: every rank holds the same global
    batch (its loader draws from the same seed) and keeps its own
    process_local_slice of the leading axis."""
    start, size = process_local_slice(arrays[0].shape[0], world, rank)
    return tuple(a[start:start + size] for a in arrays)


def on_rank0(ranked: bool, fn, *args):
    """fn(*args) on rank 0 alone when `ranked` (a trainer over ranks),
    the ranks waiting at a barrier before and after it, so that no rank
    runs ahead of a file being written; else just fn(*args). Returns
    fn's result on rank 0, None on the others."""
    if not ranked:
        return fn(*args)
    dist.barrier()
    out = fn(*args) if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def broadcast_object(obj, ranked: bool):
    """Rank 0's `obj` on every rank when `ranked`, else `obj`."""
    if not ranked:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """A world of dp x sp ranks as rows of sp consecutive ranks, JAX's
    Mesh(devices.reshape(dp, sp), ("data", "sample")): rank d * sp + s
    is row d (its ray shard) and place s in the row's ring (its
    t-window). `sp_group` holds the rank's row, `dp_group` its column
    (ranks s, sp + s, ...)."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    dp_group: object
    sp_group: object


def make_rank_grid(dp: int, sp: int) -> RankGrid:
    """The rank's place in a dp x sp grid of the current process group,
    whose size must be dp * sp. Every rank creates every row's and every
    column's group, in the same order (torch.distributed's rule for
    new_group), and keeps its own two."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"a {dp} x {sp} grid of ranks needs a process "
                         f"group of {dp * sp} ranks, not {world}")
    rows = [dist.new_group(list(range(d * sp, (d + 1) * sp)))
            for d in range(dp)]
    cols = [dist.new_group(list(range(s, world, sp))) for s in range(sp)]
    d, s = divmod(rank, sp)
    return RankGrid(dp=dp, sp=sp, dp_index=d, sp_index=s, dp_group=cols[s],
                    sp_group=rows[d])
