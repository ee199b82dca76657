"""The rank side of tests/test_torch_sp.py: one process per rank of a
gloo group of 4 on 127.0.0.1, started with multiprocessing's spawn
method. It imports torch and the port only. Each rank renders the
test's cases through parallel/sp.py over groups of 1 (rank 0), 2
(ranks 0-1) and 4 ranks and over a 2 x 2 RankGrid, and writes its
readings to out<rank>.pt."""
from __future__ import annotations

import os
from unittest import mock

import torch
import torch.distributed as dist

from quadraturefields_tpu_torch.models.ngp import NGPConfig
from quadraturefields_tpu_torch.ops.grid import OccGridState
from quadraturefields_tpu_torch.parallel import sp
from quadraturefields_tpu_torch.parallel.multihost import (
    init_distributed,
    make_rank_grid,
)
from quadraturefields_tpu_torch.render.renderer import RenderConfig
from torch_dp_ranks import wait_for_inputs

WORLD = 4
# the stratified renders' generator seed, the same on every rank
STRATIFIED_SEED = 7


def render_case(make, case: dict, **kw):
    """(rgb, opacity, depth, num_valid) of `case` through make(aabb,
    ngp_cfg, rcfg) on white."""
    aabb = case["aabb"]
    render = make(aabb, NGPConfig(**case["ngp_cfg"]),
                  RenderConfig(**case["rcfg"]))
    occ = OccGridState(occs=case["occs"], binaries=case["binaries"],
                       aabb=aabb)
    out = render(case["params"], occ, case["origins"], case["viewdirs"],
                 render_bkgd=torch.ones(3), **kw)
    return tuple(out[:3]) + (int(out[3]),)


def stratified(make, case: dict):
    gen = torch.Generator().manual_seed(STRATIFIED_SEED)
    return render_case(make, case, generator=gen, stratified=True)


def recorded(make, case: dict) -> tuple:
    """render_case with the window's gathered optical depths and its
    partials before their sum recorded: (render, [R] optical depth of
    each window, this window's [R, 5] partials)."""
    seen = {}
    gather, reduce = dist.all_gather, dist.all_reduce

    def watched_gather(parts, t, group=None):
        gather(parts, t, group=group)
        seen.setdefault("taus", [p[:, 0].clone() for p in parts])

    def watched_reduce(t, *args, **kwargs):
        if t.dim() == 2 and t.shape[1] == 5:
            seen.setdefault("part", t.clone())
        return reduce(t, *args, **kwargs)

    with mock.patch.object(dist, "all_gather", watched_gather), \
            mock.patch.object(dist, "all_reduce", watched_reduce):
        out = render_case(make, case)
    return out, seen["taus"], seen["part"]


def rank_main(rank: int, world: int, port: int, work: str) -> None:
    """One rank: joins the group from torchrun's environment, makes the
    groups every rank must make (in one order), renders, saves."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        init_distributed("gloo")
        one, two = dist.new_group([0]), dist.new_group([0, 1])
        grid = make_rank_grid(2, 2)
        inputs = wait_for_inputs(work)
        out = {"grid": (grid.dp_index, grid.sp_index,
                        dist.get_process_group_ranks(grid.dp_group),
                        dist.get_process_group_ranks(grid.sp_group))}
        groups = {1: one, 2: two, 4: None}
        for name, case in inputs.items():
            for n, group in groups.items():
                if rank >= n:
                    continue

                def make(*a, group=group):
                    return sp.make_sp_render(*a, group=group)

                if name == "early_stop" and n == 2:
                    out[name, n], out["taus"], out["part"] = recorded(
                        make, case)
                else:
                    out[name, n] = render_case(make, case)
                if name == "uniform" and n <= 2:
                    out["stratified", n] = stratified(make, case)
            out[name, "dp_sp"] = render_case(
                lambda *a: sp.make_dp_sp_render(*a, grid), case)
        torch.save(out, os.path.join(work, f"out{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
