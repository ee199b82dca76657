"""The rank side of tests/test_torch_dp_stages45.py: one process per rank
of a gloo group on 127.0.0.1, started with multiprocessing's spawn
method. It imports torch and the port only. Each rank runs the stage-4
and stage-5 CLIs with --num_devices 2, then reads the inputs the test
wrote, steps the DP trainers on them, trains a stage-4 trainer through
its prefetcher, and writes its readings to out<rank>.pt."""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from quadraturefields_tpu_torch.cli import train_finetune as tcli4
from quadraturefields_tpu_torch.cli import train_fit_sg as tcli5
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays, SubjectLoader
from quadraturefields_tpu_torch.geometry.meshio import Mesh
from quadraturefields_tpu_torch.ops.grid import OccGridState
from quadraturefields_tpu_torch.parallel.multihost import shard_batch
from quadraturefields_tpu_torch.train import stage4_finetune as tst4
from quadraturefields_tpu_torch.train import stage5_fit_sg as tst5
from quadraturefields_tpu_torch.train.stage1_ngp import (
    _as_leaf_params,
    _leaves,
)
from torch_dp_ranks import StandIn, digest, grad, tree_map, wait_for_inputs

# the CLIs' tiny configs, as tests/test_torch_stage5.py patches them
CLI_STAGE4 = dict(grid_resolution=32, freeze_rf_steps=2,
                  mesh_update_every=2, field_max_res=32,
                  field_log2_hashmap_size=10, max_num_rays=1 << 12)
CLI_STAGE5 = dict(grid_resolution=32, max_num_rays=1 << 12)
# the prefetcher run: PREFETCH_STEPS steps, a mesh update after step
# PREFETCH_UPDATE_AT
PREFETCH_STEPS, PREFETCH_UPDATE_AT = 14, 6


def cli_argv(work: str, root: str) -> tuple[list, list]:
    """The stage-4 and stage-5 CLIs' arguments (run_nerfsynthetic's
    flags at tiny widths), --num_devices 2, writing under `root`; stage
    5 reads rank 0's stage-4 checkpoint and mesh."""
    common = ["--scene", "fixture", "--data_root", os.path.join(work, "data"),
              "--root", root, "--num_lobes", "0", "--log2_hashmap_size",
              "10", "--up_sample", "2.0", "--max_hits", "8",
              "--max_iterations", "3", "--batch_size", "10", "--scale",
              "1.5", "--num_devices", "2"]
    runs0 = os.path.join(work, "runs0")
    argv4 = common + ["--ckpt_path", os.path.join(work, "ngp.pt"),
                      "--mesh_path", os.path.join(work, "smp_mesh.ply")]
    argv5 = common[:6] + ["--num_lobes", "2"] + common[8:] + [
        "--ckpt_path",
        os.path.join(runs0, "ckpts", "fixture", "finetune", "finetune.pt"),
        "--mesh_path",
        os.path.join(runs0, "results", "fixture", "finetune", "mesh.ply")]
    return argv4, argv5


def run_clis(work: str, rank: int) -> dict:
    """Both CLIs over the ranks, each rank with its own --root (so a file
    that rank 1 wrote would show): the trainers' final digests, their
    world and rank, and the files under this rank's root."""
    trainers = {}

    class Stage4(tst4.Stage4Trainer):
        def train(self, *args, **kwargs):
            trainers["finetune"] = self
            return super().train(*args, **kwargs)

    class Stage5(tst5.Stage5Trainer):
        def train(self, *args, **kwargs):
            trainers["fit_sg"] = self
            return super().train(*args, **kwargs)

    tcli4.Stage4Config = functools.partial(tst4.Stage4Config, **CLI_STAGE4)
    tcli4.Stage4Trainer = Stage4
    tcli5.Stage5Config = functools.partial(tst5.Stage5Config, **CLI_STAGE5)
    tcli5.Stage5Trainer = Stage5
    root = os.path.join(work, f"runs{rank}")
    argv4, argv5 = cli_argv(work, root)
    tcli4.main(argv4, device="cpu")
    # stage 5 reads rank 0's files, which on_rank0's barrier has written
    tcli5.main(argv5, device="cpu")
    t4, t5 = trainers["finetune"], trainers["fit_sg"]
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"files": files, "finetune": digest(_leaves(t4.params)),
            "vertices": digest([torch.as_tensor(
                t4.mesh_intersect.mesh.vertices)]),
            "fit_sg": digest(_leaves(t5.sg_params)),
            "world": (t4.world, t5.world), "rank": (t4.rank, t5.rank)}


def _f32(trainer, *names):
    for name in names:
        setattr(trainer, name, dataclasses.replace(
            getattr(trainer, name), compute_dtype="float32"))


def stage4_trainer(inp: dict, **config) -> tst4.Stage4Trainer:
    """Stage4Trainer(num_devices=2) on the test's NGP, field, occupancy
    and sphere mesh, f32 MLPs, its prefetcher stopped."""
    cfg = tst4.Stage4Config(**{**inp["config"], **config}, num_devices=2)
    tr = tst4.Stage4Trainer(
        cfg, ngp_params=tree_map(torch.clone, inp["rf"]),
        mesh=Mesh(*inp["mesh"]),
        occ_state=OccGridState(occs=inp["occs"], binaries=inp["binaries"],
                               aabb=torch.as_tensor(cfg.aabb)),
        train_dataset=StandIn(inp["batch"], 96), device="cpu")
    tr.prefetcher.stop()
    # copies: Adam steps the leaves in place
    tr.params["field"] = _as_leaf_params(tree_map(torch.clone, inp["field"]))
    tr._make_optimizer()
    _f32(tr, "ngp_cfg")
    return tr


def rank_batch(tr, inp: dict) -> tuple:
    """The step's arguments on this rank: its slice of the global batch
    and noise, and the hits of its slice cast by its prefetcher's cast
    (the rank's rays of the global batch, at its share of the cap)."""
    o, d, px, bkgd = inp["batch"]
    batch = {"rays": Rays(o, d), "pixels": px, "color_bkgd": bkgd}
    hits, _ = tr.prefetcher._cast(batch)
    _, hit_args = tr._hit_args((batch, *hits))
    arrays = shard_batch([torch.as_tensor(a) for a in (o, d, px)]
                         + list(inp.get("noise", ())), tr.world, tr.rank)
    return arrays, torch.as_tensor(bkgd), hit_args, hits


def stage4_steps(inp: dict) -> dict:
    """For each transport and each of a frozen and a joint step, from the
    test's state: Stage4Trainer(num_devices=2)'s step on the global
    batch and noise."""
    out = {}
    for slack in inp["pack_slacks"]:
        for freeze in (True, False):
            tr = stage4_trainer(inp, pack_slack=slack)
            (o, d, px, tj, bary), bkgd, hit_args, _ = rank_batch(tr, inp)
            loss, nh, mse = tr._train_step_impl(
                o, d, px, bkgd, hit_args, tj, bary, freeze_rf=freeze)
            out[slack, freeze] = {
                "loss": float(loss), "n_hits": int(nh), "mse": float(mse),
                "grads": tree_map(grad, tr.params),
                "cache_d": tr.cache_d, "cache_w": tr.cache_w,
                "digest": digest(_leaves(tr.params)
                                 + [tr.cache_d, tr.cache_w])}
    return out


def stage4_truncating(inp: dict) -> dict:
    """A frozen step at a per-rank cap of `cap` hits, which rank 0's
    rays overrun and rank 1's do not: the rank's true and rendered hits,
    its own loss (its slice's ray means and its hit mean of the
    regularizer, as one device computes them on the slice), that
    regularizer, and the DP step's loss and hit count."""
    inp = inp["truncating"]
    tr = stage4_trainer(inp)
    tr.pack_cap = tr.prefetcher.packed_cap = inp["cap"]
    (o, d, px, tj, bary), bkgd, hit_args, hits = rank_batch(tr, inp)
    with torch.no_grad():
        own, aux = tr._loss_fn(tr.params, o, d, px, bkgd, hit_args, tj,
                               bary, True, tst4.local_rcfg(tr.rcfg, tr.world))
    loss, nh, _ = tr._train_step_impl(o, d, px, bkgd, hit_args, tj, bary,
                                      freeze_rf=True)
    rendered = tr._hit_counts(hit_args, o.shape[0])[0]
    return {"total": int(hits[3]), "rendered": int(rendered),
            "own_loss": float(own), "reg": float(aux["reg"]),
            "loss": float(loss), "n_hits": int(nh)}


def stage5_step(inp: dict) -> dict:
    """Stage5Trainer(num_devices=2)'s step on the global batch, from the
    test's state."""
    cfg = tst5.Stage5Config(**inp["config"], num_devices=2)
    tr = tst5.Stage5Trainer(
        cfg, teacher_params=inp["teacher"], mesh=Mesh(*inp["mesh"]),
        occ_state=OccGridState(occs=inp["occs"], binaries=inp["binaries"],
                               aabb=torch.as_tensor(cfg.aabb)),
        train_dataset=StandIn(inp["batch"], 64), device="cpu")
    tr.prefetcher.stop()
    tr.sg_params = _as_leaf_params(tree_map(torch.clone, inp["sg"]))
    tr._make_optimizer()
    _f32(tr, "sg_cfg", "teacher_cfg")
    (o, d, px), bkgd, hit_args, _ = rank_batch(tr, inp)
    loss, nh, mse = tr._train_step_impl(o, d, px, bkgd, hit_args)
    return {"loss": float(loss), "n_hits": int(nh), "mse": float(mse),
            "grads": tree_map(grad, tr.sg_params),
            "digest": digest(_leaves(tr.sg_params))}


def prefetched_run(work: str, inp: dict, num_devices: int) -> list:
    """PREFETCH_STEPS steps of a stage-4 trainer through train_one_step
    and its live prefetcher on the fixture loader (a 2^10 sample target,
    so the dynamic batch moves), with a mesh update after step
    PREFETCH_UPDATE_AT. Per step: the global batch's size, a digest of
    its rays, and the loss."""
    cfg = tst4.Stage4Config(**{**inp["config"], **inp["prefetch"]},
                            num_devices=num_devices)
    loader = SubjectLoader(subject_id="fixture",
                           root_fp=os.path.join(work, "data"), split="train",
                           num_rays=cfg.init_batch_size,
                           upsample=cfg.up_sample, seed=cfg.seed)
    tr = tst4.Stage4Trainer(
        cfg, ngp_params=tree_map(torch.clone, inp["rf"]),
        mesh=Mesh(*inp["mesh"]),
        occ_state=OccGridState(occs=inp["occs"], binaries=inp["binaries"],
                               aabb=torch.as_tensor(cfg.aabb)),
        train_dataset=loader, device="cpu")
    seen = []
    take = tr.prefetcher.next

    def watched(num_rays):
        item = take(num_rays)
        rays = item[0]["rays"]
        h = hashlib.sha256(np.ascontiguousarray(rays.origins).tobytes())
        h.update(np.ascontiguousarray(rays.viewdirs).tobytes())
        seen.append((rays.origins.shape[0], h.hexdigest()))
        return item

    tr.prefetcher.next = watched
    losses = []
    try:
        for step in range(PREFETCH_STEPS):
            losses.append(float(tr.train_one_step()[0]))
            if step == PREFETCH_UPDATE_AT:
                tr.apply_mesh_update()
    finally:
        tr.prefetcher.stop()
    return [(n, h, loss) for (n, h), loss in zip(seen, losses)]


def rank_main(rank: int, world: int, port: int, work: str) -> None:
    """One rank: the environment torchrun would set, the CLIs (whose
    first call joins the group), the steps on the test's inputs, the
    prefetched run, then out<rank>.pt."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        out = {"cli": run_clis(work, rank)}
        inputs = wait_for_inputs(work)
        out["stage4"] = stage4_steps(inputs["stage4"])
        out["truncating"] = stage4_truncating(inputs["stage4"])
        out["stage5"] = stage5_step(inputs["stage5"])
        out["prefetched"] = prefetched_run(work, inputs["stage4"], world)
        torch.save(out, os.path.join(work, f"out{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
