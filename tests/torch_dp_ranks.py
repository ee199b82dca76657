"""The rank side of tests/test_torch_dp.py: one process per rank of a
gloo group on 127.0.0.1, started with multiprocessing's spawn method.
It imports torch and the port only. Each rank reads the inputs the test
wrote, runs the data-parallel CLIs, steps and refreshes on them, and
writes its readings to out<rank>.pt for the test to check."""
from __future__ import annotations

import functools
import hashlib
import os
import time

import torch
import torch.distributed as dist

from quadraturefields_tpu_torch.cli import train_field as tcli2
from quadraturefields_tpu_torch.cli import train_ngp as tcli1
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
from quadraturefields_tpu_torch.models.ngp import NGPConfig, ngp_query_density
from quadraturefields_tpu_torch.ops.grid import (
    OccGridConfig,
    OccGridState,
    occ_grid_update,
)
from quadraturefields_tpu_torch.parallel.dp import make_dp_occ_eval
from quadraturefields_tpu_torch.train import stage1_ngp as tst1
from quadraturefields_tpu_torch.train import stage2_field as tst2


def grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad


def digest(leaves) -> str:
    """sha256 of the leaves' bytes, in order."""
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class StandIn:
    """A dataset whose every batch is the same rays, (origins, viewdirs,
    pixels, bkgd); num_rays is only what the dynamic batch sets."""
    HEIGHT = WIDTH = 8

    def __init__(self, batch=None, num_rays=96):
        self.batch, self.num_rays = batch, num_rays

    def __len__(self):
        return 1

    def update_num_rays(self, n):
        self.num_rays = n

    def fetch_train_batch(self):
        o, d, px, bkgd = self.batch
        return {"rays": Rays(o, d), "pixels": px, "color_bkgd": bkgd}


# the CLIs' tiny configs, as tests/test_torch_stage2.py patches them: a
# 32^3 grid (stage 2 must match stage 1's), 256-ray eval chunks, and a
# stage-1 checkpoint at the last of 4 steps
CLI_STAGE1 = dict(grid_resolution=32, eval_chunk=256, ckpt_every=3)
CLI_STAGE2 = dict(grid_resolution=32)


def cli_argv(work: str, root: str) -> tuple[list, list]:
    """The stage-1 and stage-2 CLIs' arguments, --num_devices 2, writing
    under `root`; stage 2 reads rank 0's stage-1 checkpoint."""
    common = ["--scene", "fixture", "--data_root", os.path.join(work, "data"),
              "--root", root, "--num_lobes", "0", "--log2_hashmap_size",
              "10", "--max_steps", "3", "--batch_size", "12",
              "--num_devices", "2"]
    ckpt = os.path.join(work, "runs0", "ckpts", "fixture", "nerf", "ngp.pt")
    return (common + ["--exp_name", "nerf"],
            common + ["--ckpt_path", ckpt, "--field_log2_hashmap_size", "10",
                      "--grid_export_size", "8"])


def run_clis(work: str, rank: int) -> dict:
    """Both CLIs over the ranks, each rank with its own --root (so a file
    that rank 1 wrote would show). Returns the trainers' final params'
    digests, the eval metrics and the files under this rank's root."""
    trainers = {}

    class Stage1(tst1.Stage1Trainer):
        def train(self, *args, **kwargs):
            trainers["ngp"] = self
            return super().train(*args, **kwargs)

    class Stage2(tst2.Stage2Trainer):
        def train(self, *args, **kwargs):
            trainers["field"] = self
            return super().train(*args, **kwargs)

    tcli1.Stage1Config = functools.partial(tst1.Stage1Config, **CLI_STAGE1)
    tcli1.Stage1Trainer = Stage1
    tcli2.Stage2Config = functools.partial(tst2.Stage2Config, **CLI_STAGE2)
    tcli2.Stage2Trainer = Stage2
    root = os.path.join(work, f"runs{rank}")
    argv1, argv2 = cli_argv(work, root)
    metrics = tcli1.main(argv1, device="cpu")
    tcli2.main(argv2, device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"metrics": metrics, "files": files,
            "ngp": digest(tst1._leaves(trainers["ngp"].params)),
            "field": digest(tst1._leaves(trainers["field"].field_params)),
            "world": trainers["ngp"].world, "rank": trainers["ngp"].rank}


def stage1_step(inp: dict) -> dict:
    """Stage1Trainer(num_devices=2)'s DP step on the global batch."""
    cfg = tst1.Stage1Config(**inp["config"], num_devices=2)
    tr = tst1.Stage1Trainer(cfg, device="cpu")
    tr.params = tst1._as_leaf_params(inp["params"])
    tr._make_optimizer()
    tr.occ_state = OccGridState(occs=inp["occs"], binaries=inp["binaries"],
                                aabb=tr.aabb)
    loss, aux = tr._train_step_impl(*inp["batch"])
    return {"loss": float(loss), "num_valid": int(aux["num_valid"]),
            "mse": float(aux["mse"]), "grads": tree_map(grad, tr.params),
            "params": tree_map(torch.Tensor.detach, tr.params),
            "digest": digest(tst1._leaves(tr.params)),
            "budget": tr.rcfg.max_samples_total // tr.world}


def occ_updates(inp: dict) -> list:
    """occ_grid_update through make_dp_occ_eval at each (step, state,
    jitter)."""
    aabb, cfg = inp["aabb"], NGPConfig(**inp["ngp_cfg"])

    def occ_eval_fn(x):
        d = ngp_query_density(inp["params"], x, aabb, cfg)
        return d[..., 0] * inp["step_size"]

    out = []
    for step, occs, binaries, jitter in inp["cases"]:
        with torch.no_grad():
            new = occ_grid_update(
                OccGridState(occs=occs, binaries=binaries, aabb=aabb), step,
                make_dp_occ_eval(occ_eval_fn),
                OccGridConfig(**inp["occ_cfg"]), jitter=jitter)
        out.append((new.occs, new.binaries))
    return out


def field_trainer(inp: dict, **config) -> tst2.Stage2Trainer:
    """Stage2Trainer(num_devices=2) on the test's NGP, occupancy, field
    and rays, `config` over the test's config."""
    cfg = tst2.Stage2Config(**{**inp["config"], **config}, num_devices=2)
    tr = tst2.Stage2Trainer(
        cfg, ngp_params=inp["ngp_params"],
        occ_state=OccGridState(occs=inp["occs"], binaries=inp["binaries"],
                               aabb=torch.as_tensor(cfg.aabb)),
        train_dataset=StandIn(inp["batch"][:4], inp["num_rays"]),
        device="cpu")
    tr.field_params = tst1._as_leaf_params(inp["field_params"])
    tr._make_optimizer()
    return tr


def field_step(inp: dict) -> dict:
    """Stage2Trainer(num_devices=2)'s DP step on the global batch."""
    tr = field_trainer(inp)
    loss, aux = tr._train_step_impl(*inp["batch"])
    return {"loss": float(loss), "n_valid": int(aux["num_valid"]),
            "grads": tree_map(grad, tr.field_params),
            "params": tree_map(torch.Tensor.detach, tr.field_params),
            "digest": digest(tst1._leaves(tr.field_params))}


def field_truncating(inp: dict) -> dict:
    """One train_one_step of Stage2Trainer(num_devices=2) at a budget
    that the rays overrun (its jitter from the generator at
    inp["seed"], at step 1: no refresh): the rank's demand and kept
    samples, the step's num_valid and the dynamic batch after it."""
    tr = field_trainer(inp, batch_size_log2=inp["batch_size_log2"])
    seen = {}
    loss_fn = tr._loss_fn

    def watched(*args):
        loss, aux = loss_fn(*args)
        seen.update(demand=int(aux["num_valid"]), kept=int(aux["kept"]))
        return loss, aux

    tr._loss_fn = watched
    tr.step = 1
    tr.generator.manual_seed(inp["seed"])
    _, n_valid, _ = tr.train_one_step()
    return {**seen, "n_valid": n_valid, "budget": tr.rcfg.max_samples_total
            // tr.world, "num_rays": tr.train_dataset.num_rays,
            "digest": digest(tst1._leaves(tr.field_params))}


INPUTS = "inputs.pt"
INPUTS_TIMEOUT_S = 200


def wait_for_inputs(work: str) -> dict:
    """The inputs the test writes while the ranks run the CLIs (it
    renames the file into place whole)."""
    path = os.path.join(work, INPUTS)
    deadline = time.monotonic() + INPUTS_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {INPUTS_TIMEOUT_S} s")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def rank_main(rank: int, world: int, port: int, work: str) -> None:
    """One rank: the environment torchrun would set, the CLIs (whose
    first call joins the group), the steps on the test's inputs, then
    out<rank>.pt."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        out = {"cli": run_clis(work, rank)}
        inputs = wait_for_inputs(work)
        out["stage1"] = stage1_step(inputs["stage1"])
        out["occ"] = occ_updates(inputs["occ"])
        out["field"] = field_step(inputs["field"])
        out["field_truncating"] = field_truncating(inputs["field"])
        out["pid"] = os.getpid()
        torch.save(out, os.path.join(work, f"out{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tree_map(fn, tree):
    """fn of each tensor of a params tree, in the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
