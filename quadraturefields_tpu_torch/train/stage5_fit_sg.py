"""Stage 5: fit a spherical-Gaussian appearance model at mesh hits.

Port of quadraturefields_tpu/train/stage5_fit_sg.py (reference
examples/train_fit_sg.py) on one device or, with num_devices > 1, over
torch.distributed ranks. The SG model (the NGP with the
SG head: diffuse(3) + num_lobes x [axis(3), lambda(1), color(3)])
learns rgb at the ray-mesh hits of the stage-4 mesh; the density comes
from the frozen stage-4 radiance field, queried without a graph
(utils.py:701-706), composited at a constant delta and held to the
pixels by a smooth-L1 loss (train_fit_sg.py:455-456). A step:
  1. takes the next batch from the host BVH prefetcher: a packed hit
     stream (slots, triangles, depths; 12 B a hit), sliced to the √2
     bucket of its true hit count (pack_slack > 0, the default), or
     dense [R, max_hits] rows (pack_slack 0);
  2. renders it (render/quadrature.py): the SG model's encode (K2 on
     the card), the teacher's (K2, no graph), the composite (K3 on the
     packed stream);
  3. backpropagates (the SG table's gradient is one K1 launch on the
     card) and steps Adam (eps 1e-15) on the reference schedule with a
     1000-step warm-up;
  4. sizes the next ray batch from the step's true hit count, read on
     the host as JAX reads it.
Every 16 steps the occupancy grid is refreshed from the teacher's
density, as the JAX trainer does. The teacher and the occupancy come
from the port's stage-4 checkpoint (`Stage4Trainer.save`'s
finetune.pt: radiance_field, occs, binaries) or are handed in; orbax
checkpoints of the JAX package are not read.

Data parallelism (JAX's make_dp_fit_sg_train_step): every rank holds
the SG model and the teacher whole, draws the same global batch (its
prefetcher follows the step, geometry/intersect.py), casts only its
slice of the rays and packs it to its share of the hit budget. Its loss
is its slice's masked ray mean; one all-reduce (allreduce_grads) takes
the mean of the losses and gradients over the ranks (pmean: the single
device's, the slices being equal, where no rank's cap truncates), and
one sums the hit counts. Every rank refreshes the occupancy grid from
the frozen teacher alike, as JAX does, and runs Adam on the same sums;
rank 0 alone writes.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.nerf_synthetic import SubjectLoader
from ..geometry.intersect import HitPrefetcher, MeshIntersection
from ..geometry.meshio import Mesh
from ..models.ngp import NGPConfig, ngp_init, ngp_query_density
from ..ops.grid import OccGridConfig, OccGridState, occ_grid_init, \
    occ_grid_update
from ..parallel.dp import allreduce_grads, broadcast_params, psum_count
from ..parallel.multihost import on_rank0, rank_device, shard_batch, \
    world_and_rank
from ..render.quadrature import (
    HitRows,
    packed_hits_from_host,
    render_fit_sg_packed_stream,
    render_fit_sg_rows,
)
from ..utils.batching import bucket_num_rays, snap_pack_cap
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import smooth_l1_loss
from ..utils.optim import make_ngp_optimizer
from .stage1_ngp import MIPNERF360_UNBOUNDED_SCENES, _as_leaf_params, _leaves
from .stage4_finetune import _ngp_rgb_sigma


@dataclasses.dataclass
class Stage5Config:
    """The JAX trainer's config, field for field. `num_devices` > 1
    trains over that many torch.distributed ranks (parallel/dp.py)."""

    scene: str = "lego"
    data_root: str = "data/nerf_synthetic"
    exp_name: str = "finetune_sg"
    root: str = "runs/"
    ckpt_path: str = ""     # stage-4 finetune checkpoint
    mesh_path: str = ""     # mesh.ply from stage 4
    max_steps: int = 20000
    init_batch_size: int = 1024
    batch_size_log2: int = 18
    occ_thres: float = 0.01
    scaling: float = 0.0434
    up_sample: int = 2
    max_hits: int = 25
    num_lobes: int = 6
    num_layers: int = 2
    log2_hashmap_size: int = 19
    n_levels: int = 16
    n_features: int = 2
    interp: str = "tet"
    grad_mode: str = "auto"
    layout: str = "corner"    # must match the stage-4 checkpoint
    grad_payload: str = "f32"
    scale: float = 1.5
    lr: float = 2e-2
    grid_resolution: int = 128
    render_step_size: float = 5e-3
    ckpt_every: int = 1000
    log_every: int = 100
    seed: int = 42
    max_num_rays: int = 1 << 18
    # the packed hit stream's budget, a multiple of the sample target;
    # 0 takes the dense rows
    pack_slack: float = 1.25
    num_devices: int = 0
    eval_views: Optional[int] = None
    # unbounded/360: "auto" switches on MIPNERF360_UNBOUNDED_SCENES
    # (reference train_fit_sg.py:233-260); "360"/"synthetic" force it
    scene_type: str = "auto"
    data_factor: int = 4      # 360 loader downsample factor

    @property
    def is_unbounded(self) -> bool:
        if self.scene_type == "auto":
            return self.scene in MIPNERF360_UNBOUNDED_SCENES
        return self.scene_type == "360"

    @property
    def target_sample_batch_size(self) -> int:
        return 1 << self.batch_size_log2

    @property
    def pack_cap(self) -> int:
        """The static packed-hit budget: slack x the sample target,
        rounded up to 1024."""
        cap = int(self.pack_slack * self.target_sample_batch_size)
        return -(-cap // 1024) * 1024

    @property
    def aabb(self) -> np.ndarray:
        if self.is_unbounded:
            return np.array([-1, -1, -1, 1, 1, 1], np.float32)
        return np.array([-1, -1, -1, 1, 1, 1], np.float32) * self.scale

    @property
    def eff_render_step_size(self) -> float:
        return 1e-3 if self.is_unbounded else self.render_step_size

    def sg_config(self) -> NGPConfig:
        return NGPConfig(
            head="sg",
            use_viewdirs=False,
            unbounded=self.is_unbounded,
            num_g_lobes=self.num_lobes,
            num_layers=self.num_layers,
            log2_hashmap_size=self.log2_hashmap_size,
            n_levels=self.n_levels,
            n_features=self.n_features,
            interp=self.interp,
            grad_mode=self.grad_mode,
            layout=self.layout,
            grad_payload=self.grad_payload,
        )

    def teacher_config(self) -> NGPConfig:
        return NGPConfig(
            head="mlp",
            use_viewdirs=False,
            unbounded=self.is_unbounded,
            num_layers=self.num_layers,
            log2_hashmap_size=self.log2_hashmap_size,
            n_levels=self.n_levels,
            n_features=self.n_features,
            interp=self.interp,
            grad_mode=self.grad_mode,
            layout=self.layout,
            grad_payload=self.grad_payload,
        )


class Stage5Trainer:
    """The stage-5 trainer on one device, or with cfg.num_devices > 1 on
    each rank of a torch.distributed group of that size (a device "cuda"
    without an index is then cuda:LOCAL_RANK). `sg_params` are the SG
    model's leaves; after assigning them (e.g. weights carried across
    with utils/convert.py) call `_make_optimizer`."""

    def __init__(self, cfg: Stage5Config, teacher_params=None,
                 occ_state: Optional[OccGridState] = None,
                 mesh: Optional[Mesh] = None, train_dataset=None,
                 device="cuda"):
        self._dp = bool(cfg.num_devices and cfg.num_devices > 1)
        if self._dp:
            self.world, self.rank = world_and_rank(cfg.num_devices)
            device = rank_device(device)
        else:
            self.world, self.rank = 1, 0
        # full-f32 matmuls: the bf16-operand MLPs keep f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.sg_cfg = cfg.sg_config()
        self.teacher_cfg = cfg.teacher_config()
        self.occ_cfg = OccGridConfig(resolution=cfg.grid_resolution,
                                     occ_thre=cfg.occ_thres)
        self.aabb = torch.as_tensor(cfg.aabb, device=self.device)

        if teacher_params is None:
            if not cfg.ckpt_path:
                raise ValueError("need teacher_params or ckpt_path")
            ckpt = load_checkpoint(cfg.ckpt_path, map_location=self.device)
            teacher_params = ckpt["radiance_field"]
            occ_state = OccGridState(
                occs=ckpt["occs"].to(torch.float32),
                binaries=ckpt["binaries"].to(torch.bool), aabb=self.aabb)
        # the frozen teacher: plain tensors, no gradient
        self.teacher_params = _detached(teacher_params)
        self.occ_state = occ_state or occ_grid_init(self.aabb, self.occ_cfg,
                                                    self.device)

        # mesh.ply from stage 4 is already world-scaled: scale 1, no
        # simplification (train_fit_sg.py:220-227)
        self.mesh_intersect = MeshIntersection(
            mesh_path=cfg.mesh_path or None, mesh=mesh, simplify_mesh=False,
            scale=1.0, num_intersections=cfg.max_hits,
            render_step_size=cfg.eff_render_step_size,
        )

        # one generator for the SG init, then the occupancy refresh
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(cfg.seed)
        self.sg_params = _as_leaf_params(
            ngp_init(self.generator, self.sg_cfg, self.device))
        self.step = 0
        self._make_optimizer()
        if self._dp:
            broadcast_params(_leaves(self.sg_params))

        if train_dataset is not None:
            self.train_dataset = train_dataset
        elif cfg.is_unbounded:
            from ..data.nerf_360_v2 import SubjectLoader as Loader360

            self.train_dataset = Loader360(
                subject_id=cfg.scene, root_fp=cfg.data_root, split="train",
                num_rays=cfg.init_batch_size, color_bkgd_aug="random",
                factor=cfg.data_factor, seed=cfg.seed,
            )
        else:
            self.train_dataset = SubjectLoader(
                subject_id=cfg.scene, root_fp=cfg.data_root, split="train",
                num_rays=cfg.init_batch_size, upsample=cfg.up_sample,
                seed=cfg.seed,
            )
        # the packed host transport: 12 B a hit instead of dense
        # [R, max_hits] rows (stage 5 needs no face vertices), each rank
        # packing to its share of the budget (JAX's shard cap)
        self._packed = cfg.pack_slack > 0
        self.pack_cap = -(-cfg.pack_cap // self.world // 256) * 256
        # the ray batch the dynamic batch asks for next
        self.num_rays = int(self.train_dataset.num_rays)
        self.prefetcher = HitPrefetcher(
            self._draw_batch, self.mesh_intersect, depth=2,
            packed_cap=self.pack_cap if self._packed else None,
            num_rays=self.num_rays, shard=(self.world, self.rank),
        )

    def _draw_batch(self, num_rays: int) -> dict:
        """The loader's next batch at num_rays rays (the prefetch
        thread's draw, the only caller)."""
        self.train_dataset.update_num_rays(num_rays)
        return self.train_dataset.fetch_train_batch()

    def _make_optimizer(self):
        """Adam over the SG leaves (eps 1e-15, no weight decay) on the
        reference schedule with a 1000-step warm-up and the reference's
        milestones (max/4, max*2, max*6/10), continuing from self.step."""
        m = self.cfg.max_steps
        self.optimizer, self.scheduler = make_ngp_optimizer(
            _leaves(self.sg_params), m, lr=self.cfg.lr, weight_decay=0.0,
            warmup_iters=1000, start_step=self.step,
            milestones=[m // 4, m * 2, m * 6 // 10])

    def _to_device(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _occ_update(self, step: int) -> OccGridState:
        def occ_eval_fn(x):
            d = ngp_query_density(self.teacher_params, x, self.aabb,
                                  self.teacher_cfg)
            return d[..., 0] * self.cfg.eff_render_step_size

        with torch.no_grad():
            return occ_grid_update(
                self.occ_state, step, occ_eval_fn, self.occ_cfg,
                contract_aabb=self.aabb if self.cfg.is_unbounded else None,
                generator=self.generator,
            )

    def _loss_fn(self, sg_params, origins, viewdirs, pixels, bkgd,
                 hit_args):
        """(loss, (rgb, n_hits)) of one batch. hit_args: packed ->
        (slots, tri, ts, num_valid); dense -> (tri_ids, ts, valid)."""
        kwargs = dict(ngp_forward_fn=_ngp_rgb_sigma,
                      render_step_size=self.cfg.eff_render_step_size,
                      bg_color="random", render_bkgd=bkgd)
        ray_mask = None
        if self._packed:
            slots, tri, ts, num_valid = hit_args
            ph = packed_hits_from_host(
                slots, tri, ts, num_valid, n_rays=origins.shape[0],
                max_hits=self.cfg.max_hits)
            rgb, _, _, _, _, ray_mask = render_fit_sg_packed_stream(
                sg_params, self.teacher_params, ph, origins.shape[0],
                origins, viewdirs, self.aabb, self.sg_cfg, self.teacher_cfg,
                **kwargs)
            n_hits = ph.num_valid
        else:
            tri_ids, ts, valid = hit_args
            rgb, _, _, _ = render_fit_sg_rows(
                sg_params, self.teacher_params,
                HitRows(tri_ids=tri_ids, ts=ts, valid=valid), origins,
                viewdirs, self.aabb, self.sg_cfg, self.teacher_cfg, **kwargs)
            n_hits = valid.sum()
        loss = smooth_l1_loss(rgb, pixels, ray_mask=ray_mask)
        return loss, (rgb, n_hits)

    def _train_step_impl(self, origins, viewdirs, pixels, bkgd, hit_args):
        """Loss, backward, one Adam update (the schedule steps after
        it); returns (loss, n_hits, rgb MSE). Over ranks every argument
        is the rank's slice of the global batch (train_one_step cuts
        it), and the loss, MSE and gradients are averaged and the hit
        counts summed over the ranks before Adam."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, (rgb, n_hits) = self._loss_fn(self.sg_params, origins,
                                            viewdirs, pixels, bkgd, hit_args)
        loss.backward()
        loss = loss.detach()
        mse = ((rgb.detach() - pixels) ** 2).mean()
        if self._dp:
            loss, mse = allreduce_grads(
                _leaves(self.sg_params), 1.0 / self.world,
                torch.stack([loss, mse]) / self.world)
            n_hits = psum_count(n_hits)
        self.optimizer.step()
        self.scheduler.step()
        return loss, n_hits, mse

    def _hit_args(self, item):
        """(batch, device hit_args) of one prefetcher item; a packed
        stream is sliced to the bucket of its true hit count."""
        if self._packed:
            batch, slots, tri, ts, total = item
            b = snap_pack_cap(total, self.pack_cap)
            return batch, (
                self._to_device(slots[:b], np.int32),
                self._to_device(tri[:b], np.int32),
                self._to_device(ts[:b]),
                min(total, np.iinfo(np.int32).max),
            )
        batch, tri_ids, ts, valid = item
        return batch, (self._to_device(tri_ids, np.int32),
                       self._to_device(ts), self._to_device(valid, bool))

    def train_one_step(self):
        """One step; returns (loss, true hit count, rgb MSE)."""
        cfg = self.cfg
        step = self.step
        if step % self.occ_cfg.update_interval == 0:
            self.occ_state = self._occ_update(step)
        batch, hit_args = self._hit_args(self.prefetcher.next(self.num_rays))
        arrays = [self._to_device(a) for a in (
            batch["rays"].origins, batch["rays"].viewdirs, batch["pixels"])]
        if self._dp:
            arrays = shard_batch(arrays, self.world, self.rank)
        loss, n_hits, mse = self._train_step_impl(
            *arrays, self._to_device(batch["color_bkgd"]), hit_args)
        nh = int(n_hits)
        if nh > 0:
            self.num_rays = bucket_num_rays(
                int(self.num_rays * cfg.target_sample_batch_size / float(nh)),
                max_rays=cfg.max_num_rays)
        self.step += 1
        return loss, nh, mse

    @torch.no_grad()
    def render_view(self, data, chunk: int = 4096) -> torch.Tensor:
        """The SG model's render of a full view on white, dense rows in
        chunks of `chunk` rays; rgb [n, 3] on the trainer's device."""
        origins = np.asarray(data["rays"].origins, np.float32)
        viewdirs = np.asarray(data["rays"].viewdirs, np.float32)
        n = origins.shape[0]
        n_pad = (n + chunk - 1) // chunk * chunk
        o = np.concatenate([origins, np.zeros((n_pad - n, 3), np.float32)])
        d = np.concatenate(
            [viewdirs, np.tile([[0, 0, 1.0]], (n_pad - n, 1))]
        ).astype(np.float32)
        outs = []
        for i in range(0, n_pad, chunk):
            oc, dc = o[i:i + chunk], d[i:i + chunk]
            tri_ids, ts, valid = self.mesh_intersect.intersect_rows(oc, dc)
            rgb, _, _, _ = render_fit_sg_rows(
                self.sg_params, self.teacher_params,
                HitRows(tri_ids=self._to_device(tri_ids, np.int32),
                        ts=self._to_device(ts),
                        valid=self._to_device(valid, bool)),
                self._to_device(oc), self._to_device(dc), self.aabb,
                self.sg_cfg, self.teacher_cfg, ngp_forward_fn=_ngp_rgb_sigma,
                render_step_size=self.cfg.eff_render_step_size,
                bg_color="white")
            outs.append(rgb)
        return torch.cat(outs)[:n]

    def train(self, log_fn=print):
        """Steps 0..max_steps with logging and checkpoints, then the
        final checkpoint (ckpts/SCENE/EXP/fit_sg.pt); stops the
        prefetcher at the end. Over ranks, rank 0 alone logs and
        writes."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.root, "results", cfg.scene, cfg.exp_name)
        ckpt_dir = os.path.join(cfg.root, "ckpts", cfg.scene, cfg.exp_name)
        ckpt = os.path.join(ckpt_dir, "fit_sg.pt")
        if self.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            os.makedirs(ckpt_dir, exist_ok=True)
        tic = time.time()
        try:
            while self.step <= cfg.max_steps:
                step = self.step
                loss, nh, mse = self.train_one_step()
                if step % cfg.log_every == 0 and self.rank == 0:
                    log_fn(
                        f"elapsed={time.time() - tic:.1f}s | step={step} | "
                        f"loss={float(loss):.5f} | "
                        f"psnr={-10.0 * float(torch.log10(mse)):.2f} | "
                        f"hits={nh} | num_rays={self.num_rays}"
                    )
                if step > 0 and step % cfg.ckpt_every == 0:
                    on_rank0(self._dp, self.save, ckpt)
            on_rank0(self._dp, self.save, ckpt)
        finally:
            self.prefetcher.stop()

    def save(self, path: str):
        """The SG model (under "radiance_field", as the JAX trainer
        saves it), the occupancy grid, Adam's state and the step."""
        save_checkpoint(path, {
            "radiance_field": self.sg_params,
            "occs": self.occ_state.occs,
            "binaries": self.occ_state.binaries,
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        })

    def load(self, path: str):
        state = load_checkpoint(path, map_location=self.device)
        self.step = int(state["step"])
        self.sg_params = _as_leaf_params(state["radiance_field"])
        self._make_optimizer()
        if "opt_state" in state:  # a converted checkpoint has none
            self.optimizer.load_state_dict(state["opt_state"])
        self.occ_state = OccGridState(
            occs=state["occs"], binaries=state["binaries"], aabb=self.aabb)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()
