"""Stage 4: joint finetune of the radiance field and the mesh-deformation
field, rendering at ray-mesh quadrature points.

Port of quadraturefields_tpu/train/stage4_finetune.py (reference
examples/train_finetune.py) on one device or, with num_devices > 1,
over torch.distributed ranks (parallel/dp.py). A step:
  1. takes the next batch from the host BVH prefetcher: a packed hit
     stream (slots, triangles, depths; 12 B a hit), sliced to the √2
     bucket of its true hit count (pack_slack > 0, the default), or
     dense [R, max_hits] rows and their triangles' vertices
     (pack_slack 0), whose triangles' vertices are gathered on the
     device from the resident face table;
  2. renders it with the deformed quadrature (render/quadrature.py) and
     the volumetric twin (the stratified occupancy-grid march of stage
     1), and takes the dual smooth-L1 loss (train_finetune.py:525-528)
     plus the deformation regularizer;
  3. backpropagates (the field table's gradient is K1 on the card, as
     is the NGP's on joint steps), steps one Adam over the rf and field
     leaves, and scatter-adds each hit's weighted deformation into its
     face.
The radiance field is frozen for the first `freeze_rf_steps` steps
(train_finetune.py:487-492): its forwards run without a graph and its
leaves get zero gradients, so Adam's step count advances for them as
optax's one shared count does. Every `mesh_update_every` steps the
accumulated deformation moves the vertices, the BVH is refit and
mesh.ply exported (train_finetune.py:708-724).

The step takes its noise as arguments (the twin's stratified jitter
and the barycentric uniforms at the dense [R, H, 3] shape);
train_one_step draws them from the trainer's generator. The NGP comes
from the port's own stage-1 checkpoint (`Stage1Trainer.save`) or is
handed in; orbax checkpoints of the JAX package are not read.

Data parallelism (JAX's make_dp_finetune_train_step): every rank holds
the fields, the caches and the mesh whole, draws the same global batch
(its prefetcher follows the step, geometry/intersect.py) and casts only
its slice of the rays, packed to its share of the hit budget. The
jitter and the barycentric uniforms are drawn at the global shape from
the generator and sliced, so a DP run's draws equal the single device's
(JAX folds the twin's stratified key per rank). A rank's loss is its
slice's: the ray means and, weighted by its share of the rendered hits,
the regularizer, so that their mean over the ranks (pmean) is the
single device's loss; JAX pmeans each rank's hit mean of the
regularizer, which differs where the ranks' hit counts do. Each rank
scatters its hits' deformation into zero per-face buffers; one
all-reduce a step sums them with the gradients (allreduce_grads), and
one before the forward sums the hit counts. Every rank runs Adam and
the mesh update on the same sums; rank 0 alone evaluates and writes.
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
from ..geometry.meshio import Mesh, save_ply
from ..models.field import FieldConfig, field_apply, field_init
from ..models.ngp import NGPConfig, ngp_forward, ngp_query_density
from ..ops.grid import (
    OccGridConfig,
    OccGridState,
    max_march_steps,
    max_march_steps_cone,
    occ_grid_init,
    occ_grid_update,
    resolve_coarse_stride,
)
from ..parallel.dp import (
    allreduce_grads,
    broadcast_params,
    local_rcfg,
    make_dp_occ_eval,
    psum_count,
)
from ..parallel.multihost import (
    broadcast_object,
    on_rank0,
    rank_device,
    shard_batch,
    world_and_rank,
)
from ..render.quadrature import (
    HitRows,
    mesh_accumulate_deformation,
    mesh_update_vertices,
    packed_hits_from_host,
    render_finetune_packed_stream,
    render_finetune_rows,
)
from ..render.renderer import RenderConfig, render_rays_occgrid
from ..utils.batching import bucket_num_rays, snap_pack_cap
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import lpips_metric, psnr, smooth_l1_loss, ssim
from ..utils.optim import make_ngp_optimizer
from .stage1_ngp import MIPNERF360_UNBOUNDED_SCENES, _as_leaf_params, _leaves


@dataclasses.dataclass
class Stage4Config:
    """The JAX trainer's config, field for field. `num_devices` > 1
    trains over that many torch.distributed ranks (parallel/dp.py)."""

    scene: str = "lego"
    data_root: str = "data/nerf_synthetic"
    exp_name: str = "finetune"
    root: str = "runs/"
    ckpt_path: str = ""     # the stage-1 checkpoint (the NGP)
    mesh_path: str = ""     # smp_mesh.ply from stage 3
    max_steps: int = 10000
    init_batch_size: int = 1024
    batch_size_log2: int = 17
    occ_thres: float = 0.01
    scaling: float = 0.0434          # deformation clip (run script)
    up_sample: int = 2
    voxel_size: float = 150.0
    max_hits: int = 25
    num_lobes: int = 0               # plain NGP head in the shipped recipe
    num_layers: int = 2
    log2_hashmap_size: int = 19
    n_levels: int = 16
    n_features: int = 2
    interp: str = "tet"
    grad_mode: str = "auto"
    layout: str = "corner"    # must match the stage-1 checkpoint
    grad_payload: str = "f32"
    scale: float = 1.5
    lr: float = 2e-2
    freeze_rf_steps: int = 300
    mesh_update_every: int = 2000
    grid_resolution: int = 128
    coarse_factor: int = 4   # the volumetric twin's two-level march
    render_step_size: float = 5e-3
    ckpt_every: int = 1000
    log_every: int = 100
    seed: int = 42
    eval_views: Optional[int] = None
    # smp_mesh.ply arrives decimated from stage 3; the reference passes
    # simplify_mesh=False here (train_finetune.py:242)
    simplify_mesh: bool = False
    # the dynamic ray batch's cap (few mesh hits early make target/nh
    # large)
    max_num_rays: int = 1 << 18
    # the packed hit stream's budget, a multiple of the sample target;
    # 0 takes the dense rows
    pack_slack: float = 1.25
    num_devices: int = 0
    # the deformation field's capacity (reference values: 24 / 512,
    # train_finetune.py:387-399)
    field_log2_hashmap_size: int = 24
    field_max_res: int = 512
    # unbounded/360: "auto" switches on MIPNERF360_UNBOUNDED_SCENES
    # (reference train_finetune.py:248-282); "360"/"synthetic" force it
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
            # reference train_finetune.py:257 (contraction ROI box)
            return np.array([-1, -1, -1, 1, 1, 1], np.float32)
        return np.array([-1, -1, -1, 1, 1, 1], np.float32) * self.scale

    # per-scene-type render knobs (reference train_finetune.py:248-282);
    # far_plane capped at 1e2 as in stages 1-2
    @property
    def eff_render_step_size(self) -> float:
        return 1e-3 if self.is_unbounded else self.render_step_size

    @property
    def eff_near_plane(self) -> float:
        return 0.2 if self.is_unbounded else 0.0

    @property
    def eff_far_plane(self) -> float:
        return 1e2 if self.is_unbounded else 1e10

    @property
    def eff_alpha_thre(self) -> float:
        return 1e-2 if self.is_unbounded else 0.0

    @property
    def eff_cone_angle(self) -> float:
        return 0.004 if self.is_unbounded else 0.0

    def ngp_config(self) -> NGPConfig:
        return NGPConfig(
            head="sg" if self.num_lobes > 0 else "mlp",
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

    def field_config(self) -> FieldConfig:
        # deformation field: log2_T 24, L16, max_res 512 x scale, hidden
        # 32, relu, output_dim 1 (reference train_finetune.py:387-399)
        return FieldConfig(
            scale=self.scale,
            back_prop=False,
            log2_hashmap_size=self.field_log2_hashmap_size,
            n_levels=16,
            max_resolution=self.field_max_res,
            min_resolution=16,
            output_dim=1,
            hidden_size=32,
            nl="relu",
            interp=self.interp,
            grad_mode=self.grad_mode,
            layout=self.layout,
            grad_payload=self.grad_payload,
        )

    def render_config(self) -> RenderConfig:
        if self.is_unbounded:
            max_steps = max_march_steps_cone(
                self.eff_near_plane, self.eff_far_plane,
                self.eff_render_step_size, self.eff_cone_angle,
            )
        else:
            max_steps = max_march_steps(self.aabb, self.eff_render_step_size)
        # the volumetric twin's two-level march, configured as stage 1's
        stride, dil = resolve_coarse_stride(
            -1, self.aabb, self.grid_resolution,
            self.coarse_factor, self.eff_render_step_size,
        )
        return RenderConfig(
            render_step_size=self.eff_render_step_size,
            near_plane=self.eff_near_plane,
            far_plane=self.eff_far_plane,
            cone_angle=self.eff_cone_angle,
            alpha_thre=self.eff_alpha_thre,
            max_steps=max_steps,
            max_samples_total=self.target_sample_batch_size,
            coarse_factor=0 if self.is_unbounded else self.coarse_factor,
            coarse_stride=stride,
            coarse_dilation=dil,
        )


def _ngp_rgb_sigma(p, x, d, a, c):
    rgb, density = ngp_forward(p, x, d, a, c)
    return rgb, density[..., 0]


class Stage4Trainer:
    """The stage-4 trainer on one device, or with cfg.num_devices > 1 on
    each rank of a torch.distributed group of that size (a device "cuda"
    without an index is then cuda:LOCAL_RANK). `params` is {"rf": the
    NGP's leaves, "field": the deformation field's}; after assigning it
    (e.g. weights carried across with utils/convert.py) call
    `_make_optimizer`."""

    def __init__(self, cfg: Stage4Config, ngp_params=None,
                 occ_state: Optional[OccGridState] = None,
                 mesh: Optional[Mesh] = None, train_dataset=None,
                 test_dataset=None, device="cuda"):
        self._dp = bool(cfg.num_devices and cfg.num_devices > 1)
        if self._dp:
            self.world, self.rank = world_and_rank(cfg.num_devices)
            device = rank_device(device)
        else:
            self.world, self.rank = 1, 0
        # full-f32 matmuls: the NGP's bf16-operand MLP keeps f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.ngp_cfg = cfg.ngp_config()
        self.field_cfg = cfg.field_config()
        self.rcfg = cfg.render_config()
        self.occ_cfg = OccGridConfig(
            resolution=cfg.grid_resolution, occ_thre=cfg.occ_thres
        )
        self.aabb = torch.as_tensor(cfg.aabb, device=self.device)

        if ngp_params is None:
            if not cfg.ckpt_path:
                raise ValueError("need ngp_params or ckpt_path")
            ckpt = load_checkpoint(cfg.ckpt_path, map_location=self.device)
            ngp_params = ckpt["params"]
            occ_state = OccGridState(
                occs=ckpt["occs"].to(torch.float32),
                binaries=ckpt["binaries"].to(torch.bool),
                aabb=self.aabb,
            )
        self.occ_state = occ_state or occ_grid_init(self.aabb, self.occ_cfg,
                                                    self.device)

        self.mesh_intersect = MeshIntersection(
            mesh_path=cfg.mesh_path or None,
            mesh=mesh,
            simplify_mesh=cfg.simplify_mesh,
            scale=cfg.scale,
            voxel_size=cfg.voxel_size,
            num_intersections=cfg.max_hits,
            render_step_size=cfg.eff_render_step_size,
        )
        n_faces = self.mesh_intersect.n_faces
        self.cache_d = torch.zeros((n_faces, 3), device=self.device)
        self.cache_w = torch.full((n_faces,), 1e-8, device=self.device)
        self._packed = cfg.pack_slack > 0
        # a rank's share of the packed-hit budget (JAX's shard cap)
        self.pack_cap = -(-cfg.pack_cap // self.world // 256) * 256
        self.face_verts_dev = self._face_verts_table()

        # one generator for the field init, then every step's noise
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(cfg.seed)
        self.params = {
            "rf": _as_leaf_params(ngp_params),
            "field": _as_leaf_params(field_init(
                self.generator, self.field_cfg, self.device)),
        }
        self.step = 0
        self._make_optimizer()
        if self._dp:
            broadcast_params(_leaves(self.params))

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
        self.test_dataset = test_dataset
        # the ray batch the dynamic batch asks for next
        self.num_rays = int(self.train_dataset.num_rays)
        # the worker thread casts rays with numpy and the C++ BVH only;
        # every upload happens on this thread
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
        """One Adam over the rf and field leaves (eps 1e-15, no weight
        decay) on the reference schedule with a 1000-step warm-up and
        the reference's milestones (max/4, max*2, max*6/10), continuing
        from self.step."""
        m = self.cfg.max_steps
        self.optimizer, self.scheduler = make_ngp_optimizer(
            _leaves(self.params), m, lr=self.cfg.lr, weight_decay=0.0,
            warmup_iters=1000, start_step=self.step,
            milestones=[m // 4, m * 2, m * 6 // 10])

    def _face_verts_table(self) -> torch.Tensor:
        return torch.as_tensor(self.mesh_intersect.face_vertices_table(),
                               dtype=torch.float32, device=self.device)

    def _face_rows(self, tri_ids: torch.Tensor) -> torch.Tensor:
        """[..., 3, 3] vertices of dense rows' hit triangles (a -1 pad
        reads face 0), gathered from the face table on the device."""
        return self.face_verts_dev[tri_ids.clamp_min(0).to(torch.int64)]

    def _to_device(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _occ_update(self, step: int) -> OccGridState:
        def occ_eval_fn(x):
            d = ngp_query_density(self.params["rf"], x, self.aabb,
                                  self.ngp_cfg)
            return d[..., 0] * self.cfg.eff_render_step_size

        if self._dp:
            occ_eval_fn = make_dp_occ_eval(occ_eval_fn)
        with torch.no_grad():
            return occ_grid_update(
                self.occ_state, step, occ_eval_fn, self.occ_cfg,
                contract_aabb=self.aabb if self.cfg.is_unbounded else None,
                generator=self.generator,
            )

    def _loss_fn(self, params, origins, viewdirs, pixels, bkgd, hit_args,
                 t_jitter, bary_uniforms, freeze_rf: bool, rcfg=None,
                 reg_weight=1.0):
        """(loss, aux) of one batch. hit_args: packed -> (slots, tri, ts,
        num_valid, face_verts_table); dense -> (tri_ids, ts, valid,
        face_vertices [R, H, 3, 3]). t_jitter [R] are the twin's
        stratified uniforms, bary_uniforms [R, H, 3] the barycentric
        ones; rcfg the twin's render config (the trainer's unless given:
        a rank's share of the budget), reg_weight the regularizer's
        factor (a rank's share of the hits)."""
        cfg = self.cfg
        render_kwargs = dict(
            ngp_forward_fn=_ngp_rgb_sigma,
            field_apply_fn=field_apply,
            scaling=cfg.scaling,
            render_step_size=cfg.eff_render_step_size,
            bg_color="random",
            render_bkgd=bkgd,
            bary_uniforms=bary_uniforms,
            stop_gradient_rf=freeze_rf,
        )
        n_rays = origins.shape[0]
        if self._packed:
            slots, tri, ts, num_valid, face_verts = hit_args
            ph = packed_hits_from_host(slots, tri, ts, num_valid,
                                       n_rays=n_rays, max_hits=cfg.max_hits)
            out = render_finetune_packed_stream(
                params["rf"], params["field"], ph, n_rays, cfg.max_hits,
                origins, viewdirs, face_verts, self.aabb, self.ngp_cfg,
                self.field_cfg, **render_kwargs,
            )
        else:
            tri_ids, ts, valid, face_vertices = hit_args
            out = render_finetune_rows(
                params["rf"], params["field"],
                HitRows(tri_ids=tri_ids, ts=ts, valid=valid), origins,
                viewdirs, face_vertices, self.aabb, self.ngp_cfg,
                self.field_cfg, **render_kwargs,
            )
        # the volumetric twin; frozen, no gradient reaches the rf
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not freeze_rf):
            vol = render_rays_occgrid(
                params["rf"], self.aabb, self.ngp_cfg, self.occ_state,
                origins, viewdirs, rcfg or self.rcfg, render_bkgd=bkgd,
                stratified=True, t_jitter=t_jitter,
            )
        # the quadrature term leaves out rays the cap truncated; the twin
        # is complete per ray
        rgb_discrete = smooth_l1_loss(out["rgb"], pixels,
                                      ray_mask=out.get("ray_mask"))
        rgb_smooth = smooth_l1_loss(vol.rgb, pixels)
        loss = (rgb_discrete + rgb_smooth) / 2.0 + reg_weight * out["reg"]
        return loss, out

    def _hit_counts(self, hit_args, n_rays: int) -> torch.Tensor:
        """[rendered hits, true hit demand] of a batch's hit_args, int64
        on the device."""
        if self._packed:
            slots, _, _, total, _ = hit_args
            rendered = (slots < n_rays * self.cfg.max_hits).sum()
            demand = torch.as_tensor(total, device=slots.device)
        else:
            rendered = demand = hit_args[2].sum()
        return torch.stack([rendered, demand]).to(torch.int64)

    def _train_step_impl(self, origins, viewdirs, pixels, bkgd, hit_args,
                         t_jitter, bary_uniforms, freeze_rf: bool):
        """Loss, backward, one Adam update (the schedule steps after it)
        and the per-face deformation scatter; returns (loss, n_hits,
        rgb MSE). Over ranks every argument is the rank's slice of the
        global batch (train_one_step cuts it), the twin runs at the
        rank's share of the budget, and the loss, MSE, gradients,
        deformation sums and hit counts are those of the global batch."""
        self.optimizer.zero_grad(set_to_none=True)
        rcfg, reg_weight = self.rcfg, 1.0
        if self._dp:
            rcfg = local_rcfg(rcfg, self.world)
            counts = self._hit_counts(hit_args, origins.shape[0])
            totals = psum_count(counts)
            # the pmean of the ranks' losses then holds the regularizer
            # over all the rendered hits, as one device's does
            reg_weight = counts[0] * self.world / totals[0].clamp_min(1)
        loss, out = self._loss_fn(self.params, origins, viewdirs, pixels,
                                  bkgd, hit_args, t_jitter, bary_uniforms,
                                  freeze_rf, rcfg, reg_weight)
        loss.backward()
        loss = loss.detach()
        mse = ((out["rgb"].detach() - pixels) ** 2).mean()
        n_faces = self.mesh_intersect.n_faces
        if self._dp:
            add_d, add_w = mesh_accumulate_deformation(
                torch.zeros_like(self.cache_d), torch.zeros_like(self.cache_w),
                out["dh"], out["weights"], out["tri_ids"], out["valid"],
                n_faces)
            sums = allreduce_grads(
                _leaves(self.params), 1.0 / self.world,
                torch.cat([torch.stack([loss, mse]) / self.world,
                           add_d.reshape(-1), add_w]))
            loss, mse = sums[0], sums[1]
            self.cache_d = self.cache_d + sums[2:2 + 3 * n_faces].view(-1, 3)
            self.cache_w = self.cache_w + sums[2 + 3 * n_faces:]
            n_hits = totals[1]
        else:
            # frozen, the rf gets no gradient: zeros make Adam count the
            # step for it, as optax's one shared count does
            for p in _leaves(self.params):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.cache_d, self.cache_w = mesh_accumulate_deformation(
                self.cache_d, self.cache_w, out["dh"], out["weights"],
                out["tri_ids"], out["valid"], n_faces,
            )
            n_hits = out["n_hits"]
        self.optimizer.step()
        self.scheduler.step()
        return loss, n_hits, mse

    def _hit_args(self, item):
        """(batch, device hit_args) of one prefetcher item; a packed
        stream is sliced to the bucket of its true hit count, dense rows
        get their triangles' vertices from the face table."""
        if self._packed:
            batch, slots, tri, ts, total = item
            b = snap_pack_cap(total, self.pack_cap)
            return batch, (
                self._to_device(slots[:b], np.int32),
                self._to_device(tri[:b], np.int32),
                self._to_device(ts[:b]),
                min(total, np.iinfo(np.int32).max),
                self.face_verts_dev,
            )
        batch, tri_ids, ts, valid = item
        tri_ids = self._to_device(tri_ids, np.int32)
        return batch, (tri_ids, self._to_device(ts),
                       self._to_device(valid, bool), self._face_rows(tri_ids))

    def train_one_step(self):
        """One step; returns (loss, true hit count, rgb MSE of the
        quadrature render)."""
        cfg = self.cfg
        step = self.step
        if step % self.occ_cfg.update_interval == 0:
            self.occ_state = self._occ_update(step)
        batch, hit_args = self._hit_args(self.prefetcher.next(self.num_rays))
        arrays = [self._to_device(a) for a in (
            batch["rays"].origins, batch["rays"].viewdirs, batch["pixels"])]
        bkgd = self._to_device(batch["color_bkgd"])
        n_rays = arrays[0].shape[0]
        # drawn at the global batch's shape on every rank, then sliced:
        # the ranks' generators stay in one state
        t_jitter = torch.rand((n_rays,), generator=self.generator,
                              device=self.device)
        bary = torch.rand((n_rays, cfg.max_hits, 3),
                          generator=self.generator, device=self.device)
        arrays += [t_jitter, bary]
        if self._dp:
            arrays = shard_batch(arrays, self.world, self.rank)
        origins, viewdirs, pixels, t_jitter, bary = arrays
        loss, n_hits, mse = self._train_step_impl(
            origins, viewdirs, pixels, bkgd, hit_args, t_jitter, bary,
            freeze_rf=step < cfg.freeze_rf_steps)
        nh = int(n_hits)
        if nh > 0:
            self.num_rays = bucket_num_rays(
                int(self.num_rays * cfg.target_sample_batch_size / float(nh)),
                max_rays=cfg.max_num_rays)
        self.step += 1
        return loss, nh, mse

    def apply_mesh_update(self, out_dir=None):
        """The vertex update, BVH refit, caches reset and face table
        refresh, and mesh.ply under out_dir when given (over ranks, every
        rank updates its own copy from the same caches, and rank 0 alone
        writes)."""
        new_vertices = mesh_update_vertices(
            self.mesh_intersect.mesh.vertices,
            self.mesh_intersect.mesh.faces,
            self.cache_d, self.cache_w, self.cfg.scaling,
        )
        self.prefetcher.update_vertices(new_vertices.astype(np.float32))
        n_faces = self.mesh_intersect.n_faces
        self.cache_d = torch.zeros((n_faces, 3), device=self.device)
        self.cache_w = torch.full((n_faces,), 1e-8, device=self.device)
        self.face_verts_dev = self._face_verts_table()
        if out_dir:
            on_rank0(self._dp, save_ply, os.path.join(out_dir, "mesh.ply"),
                     self.mesh_intersect.mesh)

    @torch.no_grad()
    def render_view(self, data, chunk: int = 4096) -> torch.Tensor:
        """Quadrature render of a full view on white, dense rows in
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
            tri_ids = self._to_device(tri_ids, np.int32)
            out = render_finetune_rows(
                self.params["rf"], self.params["field"],
                HitRows(tri_ids=tri_ids, ts=self._to_device(ts),
                        valid=self._to_device(valid, bool)),
                self._to_device(oc), self._to_device(dc),
                self._face_rows(tri_ids), self.aabb, self.ngp_cfg,
                self.field_cfg, ngp_forward_fn=_ngp_rgb_sigma,
                field_apply_fn=field_apply, scaling=self.cfg.scaling,
                render_step_size=self.cfg.eff_render_step_size,
                bg_color="white", generator=self.generator,
            )
            outs.append(out["rgb"])
        return torch.cat(outs)[:n]

    def evaluate(self, dataset, n_views=None):
        """PSNR, SSIM and LPIPS (NaN without weights, utils/lpips.py) over
        the first n_views views. The render at up_sample x the resolution
        is box-averaged back (what cv2.INTER_AREA computes for an integer
        factor)."""
        u = self.cfg.up_sample
        n = len(dataset)
        if n_views is not None:
            n = min(n, n_views)
        H, W = dataset.HEIGHT, dataset.WIDTH
        h, w = H // u, W // u
        psnrs, ssims, lpipss = [], [], []
        for i in range(n):
            data = dataset.fetch_eval_view(i)
            rgb = self.render_view(data).reshape(H, W, 3)
            if u != 1:
                rgb = rgb.reshape(h, u, w, u, 3).mean(dim=(1, 3))
            pixels = self._to_device(data["pixels"]).reshape(h, w, 3)
            psnrs.append(float(psnr(rgb, pixels)))
            ssims.append(float(ssim(rgb, pixels)))
            lpipss.append(lpips_metric(rgb, pixels))
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "lpips": float(np.mean(lpipss)),
        }

    def _evaluate_test(self):
        """evaluate() of the test views (over ranks rank 0's, broadcast
        to every rank)."""
        return broadcast_object(on_rank0(
            self._dp, self.evaluate, self.test_dataset, self.cfg.eval_views),
            self._dp)

    def train(self, log_fn=print):
        """Steps 0..max_steps with logging, the before/after evaluations
        around each mesh update and checkpoints, then the final mesh
        update and checkpoint; stops the prefetcher at the end. Over
        ranks, rank 0 alone logs, evaluates and writes."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.root, "results", cfg.scene, cfg.exp_name)
        ckpt_dir = os.path.join(cfg.root, "ckpts", cfg.scene, cfg.exp_name)
        ckpt = os.path.join(ckpt_dir, "finetune.pt")
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
                if step > 0 and step % cfg.mesh_update_every == 0:
                    # the before/after evaluations around the vertex
                    # update (reference train_finetune.py:696-743)
                    results = {}
                    if self.test_dataset is not None:
                        results["before"] = self._evaluate_test()
                    self.apply_mesh_update(out_dir)
                    if self.test_dataset is not None:
                        results["after"] = self._evaluate_test()
                        if self.rank == 0:
                            log_fn(f"step={step} mesh update: {results}")
                            with open(os.path.join(out_dir, "log.txt"),
                                      "a") as f:
                                f.write(f"step: {step}, {results}\n")
                if step > 0 and step % cfg.ckpt_every == 0:
                    on_rank0(self._dp, self.save, ckpt)
            self.apply_mesh_update(out_dir)
            on_rank0(self._dp, self.save, ckpt)
        finally:
            self.prefetcher.stop()

    def save(self, path: str):
        """Both fields, the occupancy grid, Adam's state and the step, as
        the JAX trainer's save."""
        save_checkpoint(path, {
            "radiance_field": self.params["rf"],
            "field_model": self.params["field"],
            "occs": self.occ_state.occs,
            "binaries": self.occ_state.binaries,
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        })

    def load(self, path: str):
        state = load_checkpoint(path, map_location=self.device)
        self.step = int(state["step"])
        self.params = {"rf": _as_leaf_params(state["radiance_field"]),
                       "field": _as_leaf_params(state["field_model"])}
        self._make_optimizer()
        if "opt_state" in state:  # a converted checkpoint has none
            self.optimizer.load_state_dict(state["opt_state"])
        self.occ_state = OccGridState(
            occs=state["occs"], binaries=state["binaries"], aabb=self.aabb)
