"""Stage 2: distill the frozen NGP's rendering weights into a quadrature
field.

Port of quadraturefields_tpu/train/stage2_field.py (reference
examples/train_field.py) on one device or, with num_devices > 1, over
torch.distributed ranks (parallel/dp.py). A step:
  1. renders the ray batch with the frozen NGP, no grad, keeping each
     sample's forward AND reverse weight (render_rays_field);
  2. maps the sample positions to the NGP's [0, 1]^3, shifted by -0.5
     into the field's domain (train_field.py:342-344);
  3. takes the field and its spatial gradient (field_with_grad,
     differentiable in the field's parameters);
  4. loss = mean | max(w, w_rev) - |grad f . dir| | over the valid
     samples (field.py:253-259), backward (the field table's gradient is
     the fused kernel K1 on the card), Adam at lr 2e-2 with the
     reference schedule.
Every 16 steps the occupancy grid is refreshed from the frozen NGP
first, and the ray batch is resized every step to hold the sample count
near its budget. At the end: the supersampled field / |grad| / density
grid export, the occupancy binaries and a checkpoint
(train_field.py:396-419).

The NGP comes from the port's own stage-1 checkpoint
(`Stage1Trainer.save`: params, occs, binaries) or is handed in; orbax
checkpoints of the JAX package are not read.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.nerf_synthetic import SubjectLoader
from ..models.field import (
    FieldConfig,
    _detached,
    field_init,
    field_loss,
    field_with_grad,
)
from ..models.ngp import NGPConfig, ngp_normalize, ngp_query_density
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
    on_rank0,
    rank_device,
    shard_batch,
    world_and_rank,
)
from ..render.renderer import RenderConfig, render_rays_field
from ..utils.batching import bucket_num_rays
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.grid_export import (
    extract_density_grid,
    extract_field_grid,
    extract_field_grid_h5,
)
from ..utils.optim import make_ngp_optimizer
from .stage1_ngp import MIPNERF360_UNBOUNDED_SCENES, _as_leaf_params, _leaves


@dataclasses.dataclass
class Stage2Config:
    """The JAX trainer's config, field for field. `num_devices` > 1
    trains over that many torch.distributed ranks (parallel/dp.py)."""

    scene: str = "lego"
    data_root: str = "data/nerf_synthetic"
    exp_name: str = "field"
    root: str = "runs/"
    ckpt_path: str = ""  # the stage-1 checkpoint (the NGP)
    train_split: str = "train"
    max_steps: int = 25000
    init_batch_size: int = 1024
    batch_size_log2: int = 18
    occ_thres: float = 0.01
    num_lobes: int = 2  # must match the stage-1 model
    num_layers: int = 2
    log2_hashmap_size: int = 19  # the stage-1 NGP table
    n_levels: int = 16
    n_features: int = 2
    interp: str = "tet"
    grad_mode: str = "auto"
    layout: str = "corner"  # must match the stage-1 checkpoint
    grad_payload: str = "f32"
    field_log2_hashmap_size: int = 30  # the field table (run script value)
    field_scale: float = 0.5
    field_max_res: int = 512
    field_min_res: int = 16
    field_hidden_size: int = 16
    scale: float = 1.5
    lr: float = 2e-2
    grid_resolution: int = 128
    render_step_size: float = 5e-3
    alpha_thre: float = 0.0
    grid_export_size: int = 1024
    ckpt_every: int = 1000
    log_every: int = 100
    seed: int = 42
    coarse_factor: int = 4
    coarse_stride: int = -1
    max_num_rays: int = 1 << 20
    export_grids: bool = True
    plot_every: int = 0  # field slice plots every N steps (0: none)
    scene_type: str = "auto"  # "auto" | "synthetic" | "360"
    data_factor: int = 4
    num_devices: int = 0

    @property
    def is_unbounded(self) -> bool:
        if self.scene_type == "auto":
            return self.scene in MIPNERF360_UNBOUNDED_SCENES
        return self.scene_type == "360"

    @property
    def target_sample_batch_size(self) -> int:
        return 1 << self.batch_size_log2

    @property
    def aabb(self) -> np.ndarray:
        if self.is_unbounded:
            # the contraction's ROI box (reference train_field.py:159)
            return np.array([-1, -1, -1, 1, 1, 1], np.float32)
        return np.array([-1, -1, -1, 1, 1, 1], np.float32) * self.scale

    # the per-scene-type render knobs (reference train_field.py:151-196);
    # the 360 far plane is capped at 1e2 as in stage 1
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
        return 1e-2 if self.is_unbounded else self.alpha_thre

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
        # shipped values: scale 0.5, log2_T 30, L 16, max_res 512,
        # min_res 16, hidden 16, back_prop False (train_field.py:238-252)
        return FieldConfig(
            scale=self.field_scale,
            back_prop=False,
            log2_hashmap_size=self.field_log2_hashmap_size,
            n_levels=16,
            max_resolution=self.field_max_res,
            min_resolution=self.field_min_res,
            output_dim=1,
            hidden_size=self.field_hidden_size,
            nl="elu",
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
        stride, dil = resolve_coarse_stride(
            self.coarse_stride, self.aabb, self.grid_resolution,
            self.coarse_factor, self.eff_render_step_size,
        )
        return RenderConfig(
            render_step_size=self.eff_render_step_size,
            near_plane=self.eff_near_plane,
            far_plane=self.eff_far_plane,
            cone_angle=self.eff_cone_angle,
            alpha_thre=self.eff_alpha_thre,
            early_stop_eps=1e-4,  # more supervised points (utils.py:432)
            max_steps=max_steps,
            max_samples_total=self.target_sample_batch_size,
            coarse_factor=0 if self.is_unbounded else self.coarse_factor,
            coarse_stride=stride,
            coarse_dilation=dil,
        )


class Stage2Trainer:
    """The stage-2 trainer on one device, or with cfg.num_devices > 1 on
    each rank of a torch.distributed group of that size (each rank
    steps on its slice of the global batch, parallel/dp.py; rank 0 alone
    exports and saves; a device "cuda" without an index is
    cuda:LOCAL_RANK). `field_params` is the field's tree of leaf tensors
    that require grad; assigning it and calling `_make_optimizer` carries
    other weights across (utils/convert.py)."""

    def __init__(self, cfg: Stage2Config, ngp_params=None,
                 occ_state: Optional[OccGridState] = None,
                 train_dataset=None, device="cuda"):
        self._dp = bool(cfg.num_devices and cfg.num_devices > 1)
        if self._dp:
            self.world, self.rank = world_and_rank(cfg.num_devices)
            device = rank_device(device)
        else:
            self.world, self.rank = 1, 0
        # full-f32 matmuls: the field's f32 decoder gradient feeds the
        # loss, and the NGP's bf16-operand MLP keeps f32 products
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
        self.ngp_params = _detached(ngp_params)  # frozen
        self.occ_state = occ_state or occ_grid_init(self.aabb, self.occ_cfg,
                                                    self.device)

        # one generator for the field init, then the occupancy and march
        # jitter
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(cfg.seed)
        self.field_params = _as_leaf_params(
            field_init(self.generator, self.field_cfg, self.device))
        if train_dataset is not None:
            self.train_dataset = train_dataset
        elif cfg.is_unbounded:
            from ..data.nerf_360_v2 import SubjectLoader as Loader360

            self.train_dataset = Loader360(
                subject_id=cfg.scene, root_fp=cfg.data_root,
                split=cfg.train_split, num_rays=cfg.init_batch_size,
                color_bkgd_aug="random", factor=cfg.data_factor,
                seed=cfg.seed,
            )
        else:
            self.train_dataset = SubjectLoader(
                subject_id=cfg.scene, root_fp=cfg.data_root,
                split=cfg.train_split, num_rays=cfg.init_batch_size,
                seed=cfg.seed,
            )
        # reference train_field.py:157/177: weight decay 0 (360), 1e-5
        # (materials, ficus, drums), else 1e-6
        if cfg.is_unbounded:
            self.weight_decay = 0.0
        elif cfg.scene in ("materials", "ficus", "drums"):
            self.weight_decay = 1e-5
        else:
            self.weight_decay = 1e-6
        self.step = 0
        self._make_optimizer()
        if self._dp:
            broadcast_params(_leaves(self.field_params))

    def _make_optimizer(self):
        """A fresh Adam over self.field_params, its schedule continuing
        from self.step."""
        self.optimizer, self.scheduler = make_ngp_optimizer(
            _leaves(self.field_params), self.cfg.max_steps, lr=self.cfg.lr,
            weight_decay=self.weight_decay, start_step=self.step)

    def _occ_update(self, step: int) -> OccGridState:
        """The occupancy refresh from the frozen NGP (density times the
        step size), its jitter drawn from the trainer's generator; over
        ranks each evaluates its slice of the points and every rank gets
        the same state."""
        def occ_eval_fn(x):
            d = ngp_query_density(self.ngp_params, x, self.aabb,
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

    def _loss_fn(self, field_params, origins, viewdirs, pixels, bkgd,
                 t_jitter, rcfg=None):
        """(loss, aux) of one batch; t_jitter [n_rays] are the
        stratified march's uniforms, rcfg the render config (the
        trainer's unless given: a rank's share of the sample budget).
        The render takes no grad. aux's num_valid is the samples the
        rays asked for, kept those within the budget."""
        with torch.no_grad():
            res = render_rays_field(
                self.ngp_params, self.aabb, self.ngp_cfg, self.occ_state,
                origins, viewdirs, rcfg or self.rcfg, render_bkgd=bkgd,
                stratified=True, t_jitter=t_jitter,
            )
            _, pos01 = ngp_normalize(res.positions, self.aabb, self.ngp_cfg)
            positions = pos01 - 0.5
        _, fgrad = field_with_grad(field_params, positions, self.field_cfg)
        loss = field_loss(res.weights, res.weights_rev, fgrad, res.dirs,
                          mask=res.valid)
        aux = {"num_valid": res.num_valid, "kept": res.valid.sum(),
               "mse": ((res.rgb - pixels) ** 2).mean()}
        return loss, aux

    def _train_step_impl(self, origins, viewdirs, pixels, bkgd, t_jitter):
        """Loss, backward and one Adam update (the schedule steps after
        it); returns (loss, aux). Over ranks the rank steps on its slice
        of the global batch (t_jitter drawn at the global shape) with
        its share of the budget. field_loss is a mean over the rank's
        valid samples, so the ranks' losses and gradients combine
        weighted by their kept counts, n_rank / max(n_total, 1), which
        makes the sum the global masked mean (JAX dp.py:263-270); the
        rgb MSE is averaged, and num_valid becomes n_total, the samples
        kept summed over the ranks, as JAX's DP step returns it (one
        device returns the rays' demand, which exceeds it where a rank
        truncates)."""
        self.optimizer.zero_grad(set_to_none=True)
        rcfg = self.rcfg
        if self._dp:
            origins, viewdirs, pixels, t_jitter = shard_batch(
                (origins, viewdirs, pixels, t_jitter), self.world, self.rank)
            rcfg = local_rcfg(rcfg, self.world)
        loss, aux = self._loss_fn(self.field_params, origins, viewdirs,
                                  pixels, bkgd, t_jitter, rcfg)
        # the parameters' gradients only: with back_prop the graph reaches
        # the sample positions too, whose gradient nothing reads
        loss.backward(inputs=_leaves(self.field_params))
        # the loss sees the field's gradient only, so the decoder's output
        # bias gets none; a zero gradient lets Adam's weight decay move
        # it as optax's chain does in JAX
        for p in _leaves(self.field_params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if self._dp:
            n_total = psum_count(aux["kept"])
            w = (aux["kept"].to(torch.float32)
                 / n_total.to(torch.float32).clamp_min(1.0))
            loss, mse = allreduce_grads(
                _leaves(self.field_params), w,
                torch.stack([loss * w, aux["mse"] / self.world]))
            aux = {"num_valid": n_total, "kept": n_total, "mse": mse}
        self.optimizer.step()
        self.scheduler.step()
        return loss, aux

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train_one_step(self):
        """One step; returns (loss, valid samples, the rgb MSE of the
        frozen NGP's render). Over ranks the valid samples are those
        kept, summed over the ranks (_train_step_impl)."""
        cfg = self.cfg
        if self.step % self.occ_cfg.update_interval == 0:
            self.occ_state = self._occ_update(self.step)
        data = self.train_dataset.fetch_train_batch()
        origins = self._to_device(data["rays"].origins)
        viewdirs = self._to_device(data["rays"].viewdirs)
        pixels = self._to_device(data["pixels"])
        bkgd = self._to_device(data["color_bkgd"])
        # drawn at the global batch's shape on every rank, so that the
        # ranks' generators stay in one state
        t_jitter = torch.rand((origins.shape[0],), generator=self.generator,
                              device=self.device)
        loss, aux = self._train_step_impl(origins, viewdirs, pixels, bkgd,
                                          t_jitter)
        nv = int(aux["num_valid"])
        if cfg.target_sample_batch_size > 0 and nv > 0:
            num_rays = int(self.train_dataset.num_rays
                           * cfg.target_sample_batch_size / float(nv))
            self.train_dataset.update_num_rays(
                bucket_num_rays(num_rays, max_rays=cfg.max_num_rays))
        self.step += 1
        return loss, nv, aux["mse"]

    def field_with_grad_fn(self):
        """(coords [M, 3]) -> (field [M], |grad| [M]), for the grid
        export and the plots."""
        def fn(coords):
            f, g = field_with_grad(self.field_params, coords, self.field_cfg,
                                   create_graph=False)
            return f[:, 0], torch.linalg.vector_norm(g, dim=-1)

        return fn

    def export_artifacts(self, out_dir: str):
        """binaries.npy [1, R, R, R] and, with export_grids, the field /
        |grad| grids (an h5 file for 360 scenes) and the NGP's density
        grid, at grid_export_size^3."""
        cfg = self.cfg
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "binaries.npy"),
                self.occ_state.binaries.cpu().numpy()[None])
        if not cfg.export_grids:
            return
        if cfg.is_unbounded:
            # the field's domain is the contracted cube either way
            extract_field_grid_h5(
                self.field_with_grad_fn(),
                os.path.join(out_dir, "grids_valid.h5"),
                scale=cfg.field_scale, grid_size=cfg.grid_export_size,
                device=self.device,
            )
        else:
            extract_field_grid(
                self.field_with_grad_fn(), out_dir, scale=cfg.field_scale,
                grid_size=cfg.grid_export_size, device=self.device,
            )
        extract_density_grid(
            lambda x: ngp_query_density(self.ngp_params, x, self.aabb,
                                        self.ngp_cfg)[:, 0],
            out_dir, scale=cfg.scale, grid_size=cfg.grid_export_size,
            device=self.device,
        )

    def train(self, log_fn=print):
        """Steps 0..max_steps with logging, plots and checkpoints, then
        the artifacts under root/results/<scene>/<exp_name> and the
        checkpoint root/ckpts/<scene>/<exp_name>/field.pt. Over ranks,
        rank 0 alone logs, plots, exports and saves."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.root, "results", cfg.scene, cfg.exp_name)
        ckpt_dir = os.path.join(cfg.root, "ckpts", cfg.scene, cfg.exp_name)
        writer = self.rank == 0
        if writer:
            os.makedirs(out_dir, exist_ok=True)
            os.makedirs(ckpt_dir, exist_ok=True)
        tic = time.time()
        rays_done = 0
        while self.step <= cfg.max_steps:
            step = self.step
            rays_done += self.train_dataset.num_rays
            loss, nv, mse = self.train_one_step()
            if cfg.plot_every and step % cfg.plot_every == 0:
                from ..utils.field_plots import plot_field

                on_rank0(self._dp, lambda: plot_field(
                    self.field_with_grad_fn(), out_dir,
                    scale=cfg.field_scale, grid_size=256, step=step,
                    device=self.device))
            if step % cfg.log_every == 0 and writer:
                elapsed = time.time() - tic
                log_fn(
                    f"elapsed={elapsed:.1f}s | step={step} | "
                    f"floss={float(loss):.5f} | "
                    f"psnr={-10.0 * float(torch.log10(mse)):.2f} | "
                    f"n_samples={nv} | "
                    f"num_rays={self.train_dataset.num_rays} | "
                    f"rays/s={rays_done / max(elapsed, 1e-9):.0f}"
                )
            if step > 0 and step % cfg.ckpt_every == 0:
                on_rank0(self._dp, self.save,
                         os.path.join(ckpt_dir, "field.pt"))
        on_rank0(self._dp, self.export_artifacts, out_dir)
        on_rank0(self._dp, self.save, os.path.join(ckpt_dir, "field.pt"))

    def save(self, path: str):
        """Field weights, occupancy grid, Adam state and step, as the
        JAX trainer's save."""
        save_checkpoint(path, {
            "field_params": self.field_params,
            "occs": self.occ_state.occs,
            "binaries": self.occ_state.binaries,
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        })

    def load(self, path: str):
        state = load_checkpoint(path, map_location=self.device)
        self.step = int(state["step"])
        self.field_params = _as_leaf_params(state["field_params"])
        self._make_optimizer()
        if "opt_state" in state:  # a converted checkpoint has none
            self.optimizer.load_state_dict(state["opt_state"])
        self.occ_state = OccGridState(
            occs=state["occs"], binaries=state["binaries"], aabb=self.aabb)
