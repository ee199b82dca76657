"""Stage 1: the NGP radiance field with an occupancy grid — evaluation.

Port of quadraturefields_tpu/train/stage1_ngp.py: the whole
`Stage1Config`, and the evaluation half of `Stage1Trainer` (construction,
the one-shot and windowed full-view renders, `evaluate`, save/load).
The training step, Adam and the occupancy refresh come next; until then
`params` and `occ_state` are set by the caller (utils/convert.py carries
JAX weights across, `load` reads the port's checkpoints).

Datasets are the JAX package's numpy loaders
(quadraturefields_tpu/data/), used in place: they import no jax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quadraturefields_tpu.data.nerf_synthetic import SubjectLoader

from ..models.ngp import NGPConfig, ngp_init
from ..ops.grid import (
    OccGridConfig,
    OccGridState,
    max_march_steps,
    max_march_steps_cone,
    occ_grid_init,
    resolve_coarse_stride,
)
from ..render.renderer import (
    RenderConfig,
    make_test_renderer,
    render_rays_occgrid,
)
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import lpips_metric, psnr, ssim

# the reference's scene-type switch (examples/utils.py:30-45)
MIPNERF360_UNBOUNDED_SCENES = (
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
)


@dataclasses.dataclass
class Stage1Config:
    """The JAX trainer's config, field for field, so configs carry over.
    `data_sharding`, `num_devices` (data parallelism) and `save_images`
    are not ported yet; the trainer refuses them."""

    scene: str = "lego"
    data_root: str = "data/nerf_synthetic"
    exp_name: str = "ngp"
    root: str = "runs/"
    train_split: str = "train"
    max_steps: int = 20000
    init_batch_size: int = 4096
    batch_size_log2: int = 18
    occ_thres: float = 0.01
    reg_type: str = "occ"
    o_lambda: float = 1e-3
    c_lambda: float = 1e-5
    num_lobes: int = 2
    num_layers: int = 2
    log2_hashmap_size: int = 19
    interp: str = "tet"
    grad_mode: str = "auto"
    layout: str = "corner"
    grad_payload: str = "f32"
    n_levels: int = 16
    n_features: int = 2
    scale: float = 1.5
    lr: float = 1e-2
    weight_decay: Optional[float] = None
    grid_resolution: int = 128
    render_step_size: float = 5e-3
    near_plane: float = 0.0
    alpha_thre: float = 0.0
    eval_chunk: int = 8192
    # "oneshot" renders each chunk at once with a 4x sample budget;
    # "window" uses the memory-bounded alive-ray renderer; "auto" picks
    # "window" when a chunk's worst-case demand exceeds the one-shot
    # budget
    eval_renderer: str = "auto"
    ckpt_every: int = 1000
    log_every: int = 100
    seed: int = 42
    coarse_factor: int = 4
    coarse_stride: int = -1
    max_num_rays: int = 1 << 20
    compute_dtype: str = "bfloat16"
    eval_views: Optional[int] = None
    save_images: bool = False
    data_sharding: object = None
    num_devices: int = 0
    scene_type: str = "auto"
    data_factor: int = 4

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
            return np.array([-1, -1, -1, 1, 1, 1], np.float32)
        return np.array([-1, -1, -1, 1, 1, 1], np.float32) * self.scale

    @property
    def eff_render_step_size(self) -> float:
        return 1e-3 if self.is_unbounded else self.render_step_size

    @property
    def eff_near_plane(self) -> float:
        return 0.2 if self.is_unbounded else self.near_plane

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
            n_levels=self.n_levels,
            n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            compute_dtype=self.compute_dtype,
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
            alpha_thre=self.eff_alpha_thre,
            cone_angle=self.eff_cone_angle,
            max_steps=max_steps,
            max_samples_total=self.target_sample_batch_size,
            coarse_factor=0 if self.is_unbounded else self.coarse_factor,
            coarse_stride=stride,
            coarse_dilation=dil,
        )


class Stage1Trainer:
    """Evaluation half of the stage-1 trainer, on one device."""

    def __init__(self, cfg: Stage1Config, train_dataset=None,
                 test_dataset=None, device="cuda"):
        if cfg.num_devices > 1 or cfg.data_sharding is not None:
            raise NotImplementedError("data parallelism is not ported yet")
        if cfg.save_images:
            raise NotImplementedError("saving eval images is not ported yet")
        # full-f32 matmuls and convolutions: the bf16-operand MLP keeps
        # f32 products (ops/mlp.py) and SSIM needs f32 variances
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.ngp_cfg = cfg.ngp_config()
        self.rcfg = cfg.render_config()
        self.occ_cfg = OccGridConfig(
            resolution=cfg.grid_resolution, occ_thre=cfg.occ_thres
        )
        self.aabb = torch.as_tensor(cfg.aabb, device=self.device)

        if cfg.is_unbounded:
            from quadraturefields_tpu.data.nerf_360_v2 import (
                SubjectLoader as Loader360,
            )

            self.train_dataset = train_dataset or Loader360(
                subject_id=cfg.scene, root_fp=cfg.data_root,
                split=cfg.train_split, num_rays=10,
                color_bkgd_aug="random", factor=cfg.data_factor,
                seed=cfg.seed,
            )
            self.test_dataset = test_dataset or Loader360(
                subject_id=cfg.scene, root_fp=cfg.data_root, split="test",
                num_rays=None, factor=cfg.data_factor,
            )
        else:
            self.train_dataset = train_dataset or SubjectLoader(
                subject_id=cfg.scene, root_fp=cfg.data_root,
                split=cfg.train_split, num_rays=cfg.init_batch_size,
                seed=cfg.seed,
            )
            self.test_dataset = test_dataset or SubjectLoader(
                subject_id=cfg.scene, root_fp=cfg.data_root, split="test",
                num_rays=None,
            )

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = ngp_init(gen, self.ngp_cfg, self.device)
        self.occ_state = occ_grid_init(self.aabb, self.occ_cfg, self.device)
        self.step = 0
        self._window_render = None  # built on the first windowed eval

    def _eval_render_impl(self, params, occ_state, origins, viewdirs):
        """One-shot render of one chunk with the eval sample budget
        (4x the training budget, at most 2^20): (rgb, opacity, depth,
        num_valid)."""
        rcfg = dataclasses.replace(
            self.rcfg,
            max_samples_total=min(1 << 20, self.rcfg.max_samples_total * 4),
        )
        bkgd = torch.ones(3, device=self.device)
        return render_rays_occgrid(
            params, self.aabb, self.ngp_cfg, occ_state, origins, viewdirs,
            rcfg, render_bkgd=bkgd,
        )[:4]

    def _use_window_eval(self) -> bool:
        cfg = self.cfg
        if cfg.eval_renderer == "window":
            return True
        if cfg.eval_renderer == "oneshot":
            return False
        oneshot_budget = min(1 << 20, self.rcfg.max_samples_total * 4)
        return cfg.eval_chunk * self.rcfg.max_steps > oneshot_budget

    @torch.no_grad()
    def render_view(self, data) -> torch.Tensor:
        """Full-image render in fixed chunks of `eval_chunk` rays (the
        last padded with zero origins and direction (0, 0, 1)); per
        chunk the one-shot or the windowed renderer. Returns rgb [n, 3]
        on the trainer's device."""
        cfg = self.cfg
        use_window = self._use_window_eval()
        if use_window and self._window_render is None:
            # budget == chunk * window_steps: a window never truncates
            wsteps = int(np.clip((1 << 20) // cfg.eval_chunk, 16, 256))
            self._window_render = make_test_renderer(
                self.params, self.aabb, self.ngp_cfg, self.rcfg,
                window_steps=wsteps,
                window_budget=cfg.eval_chunk * wsteps,
            )
        origins = np.asarray(data["rays"].origins, np.float32)
        viewdirs = np.asarray(data["rays"].viewdirs, np.float32)
        n = origins.shape[0]
        chunk = cfg.eval_chunk
        n_pad = (n + chunk - 1) // chunk * chunk
        o = np.concatenate([origins, np.zeros((n_pad - n, 3), np.float32)])
        d = np.concatenate(
            [viewdirs, np.tile([[0, 0, 1.0]], (n_pad - n, 1))]
        ).astype(np.float32)
        o = torch.as_tensor(o, device=self.device)
        d = torch.as_tensor(d, device=self.device)
        outs = []
        for i in range(0, n_pad, chunk):
            oc, dc = o[i:i + chunk], d[i:i + chunk]
            if use_window:
                rgb, _, _, _ = self._window_render(
                    self.occ_state, oc, dc,
                    render_bkgd=torch.ones(3, device=self.device),
                    params=self.params,
                )
            else:
                rgb, _, _, _ = self._eval_render_impl(
                    self.params, self.occ_state, oc, dc
                )
            outs.append(rgb)
        return torch.cat(outs)[:n]

    def evaluate(self):
        cfg = self.cfg
        n_views = len(self.test_dataset)
        if cfg.eval_views is not None:
            n_views = min(n_views, cfg.eval_views)
        psnrs, ssims, lpipss = [], [], []
        H, W = self.test_dataset.HEIGHT, self.test_dataset.WIDTH
        for i in range(n_views):
            data = self.test_dataset.fetch_eval_view(i)
            rgb_img = self.render_view(data).reshape(H, W, 3)
            pixels = torch.as_tensor(
                np.asarray(data["pixels"], np.float32), device=self.device
            ).reshape(H, W, 3)
            psnrs.append(float(psnr(rgb_img, pixels)))
            ssims.append(float(ssim(rgb_img, pixels)))
            lpipss.append(lpips_metric(rgb_img, pixels))
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "lpips": float(np.mean(lpipss)),
        }

    def save(self, path):
        save_checkpoint(path, {
            "params": self.params,
            "occs": self.occ_state.occs,
            "binaries": self.occ_state.binaries,
            "step": self.step,
        })

    def load(self, path):
        state = load_checkpoint(path, map_location=self.device)
        self.params = state["params"]
        self.occ_state = OccGridState(
            occs=state["occs"], binaries=state["binaries"], aabb=self.aabb
        )
        self.step = int(state["step"])
