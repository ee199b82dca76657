"""Stage 1: train the NGP radiance field with an occupancy grid.

Port of quadraturefields_tpu/train/stage1_ngp.py: `Stage1Config` field
for field, and `Stage1Trainer` on one device. A training step renders
the ray batch with the stratified occupancy-grid march, takes the
smooth-L1 + regularizer loss, backpropagates (the hash-table gradient is
a CUDA kernel on the card) and steps Adam with the reference schedule;
every 16 steps the occupancy grid is refreshed first, and after step 100
the ray batch is resized to hold the sample count near its budget.
Evaluation renders full views in fixed chunks, one-shot or windowed.

The parameters are the JAX `ngp_init` tree of leaf tensors that require
grad; assigning `trainer.params` (utils/convert.py carries JAX weights
across) rebuilds the optimizer around the new leaves. The datasets are
the port's copies of the JAX package's numpy loaders (data/).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.nerf_synthetic import SubjectLoader
from ..models.ngp import NGPConfig, ngp_init, ngp_query_density
from ..ops.distortion import flatten_eff_distloss
from ..ops.grid import (
    OccGridConfig,
    OccGridState,
    max_march_steps,
    max_march_steps_cone,
    occ_grid_init,
    occ_grid_update,
    resolve_coarse_stride,
)
from ..render.renderer import (
    RenderConfig,
    make_test_renderer,
    render_rays_occgrid,
)
from ..utils.batching import bucket_num_rays
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import lpips_metric, mse, psnr, smooth_l1_loss, ssim
from ..utils.optim import make_ngp_optimizer
from ..utils.png import read_png, write_png

# the reference's scene-type switch (examples/utils.py:30-45)
MIPNERF360_UNBOUNDED_SCENES = (
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
)


@dataclasses.dataclass
class Stage1Config:
    """The JAX trainer's config, field for field, so configs carry over.
    `data_sharding` and `num_devices` (data parallelism) are not ported
    yet; the trainer refuses them. On the cell layout grad_mode
    "stochastic" is "exact", as in JAX."""

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


def _regularizer(cfg: Stage1Config, acc, result, viewdirs, origins):
    """The regularizer variants of train_ngp_nerf_sg_occ.py:315-334
    (JAX stage1_ngp.py:196-229); "none" and unknown names give 0."""
    if cfg.reg_type == "occ":
        return (cfg.o_lambda * (-acc * torch.log(acc + 1e-10))).mean()
    if cfg.reg_type == "entropy":
        w = result.weights
        return (cfg.o_lambda * (-w * torch.log(w + 1e-7))).mean()
    if cfg.reg_type == "cauchy":
        return cfg.c_lambda * torch.log(1 + result.sigmas**2).mean()
    if cfg.reg_type == "both":
        return (
            (cfg.o_lambda * (-acc * torch.log(acc + 1e-10))).mean()
            + cfg.c_lambda * torch.log(1 + result.sigmas**2).mean()
        )
    if cfg.reg_type == "lol":
        w = result.weights
        return (cfg.o_lambda
                * torch.log(torch.exp(-w) + torch.exp(-(1 - w).abs()))
                ).mean()
    if cfg.reg_type == "distortion":
        s = result.samples
        n_rays = origins.shape[0]
        idx = s.ray_indices.clamp(0, n_rays - 1).to(torch.int64)
        t_mid = (s.t_starts + s.t_ends)[:, None] / 2.0
        pos = origins[idx] + viewdirs[idx] * t_mid
        m = (pos * viewdirs[idx]).sum(dim=1).abs()
        return cfg.o_lambda * flatten_eff_distloss(
            result.weights, m,
            torch.full_like(result.weights, cfg.render_step_size),
            s.ray_indices, n_rays,
        )
    return torch.zeros((), device=acc.device)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    """An [H, W, 3] image in [0, 1] as JAX's trainer saves it:
    (clip(img, 0, 1) * 255).astype(uint8), truncating."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def _leaves(tree):
    """The tensors of a params tree, in the tree's order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _as_leaf_params(tree):
    """A params tree of detached leaf tensors that require grad."""
    if isinstance(tree, dict):
        return {k: _as_leaf_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_leaf_params(v) for v in tree]
    return tree.detach().requires_grad_(True)


class Stage1Trainer:
    """The stage-1 trainer on one device."""

    def __init__(self, cfg: Stage1Config, train_dataset=None,
                 test_dataset=None, device="cuda"):
        if cfg.num_devices > 1 or cfg.data_sharding is not None:
            raise NotImplementedError("data parallelism is not ported yet")
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
            from ..data.nerf_360_v2 import SubjectLoader as Loader360

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

        wd = cfg.weight_decay
        if wd is None:
            if cfg.is_unbounded:
                wd = 0.0  # reference train_ngp_nerf_sg_occ.py:164
            else:
                wd = (1e-5 if cfg.scene in ("materials", "ficus", "drums")
                      else 1e-6)
        self.weight_decay = wd
        self.step = 0
        # one generator for the init, then the march and occupancy jitter
        self.generator = torch.Generator(device=self.device) \
            .manual_seed(cfg.seed)
        self.params = _as_leaf_params(
            ngp_init(self.generator, self.ngp_cfg, self.device))
        self._make_optimizer()
        self.occ_state = occ_grid_init(self.aabb, self.occ_cfg, self.device)
        self._window_render = None  # built on the first windowed eval

    def _make_optimizer(self):
        """A fresh Adam over self.params, its schedule continuing from
        self.step. Call it after replacing the params."""
        self.optimizer, self.scheduler = make_ngp_optimizer(
            _leaves(self.params), self.cfg.max_steps, lr=self.cfg.lr,
            weight_decay=self.weight_decay, start_step=self.step)

    # ---- the training step ----
    def _occ_update_impl(self, step: int) -> OccGridState:
        def occ_eval_fn(x):
            d = ngp_query_density(self.params, x, self.aabb, self.ngp_cfg)
            return d[..., 0] * self.rcfg.render_step_size

        with torch.no_grad():
            return occ_grid_update(
                self.occ_state, step, occ_eval_fn, self.occ_cfg,
                contract_aabb=self.aabb if self.cfg.is_unbounded else None,
                generator=self.generator,
            )

    def _loss_fn(self, params, occ_state, origins, viewdirs, pixels, bkgd,
                 t_jitter):
        """(loss, aux) of one batch; t_jitter [n_rays] are the stratified
        march's uniforms."""
        result = render_rays_occgrid(
            params, self.aabb, self.ngp_cfg, occ_state, origins, viewdirs,
            self.rcfg, render_bkgd=bkgd, stratified=True, t_jitter=t_jitter,
        )
        rgb_loss = smooth_l1_loss(result.rgb, pixels)
        acc = result.opacity[:, 0]
        reg = _regularizer(self.cfg, acc, result, viewdirs, origins)
        loss = rgb_loss + reg
        aux = {
            "rgb_loss": rgb_loss.detach(),
            "reg": reg.detach(),
            "num_valid": result.num_valid,
            "mse": mse(result.rgb, pixels).detach(),
        }
        return loss, aux

    def _train_step_impl(self, origins, viewdirs, pixels, bkgd, t_jitter):
        """Loss, backward and one Adam update (the schedule steps after
        it); returns (loss, aux)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._loss_fn(self.params, self.occ_state, origins,
                                  viewdirs, pixels, bkgd, t_jitter)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach(), aux

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train_one_step(self):
        cfg = self.cfg
        step = self.step
        if step % self.occ_cfg.update_interval == 0:
            self.occ_state = self._occ_update_impl(step)

        data = self.train_dataset.fetch_train_batch()
        origins = self._to_device(data["rays"].origins)
        viewdirs = self._to_device(data["rays"].viewdirs)
        pixels = self._to_device(data["pixels"])
        bkgd = self._to_device(data["color_bkgd"])
        t_jitter = torch.rand((origins.shape[0],), generator=self.generator,
                              device=self.device)
        loss, aux = self._train_step_impl(origins, viewdirs, pixels, bkgd,
                                          t_jitter)

        n_valid = int(aux["num_valid"])
        if cfg.target_sample_batch_size > 0 and step > 100 and n_valid > 0:
            num_rays = int(
                len(pixels) * cfg.target_sample_batch_size / float(n_valid)
            )
            self.train_dataset.update_num_rays(
                bucket_num_rays(num_rays, max_rays=cfg.max_num_rays)
            )
        self.step += 1
        return loss, aux

    def train(self, log_fn=print):
        """Steps 0..max_steps with logging and checkpoints, then the
        final evaluate; writes args.json and log.json under
        root/results/<scene>/<exp_name>."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.root, "results", cfg.scene, cfg.exp_name)
        ckpt_dir = os.path.join(cfg.root, "ckpts", cfg.scene, cfg.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(out_dir, "args.json"), "w") as f:
            json.dump(
                {k: v for k, v in dataclasses.asdict(cfg).items()
                 if not k.startswith("data_sharding")},
                f, indent=2, default=str,
            )

        from ..utils.logging import ExperimentLogger

        logger = ExperimentLogger(
            os.path.join(cfg.root, "logs", cfg.scene, cfg.exp_name),
            results_dir=out_dir,
        )
        tic = time.time()
        rays_done = 0
        while self.step <= cfg.max_steps:
            step = self.step
            loss, aux = self.train_one_step()
            rays_done += self.train_dataset.num_rays

            if step % cfg.log_every == 0:
                train_psnr = -10.0 * float(torch.log10(aux["mse"]))
                elapsed = time.time() - tic
                logger.add_scalar("train/loss", float(loss), step)
                logger.add_scalar("train/psnr", train_psnr, step)
                logger.add_scalar("train/n_rendering_samples",
                                  int(aux["num_valid"]), step)
                log_fn(
                    f"elapsed_time={elapsed:.2f}s | step={step} | "
                    f"loss={float(loss):.5f} | psnr={train_psnr:.2f} | "
                    f"n_samples={int(aux['num_valid'])} | "
                    f"num_rays={self.train_dataset.num_rays} | "
                    f"rays/s={rays_done / max(elapsed, 1e-9):.0f}"
                )
            if step > 0 and step % cfg.ckpt_every == 0:
                self.save(os.path.join(ckpt_dir, "ngp.pt"))
        metrics = self.evaluate(out_dir)
        logger.add_scalar("test/psnr", metrics["psnr"], self.step)
        logger.add_scalar("test/ssim", metrics["ssim"], self.step)
        logger.close()
        with open(os.path.join(out_dir, "log.json"), "a") as f:
            json.dump({"step": self.step - 1, **metrics}, f)
        return metrics

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

    def evaluate(self, out_dir=None):
        """PSNR, SSIM and LPIPS over the test views. With save_images and
        an out_dir, each view's render and its absolute error go to
        rgb_test_{i:03d}.png and rgb_error_{i:03d}.png as uint8 (the
        port's own PNG writer), then into rgb.mp4 and rgb_error.mp4 where
        imageio and a codec are installed."""
        cfg = self.cfg
        n_views = len(self.test_dataset)
        if cfg.eval_views is not None:
            n_views = min(n_views, cfg.eval_views)
        save = cfg.save_images and out_dir is not None
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
            if save:
                write_png(os.path.join(out_dir, f"rgb_test_{i:03d}.png"),
                          _to_uint8(rgb_img))
                write_png(os.path.join(out_dir, f"rgb_error_{i:03d}.png"),
                          _to_uint8((rgb_img - pixels).abs()))
        if save:
            self._write_videos(out_dir)
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "lpips": float(np.mean(lpipss)),
        }

    @staticmethod
    def _write_videos(out_dir):
        """Assemble the eval PNGs into mp4s (reference
        train_ngp_nerf_sg_occ.py:444-456), as JAX's trainer does. Without
        imageio or a video codec no mp4 is written."""
        import glob

        try:
            import imageio.v2 as imageio
        except ImportError:
            return
        for pattern, name in (
            ("rgb_test_*.png", "rgb.mp4"),
            ("rgb_error_*.png", "rgb_error.mp4"),
        ):
            frames = sorted(glob.glob(os.path.join(out_dir, pattern)))
            if len(frames) < 2:
                continue
            try:
                imageio.mimsave(os.path.join(out_dir, name),
                                [read_png(f) for f in frames], fps=20)
            except Exception:
                pass  # no video codec in minimal environments

    def save(self, path):
        """Weights, occupancy grid, Adam state and step, as the JAX
        trainer's save."""
        save_checkpoint(path, {
            "params": self.params,
            "occs": self.occ_state.occs,
            "binaries": self.occ_state.binaries,
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        })

    def load(self, path):
        state = load_checkpoint(path, map_location=self.device)
        self.step = int(state["step"])
        self.params = _as_leaf_params(state["params"])
        self._make_optimizer()
        if "opt_state" in state:
            self.optimizer.load_state_dict(state["opt_state"])
        self.occ_state = OccGridState(
            occs=state["occs"], binaries=state["binaries"], aabb=self.aabb
        )
