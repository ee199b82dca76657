#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit; build the three CUDA
     kernels of the stage-1 render path from quadraturefields_tpu_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes, and time both;
  3. render fixture views at full model width (Stage1Config defaults,
     weights from a seeded generator) through Stage1Trainer.evaluate
     with the one-shot renderer, count each kernel's launches in that
     run, compare a kernel-path view with a plain-path view, render one
     view with the default ("auto" -> windowed) renderer, and report
     rays/s and samples/s.
The last two lines of standard output are a JSON summary of the kernels
and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class FixtureViews:
    """Fixture views held in memory, with the NeRF-synthetic loader's
    eval interface (HEIGHT, WIDTH, len, fetch_eval_view). Poses and
    camera rays follow quadraturefields_tpu.data.fixture; pixels are the
    analytic scene rendered at a 2e-2 step (ground truth for PSNR only)."""

    def __init__(self, n_views=4, res=256, fov_deg=50.0, seed=2):
        from quadraturefields_tpu.data.fixture import (
            FixtureScene,
            _look_at_poses,
            render_fixture_view,
        )
        from quadraturefields_tpu.data.nerf_synthetic import Rays

        scene = FixtureScene()
        focal = 0.5 * res / np.tan(0.5 * np.deg2rad(fov_deg))
        self.HEIGHT = self.WIDTH = res
        x, y = np.meshgrid(np.arange(res, dtype=np.float32),
                           np.arange(res, dtype=np.float32), indexing="xy")
        dirs_cam = np.stack([(x - res / 2.0 + 0.5) / focal,
                             -(y - res / 2.0 + 0.5) / focal,
                             -np.ones_like(x)], axis=-1).reshape(-1, 3)
        self.views = []
        for c2w in _look_at_poses(n_views, seed=seed):
            dirs = dirs_cam @ c2w[:3, :3].T
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
            rgb, _ = render_fixture_view(scene, c2w, res, focal, step=2e-2)
            self.views.append({
                "pixels": np.clip(rgb, 0, 1).reshape(-1, 3)
                .astype(np.float32),
                "rays": Rays(origins.astype(np.float32),
                             dirs.astype(np.float32)),
                "color_bkgd": np.ones(3, np.float32),
            })

    def __len__(self):
        return len(self.views)

    def fetch_eval_view(self, index):
        return self.views[index % len(self.views)]


def compare_kernels(torch, dev, report):
    """Phase 2: each kernel against its plain version at main-path
    shapes. Fills report[name] with max_abs_err, ms and plain_ms."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob

    g = torch.Generator(device=dev).manual_seed(0)

    # encode: 2^20 points, L16 F2 T2^19, table U(-1,1), err <= 1e-5
    n = 1 << 20
    x = torch.rand((n, 3), generator=g, device=dev)
    for interp in ("tet", "cube"):
        cfg = hg.HashGridConfig.from_max_resolution(
            4096, n_levels=16, n_features=2, log2_hashmap_size=19,
            interp=interp)
        table = torch.rand((cfg.total_entries, 2), generator=g,
                           device=dev) * 2 - 1
        got = hg.encode_kernel(table, x, cfg)
        want = hg.encode_plain(table, x, cfg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: hg.encode_kernel(table, x, cfg))
        plain_ms = cuda_ms(lambda: hg.encode_plain(table, x, cfg), iters=5)
        print(f"encode {interp}: {n} points, {cfg.total_entries} rows "
              f"({cfg.total_entries * 8 / 1e6:.1f} MB): max_abs_err {err} "
              f"(limit 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= 1e-5, f"encode {interp} disagrees: {err}")
        if interp == "tet":  # the trainer default
            report["hashgrid_encode"] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=plain_ms)
        del table, got, want

    # coarse bits: 32^3 grid, 2^21 queries (some outside the box)
    res, q = 32, 1 << 21
    binaries = torch.rand((res, res, res), generator=g, device=dev) < 0.3
    aabb = torch.tensor([-1.5] * 3 + [1.5] * 3, device=dev)
    pos = torch.rand((q, 3), generator=g, device=dev) * 4 - 2
    bits = ob.pack_occupancy_bits(binaries)
    got = ob.lookup_bits_kernel(bits, aabb, pos, res)
    want = ob.lookup_bits_plain(bits, aabb, pos, res)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    ms = cuda_ms(lambda: ob.lookup_bits_kernel(bits, aabb, pos, res))
    plain_ms = cuda_ms(lambda: ob.lookup_bits_plain(bits, aabb, pos, res))
    print(f"occupancy bits: {res}^3 grid, {q} queries: {mismatches} "
          f"mismatches (must be 0); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    check(mismatches == 0, "bit lookup is not bit-exact")
    report["occ_bits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # segment sum: 2^20 rows x 8 into 8192 segments + sentinel padding
    m, n_seg = 1 << 20, 8192
    n_real = m - m // 16
    keys = torch.randint(0, n_seg, (n_real,), generator=g, device=dev)
    keys = torch.cat([keys.sort().values,
                      torch.full((m - n_real,), n_seg, device=dev)]).int()
    vals = torch.randn((m, 8), generator=g, device=dev)
    got = hs.segment_sum_kernel(keys, vals, n_seg)
    want = hs.segment_sum_plain(keys, vals, n_seg)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    ms = cuda_ms(lambda: hs.segment_sum_kernel(keys, vals, n_seg))
    plain_ms = cuda_ms(lambda: hs.segment_sum_plain(keys, vals, n_seg))
    print(f"segment sum: {m} rows x 8 into {n_seg} segments: max_abs_err "
          f"{err}, relative {rel} (limit 1e-5); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    check(rel <= 1e-5, f"segment sum disagrees: {rel}")
    report["segment_sum"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def fixture_occupancy(trainer):
    """The fixture sphere's occupancy on the trainer's grid (4.1% of the
    128^3 cells), filled as bench.py fills the JAX grid."""
    import torch

    from quadraturefields_tpu.data.fixture import FixtureScene

    res = trainer.occ_cfg.resolution
    lin = np.linspace(-1.5, 1.5, res)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = (FixtureScene().sigma(grid.reshape(-1, 3))
            * trainer.rcfg.render_step_size).astype(np.float32)
    dev = trainer.device
    return trainer.occ_state._replace(
        occs=torch.as_tensor(occs, device=dev),
        binaries=torch.as_tensor(occs > 0.01, device=dev)
        .reshape(res, res, res),
    )


def render_slice(torch, kernels, card):
    """Phase 3: the stage-1 evaluation path at full width."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob
    from quadraturefields_tpu_torch.train.stage1_ngp import (
        Stage1Config,
        Stage1Trainer,
    )

    t0 = time.perf_counter()
    views = FixtureViews()
    print(f"fixture views: {len(views)} x {views.HEIGHT}x{views.WIDTH} "
          f"built in {time.perf_counter() - t0:.1f} s")
    cfg = Stage1Config(eval_renderer="oneshot")
    trainer = Stage1Trainer(cfg, train_dataset=views, test_dataset=views)
    trainer.occ_state = fixture_occupancy(trainer)
    occ_frac = float(trainer.occ_state.binaries.float().mean())
    print(f"model: {trainer.ngp_cfg}")
    print(f"render: {trainer.rcfg}; occupied cells {occ_frac:.4f}")

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.evaluate()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    print(f"evaluate (one-shot, first call): {metrics} in {first_s:.3f} s; "
          f"kernel launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
    check(np.isfinite(metrics["psnr"]) and np.isfinite(metrics["ssim"]),
          f"non-finite metrics {metrics}")

    # throughput: a second evaluate, then the sample count of the same
    # views (the renderer's own count, chunk by chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    budget = min(1 << 20, trainer.rcfg.max_samples_total * 4)
    samples = 0
    with torch.no_grad():
        for i in range(len(views)):
            rays = views.fetch_eval_view(i)["rays"]
            o = torch.as_tensor(rays.origins, device=trainer.device)
            d = torch.as_tensor(rays.viewdirs, device=trainer.device)
            for s in range(0, o.shape[0], cfg.eval_chunk):
                rgb, _, _, nv = trainer._eval_render_impl(
                    trainer.params, trainer.occ_state,
                    o[s:s + cfg.eval_chunk], d[s:s + cfg.eval_chunk])
                nv = int(nv)
                check(nv <= budget, f"chunk truncated: {nv} > {budget}")
                check(bool(torch.isfinite(rgb).all()), "non-finite rgb")
                samples += nv
    check(samples > 0, "no valid samples")
    n_rays = len(views) * views.HEIGHT * views.WIDTH
    print(f"stage-1 one-shot eval, {n_rays} rays, {samples} samples: "
          f"{eval_s:.4f} s -> {n_rays / eval_s:.1f} rays/s, "
          f"{samples / eval_s:.1f} samples/s [{card}]")

    # the kernel path against the plain path, on the card, same view
    data = views.fetch_eval_view(0)
    rgb_kernel = trainer.render_view(data)
    before = {k.name: k.launches for k in kernels}
    with mock.patch.object(hg, "encode_kernel", hg.encode_plain), \
            mock.patch.object(ob, "lookup_bits_kernel",
                              ob.lookup_bits_plain), \
            mock.patch.object(hs, "segment_sum_kernel",
                              hs.segment_sum_plain):
        rgb_plain = trainer.render_view(data)
    check({k.name: k.launches for k in kernels} == before,
          "the plain-path render launched a kernel")
    diff = float((rgb_kernel - rgb_plain).abs().max())
    print(f"view 0, kernel path vs plain path: max_abs_err {diff} "
          f"(limit 1e-4)")
    check(diff <= 1e-4, f"kernel-path view disagrees with plain: {diff}")

    # the default evaluator: "auto" selects the windowed renderer here
    trainer.cfg.eval_renderer = "auto"
    check(trainer._use_window_eval(), "auto did not pick the window path")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb_window = trainer.render_view(data)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    check(bool(torch.isfinite(rgb_window).all()), "non-finite window rgb")
    wdiff = float((rgb_window - rgb_kernel).abs().max())
    print(f"view 0, windowed renderer (first call): {win_s:.4f} s, "
          f"{views.HEIGHT * views.WIDTH / win_s:.1f} rays/s; max_abs_err "
          f"vs one-shot {wdiff} (limit 5e-3) [{card}]")
    # the window march re-anchors each window at near + steps*dt in f32,
    # so a sample at an occupancy-cell boundary can flip in or out: one
    # sample's weight at these random-init densities is ~2e-3
    check(wdiff <= 5e-3, f"windowed view disagrees with one-shot: {wdiff}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob

    kernels = [hg.ENCODE_KERNEL, ob.BITS_KERNEL, hs.SEGMENT_SUM_KERNEL]
    for k in kernels:
        t0 = time.perf_counter()
        k.load()
        print(f"built {k.source} in {time.perf_counter() - t0:.1f} s")

    report = {}
    compare_kernels(torch, dev, report)
    launches = render_slice(torch, kernels, card)
    check("jax" not in sys.modules, "the port imported jax")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **report[k.name]}
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
