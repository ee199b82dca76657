#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # and a torch.profiler breakdown of
                                      # one evaluate() of phase 3 and the
                                      # training steps of phases 4, 5, 7, 8
    python3 chip_smoke.py --export N  # and phase 7's field exported again
                                      # at N^3 (the CLI's default: 1024),
                                      # and phase 8's stage 3 run on it
    python3 chip_smoke.py --baseline DIR
        # and time K8's interface, K1's stream interface, K6's route and
        # K3 of another checkout at DIR (e.g. a parent commit unpacked
        # with `git archive`) beside this one's, in turns, on the same
        # inputs

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit; build the kernels of
     quadraturefields_tpu_torch/csrc, one nvcc per source, all at once,
     and beside them the host geometry library (g++);
  2. hold each kernel against its plain PyTorch version on the card at
     the main paths' shapes, and time both (and the one-call library
     equivalent where there is one): the encode (K2), the occupancy
     bits (K4), the per-ray segment sum (K3: 2^20 rows at 120 a
     segment, and 163,840 rows, the stage-4 pack cap, at 0.6, 2.5 and 8
     a segment, with pads; each also for exact zeros in its empty
     segments and a bit-identical rerun), the fused table gradient
     (K1) at 2^18 points, K1's stream interface at 16.8M contributions,
     K8's one-launch value-layout interface on the same stream, and the
     cell layout's table gradients K5, K6 and K7 at 8.4M contributions
     into the 439,472 rows of the run_nerfsynthetic_tpu_fast.sh grid
     (each fused from 2^20 points and from its stream, K7 and K5 also at
     F = 2; K5 fused tet and cube, f32 and bf16sim, and K6 fused beside
     the stream routes they replaced; K6 fused also on grid knots, upper
     faces and rank ties);
  3. the evaluation path: render fixture views at full model width
     (Stage1Config defaults, seeded random weights) through
     Stage1Trainer.evaluate with the one-shot renderer, count each
     kernel's launches in that run, compare a kernel-path view with a
     plain-path view, render one view with the default ("auto" ->
     windowed) renderer, and report rays/s and samples/s;
  4. the training path: Stage1Trainer.train at Stage1Config defaults for
     300 steps on the same views, counting each kernel's launches; check
     that the loss halves, the final eval PSNR passes 20 dB and the
     occupancy grid is pruned below half; report steady-state ms/step,
     rays/s and samples/s over steps 150-300; then hold one training
     step on the kernel path against the plain path on the card;
  5. the cell training path: the same at run_nerfsynthetic_tpu_fast.sh's
     configuration (cell layout L8 F4 tet, bf16factor table gradient,
     mlp head, 2 head layers, a 2^20-sample budget); K7's fused entry
     must launch once a step, its stream entry, K5 and K6 never;
     then the same configuration with the CLI's default f32 table
     gradient ("train_cell_f32"): K5's fused entry once a step, and with
     the bf16pair table gradient ("train_cell_bf16pair"): K6's fused
     entry once a step; every other cell table gradient never;
  6. K1, K2, K3, K5, K6, K7 and K8 again, on the main paths' own inputs
     captured in phases 3-5, 7 and 8 (it runs last): the positions of
     one eval chunk (all its slots, and its valid samples alone), of one
     corner training step, of one stage-2 step on the 317 MB field table
     and of one joint stage-4 step on the 813 MB deformation table (K2,
     tet as the paths run it and cube on the same positions), the
     positions and cotangent of that corner step (K1, tet and cube; K8
     and K1's stream interface on its contributions in ray order), of
     the stage-2 and stage-4 steps (K1 into their tables, and the
     zeroing alone), of one step of each cell path (K7, K5, K6); and K3
     (against index_add_ of the same rows) on each path's composite: the
     busiest eval chunk, a step of each stage-1 training path, a
     stage-2 step, and the joint stage-4 step's volumetric twin and its
     packed quadrature stream, each with its rows a segment;
  7. stage 2 ("train_field"): a stage-1 feeder with
     run_nerfsynthetic.sh's model flags (corner L16 F2 T2^19, mlp head,
     2 layers, scale 1.5, occ regulariser, occ_thres 0.01) trains 300
     steps at 2^18 samples and is saved with Stage1Trainer.save;
     Stage2Trainer reads it and trains run_nerfsynthetic_field.sh's field
     (corner tet L16 F2, log2_T 30: 39,601,112 rows, a dense 256^3 top
     level; hidden 16, ELU, f32) for 300 steps at 2^18 samples through
     train(), which exports the grids at 256^3. K2, K4, K3 and the fused
     K1 must launch, K1 once a step, no cell table gradient and no stream
     entry. Gates: finite losses whose last-20 mean is below
     FIELD_LOSS_GATE times the first-20 mean, the artifact contract
     (grids_valid f32, grads_valid and density_grids_valid f16, all
     256^3, binaries), and the fixture sphere in the exported |grad|:
     its shell against outside and against deep inside
     (FIELD_SHELL_GATE, FIELD_INTERIOR_GATE). Reports ms/step, rays/s
     and samples/s over steps 150-300, the export's points/s and Adam's
     time over the field; then one step on the kernel path against the
     plain path.
  8. stages 3 and 4 ("train_finetune"): the port's marching_cubes and
     downsample_mesh CLIs with run_nerfsynthetic_mc.sh's arguments
     (STAGE3_ARGS) on phase 7's 256^3 export (and its 1024^3 export
     with --export 1024), timed (device filters, marching tetrahedra,
     decimation); gates: a mesh near the fixture sphere, smp_mesh.ply
     smaller, the three files. Then Stage4Trainer.train at
     run_nerfsynthetic_finetune.sh's flags (the deformation field's
     table 101,626,144 rows x F2 f32, 813 MB; 2^17 hits a step; up
     sample 2; 25 hits a ray) from phase 7's feeder checkpoint and the
     smp_mesh.ply: 400 steps, the first 300 with the radiance field
     frozen, a mesh update at step 200 between two 2-view evaluations.
     K2, K4, K3 and the fused K1 must launch (K1 once a frozen step,
     three times a joint one), no cell table gradient and no stream
     entry. Gates: finite losses that fall, the eval PSNR (at least
     FINETUNE_PSNR_GATE, and FINETUNE_GAIN_GATE above step 200's, before
     the joint steps). Reports ms/step (frozen, joint), rendered
     hits/s, rays a step, the wait on the host BVH's prefetcher and
     Adam's time; then a frozen and a joint step on the kernel path
     against the plain path. Phase 6 also holds K2 and K1 on that
     joint step's field positions (the 813 MB table) and K3 on its
     packed composite.
Reduced sizes, against the scripts: the stage-1 feeder runs 300 steps at
2^18 samples (run_nerfsynthetic.sh: 20,000 at 2^20); stage 2 runs 300
of its 25,000 steps; the export is 256^3 (the CLI's default 1024^3);
stage 4 runs 400 of its 10,000 steps with a mesh update every 200
(the script: 2000) and evaluates 2 views;
the views are 4 fixture views of 256^2 (the scripts: nerf-synthetic
chair). The field, the NGP and the 2^18 stage-2 budget run at the
scripts' widths.
The last two lines of standard output are a JSON summary of the kernels
and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np

# the card's published peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores; a kernel's bound is the larger of bytes / HBM rate
# and operations / f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    back-to-back calls after `warmup` calls, queued while the device
    is held busy."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the device for ~50 ms so that the host has queued the calls
    # before the first runs: the events then see device time, not the
    # host's launch overhead (a 0.1 ms kernel is close to it)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(new, old=None, iters=20) -> tuple:
    """(device ms of new(), extra report fields). With `old`, the same
    function as a baseline checkout builds it (--baseline): its output
    must lie within 1e-5 of max of new()'s, and both are timed in turns
    (old, new, new, old), each the mean of its two runs; the fields then
    hold old's time as baseline_ms."""
    if old is None:
        return cuda_ms(new, iters), {}
    want, got = new(), old()
    err = float((got - want).abs().max())
    check(err <= 1e-5 * float(want.abs().max()),
          f"the baseline computes another function: {err}")
    del want, got
    o1 = cuda_ms(old, iters)
    n1 = cuda_ms(new, iters)
    n2 = cuda_ms(new, iters)
    o2 = cuda_ms(old, iters)
    return (n1 + n2) / 2, {"baseline_ms": (o1 + o2) / 2}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time of a function that moves n_bytes and does n_ops
    f32 operations on this card, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def rows_touched(torch, x, cfg) -> int:
    """Distinct corner-table rows that the encode of x reads."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg

    idx, _ = hg._corner_indices_weights(x, cfg)
    touched = torch.zeros(cfg.total_entries, dtype=torch.bool,
                          device=x.device)
    touched[idx.reshape(-1)] = True
    return int(touched.sum())


def encode_bound(torch, x, cfg) -> dict:
    """K2: x and out once, each table row the corners touch once; a
    multiply-add per corner feature."""
    n = x.shape[0]
    return bound(n * 12 + rows_touched(torch, x, cfg) * cfg.n_features * 4
                 + n * cfg.output_dim * 4,
                 2 * n * cfg.n_levels * cfg.corners * cfg.n_features)


class BaselineKernel:
    """One C entry point of another checkout's csrc/<library>.cu, with
    the C interface of this checkout's kernel `like`: built by load()
    with the package's nvcc flags into build/kernels/baseline/<tag>/
    (one library per entry point), launched on the current stream. It
    counts no launches."""

    def __init__(self, csrc: Path, library: str, like, tag: str):
        self.src = csrc / f"{library}.cu"
        self.like = like
        self.tag = tag
        self._fn = None

    def load(self):
        import ctypes

        from quadraturefields_tpu_torch._cuda import (
            BUILD_DIR,
            NVCC_FLAGS,
            find_nvcc,
        )

        if self._fn is None:
            out = (BUILD_DIR / "baseline" / self.tag
                   / f"lib{self.src.stem}-{self.like.symbol}.so")
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                            str(self.src)], check=True, capture_output=True,
                           timeout=600)
            fn = getattr(ctypes.CDLL(str(out)), self.like.symbol)
            fn.argtypes = self.like.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device, *args):
        import ctypes

        import torch

        stream = torch.cuda.current_stream(device).cuda_stream
        code = self.load()(*args, ctypes.c_void_p(stream))
        check(code == 0, f"{self.src} failed to launch: {code}")


def rows_route(x, g, cfg, stream_kernel):
    """K5's route before its fused entry: the [N*L, 8F] contribution
    rows built with _cell_indices_weights (rounded to bf16 for
    bf16sim), then a stream entry stream_kernel(idx, vals, E)."""
    import torch

    from quadraturefields_tpu_torch.ops import hashgrid as hg

    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    idx, w8 = hg._cell_indices_weights(x, cfg)
    vals = (w8.reshape(n * L, 8, 1)
            * g.reshape(n * L, F)[:, None, :]).reshape(n * L, 8 * F)
    if cfg.grad_payload == "bf16sim":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return stream_kernel(idx.reshape(-1), vals, cfg.total_entries)


def pair_route(x, g, cfg, stream_kernel):
    """K6's route before its fused entry: the [N*L, 4F] lo and hi pair
    streams built with _cell_indices_weights, then a stream entry
    stream_kernel(idx, lo, hi, E)."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg

    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    idx, w8 = hg._cell_indices_weights(x, cfg)
    w8, g2 = w8.reshape(n * L, 8, 1), g.reshape(n * L, F)
    lo = (w8 * g2[:, None, 0::2]).reshape(n * L, 4 * F)
    hi = (w8 * g2[:, None, 1::2]).reshape(n * L, 4 * F)
    return stream_kernel(idx.reshape(-1), lo, hi, cfg.total_entries)


class Baseline:
    """The kernels this checkout redesigned, as another checkout's csrc/
    builds them (`--baseline DIR`): K1's stream entry and K6's stream
    entry, launched with the arguments of this checkout's wrappers,
    whose C interfaces they share, and the other checkout's interfaces
    built on them: K8's (PyTorch entries and bf16 casts, then the pair
    kernel) and K6's route (the lo/hi streams, then K6's stream
    entry); and K3 through its first C interface (no lanes a segment)."""

    def __init__(self, root):
        import ctypes
        from types import SimpleNamespace

        from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

        csrc = Path(root) / "quadraturefields_tpu_torch" / "csrc"
        check(csrc.is_dir(), f"--baseline: no csrc/ under {root}")
        tag = Path(root).resolve().name
        self.pairs = BaselineKernel(csrc, "table_grad",
                                    hs.TABLE_GRAD_PAIRS_KERNEL, tag)
        self.pair = BaselineKernel(csrc, "cell_table_grad",
                                   hs.CELL_PAIR_GRAD_KERNEL, tag)
        first_segment_sum = SimpleNamespace(
            symbol="qf_segment_sum",
            argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int])
        self.segsum = BaselineKernel(csrc, "segment_sum", first_segment_sum,
                                     tag)
        self.kernels = (self.pairs, self.pair, self.segsum)

    def segment_sum_fn(self, keys, vals, n_seg):
        """K3 as the other checkout builds it, through its first C
        interface (keys, vals, out, m, n_seg, rw)."""
        import torch

        from quadraturefields_tpu_torch._cuda import ptr

        out = torch.empty((n_seg, vals.shape[1]), dtype=torch.float32,
                          device=vals.device)
        self.segsum.launch(vals.device, ptr(keys), ptr(vals), ptr(out),
                           keys.shape[0], n_seg, vals.shape[1])
        return out

    def pairs_fn(self, idx, v0, v1, n_entries):
        import torch

        from quadraturefields_tpu_torch._cuda import ptr

        out = torch.zeros((n_entries, 2), dtype=torch.float32,
                          device=v0.device)
        self.pairs.launch(v0.device, ptr(idx), int(idx.dtype == torch.int64),
                          ptr(v0), ptr(v1), ptr(out), idx.shape[0],
                          n_entries)
        return out

    def values_fn(self, rows, lane0, v0, v1, total_values):
        """The PR-5 form of K8's interface: the entries in int64 and the
        bf16 casts in PyTorch, then the pair kernel."""
        import torch

        entries = (rows.to(torch.int64) * 128 + lane0.to(torch.int64)) // 2
        v0 = v0.to(torch.bfloat16).to(torch.float32).contiguous()
        v1 = v1.to(torch.bfloat16).to(torch.float32).contiguous()
        n_entries = -(-total_values // 128) * 64
        return self.pairs_fn(entries, v0, v1,
                             n_entries).reshape(-1)[:total_values]

    def pair_stream_fn(self, idx, lo, hi, n_entries):
        import torch

        from quadraturefields_tpu_torch._cuda import ptr

        m, pw = lo.shape
        out = torch.zeros((n_entries, 2 * pw), dtype=torch.float32,
                          device=lo.device)
        self.pair.launch(lo.device, ptr(idx), int(idx.dtype == torch.int64),
                         ptr(lo), ptr(hi), ptr(out), m, pw, n_entries)
        return out

    def pair_route_fn(self, x, g, cfg):
        """The other checkout's backward route of K6: the lo/hi streams
        built from x, then its stream entry."""
        return pair_route(x, g, cfg, self.pair_stream_fn)


@contextmanager
def capture(mod, name, store, key, when=None):
    """Patch mod.name so that the arguments of its first call (of the
    first for which when(*args) holds, with `when`; tensors cloned) land
    in store[key]."""
    real = getattr(mod, name)

    def recording(*args):
        if key not in store and (when is None or when(*args)):
            store[key] = tuple(a.detach().clone() if hasattr(a, "detach")
                               else a for a in args)
        return real(*args)

    with mock.patch.object(mod, name, recording):
        yield


class FixtureViews:
    """Fixture views held in memory, with the NeRF-synthetic loader's
    eval interface (HEIGHT, WIDTH, len, fetch_eval_view) and its training
    interface (num_rays, update_num_rays, fetch_train_batch: pixels drawn
    across all views with a seeded numpy generator, as SubjectLoader
    draws them). Poses and camera rays follow
    quadraturefields_tpu_torch.data.fixture; pixels are the analytic
    scene rendered at a 2e-2 step on white. `upsampled(u)` gives the
    same views in SubjectLoader's upsample mode (stage 4): rays on a
    grid u times finer (focal and size times u), each pixel of the
    rendered image shared by its u x u rays (index y // u, x // u)."""

    def __init__(self, n_views=4, res=256, fov_deg=50.0, seed=2,
                 num_rays=4096):
        from quadraturefields_tpu_torch.data.fixture import (
            FixtureScene,
            _look_at_poses,
            render_fixture_view,
        )

        scene = FixtureScene()
        self.res, self.seed, self.u = res, seed, 1
        self.focal = 0.5 * res / np.tan(0.5 * np.deg2rad(fov_deg))
        self.poses = list(_look_at_poses(n_views, seed=seed))
        self._pixels = np.stack([
            np.clip(render_fixture_view(scene, c2w, res, self.focal,
                                        step=2e-2)[0], 0, 1)
            .reshape(-1, 3).astype(np.float32) for c2w in self.poses])
        self._set_rays(1)
        self.num_rays = num_rays
        self.rng = np.random.default_rng(seed)

    def _set_rays(self, u: int):
        from quadraturefields_tpu_torch.data.nerf_synthetic import Rays

        self._rays, self.u = Rays, u
        w, focal = self.res * u, self.focal * u
        self.HEIGHT = self.WIDTH = w
        x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                           np.arange(w, dtype=np.float32), indexing="xy")
        dirs_cam = np.stack([(x - w / 2.0 + 0.5) / focal,
                             -(y - w / 2.0 + 0.5) / focal,
                             -np.ones_like(x)], axis=-1).reshape(-1, 3)
        origins, dirs = [], []
        for c2w in self.poses:
            d = dirs_cam @ c2w[:3, :3].T
            dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
            origins.append(np.broadcast_to(c2w[:3, 3], d.shape))
        self._origins = np.stack(origins).astype(np.float32)
        self._dirs = np.stack(dirs).astype(np.float32)
        self.views = [{"pixels": self._pixels[i],
                       "rays": Rays(self._origins[i], self._dirs[i]),
                       "color_bkgd": np.ones(3, np.float32)}
                      for i in range(len(self.poses))]

    def upsampled(self, u: int, num_rays: int = 1024) -> "FixtureViews":
        other = copy.copy(self)  # shares the poses and rendered pixels
        other._set_rays(u)
        other.num_rays = num_rays
        other.rng = np.random.default_rng(self.seed)
        return other

    def __len__(self):
        return len(self.views)

    def fetch_eval_view(self, index):
        return self.views[index % len(self.views)]

    def update_num_rays(self, num_rays: int):
        self.num_rays = int(num_rays)

    def fetch_train_batch(self):
        n = self.num_rays
        image_id = self.rng.integers(0, len(self.views), size=n)
        x = self.rng.integers(0, self.WIDTH, size=n)
        y = self.rng.integers(0, self.HEIGHT, size=n)
        ray = y * self.WIDTH + x
        pix = (y // self.u) * self.res + x // self.u
        return {
            "pixels": self._pixels[image_id, pix],
            "rays": self._rays(self._origins[image_id, ray],
                               self._dirs[image_id, ray]),
            "color_bkgd": np.ones(3, np.float32),
        }


def segment_sum_case(torch, label, keys, vals, n_seg, card, baseline=None):
    """K3 on (keys, vals, n_seg): the rows a segment; the kernel within
    1e-5 of max of the plain sum in float64, its segments without rows
    exactly 0 and a second launch bit for bit the first; its time (with a
    baseline, beside the other checkout's K3 in turns), the plain
    version's, index_add_ of the same rows into zeros (the one PyTorch
    call of K3's function, its yardstick) and the bound: the valid rows'
    keys and values read once, the output written once, an add a value.
    Returns the report entry."""
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    m, rw = vals.shape
    rows = torch.bincount(keys.long().clamp(0, n_seg),
                          minlength=n_seg + 1)[:n_seg]
    valid, longest = int(rows.sum()), int(rows.max())
    got = hs.segment_sum_kernel(keys, vals, n_seg)
    again = hs.segment_sum_kernel(keys, vals, n_seg)
    want = hs.segment_sum_plain(keys, vals.double(), n_seg)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    empty_zero = not bool(got[rows == 0].any())
    same_bits = bool(torch.equal(got, again))
    del got, again, want
    ms, res = timed(lambda: hs.segment_sum_kernel(keys, vals, n_seg),
                    baseline and (lambda: baseline.segment_sum_fn(
                        keys, vals, n_seg)))
    plain_ms = cuda_ms(lambda: hs.segment_sum_plain(keys, vals, n_seg))
    acc = torch.zeros((n_seg + 1, rw), device=vals.device)
    keys_c = keys.long().clamp(0, n_seg)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, keys_c, vals))
    del acc, keys_c
    b = bound(valid * (4 + 4 * rw) + n_seg * 4 * rw, valid * rw)
    lanes = hs.segment_group(m, n_seg)
    print(f"segment sum (K3) on {label}: {m} rows x {rw}, {valid} valid, "
          f"into {n_seg} segments: {valid / n_seg:.3f} rows a segment "
          f"(at most {longest}), {lanes} lanes a segment; max_abs_err "
          f"{err}, relative {err / max(scale, 1e-30)} (limit 1e-5), empty "
          f"segments 0: {empty_zero}, rerun bit for bit: {same_bits}; "
          f"kernel {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}), plain {plain_ms:.4f} ms, index_add_ "
          f"{lib_ms:.4f} ms; baseline {res} [{card}]")
    check(err <= 1e-5 * scale, f"segment sum on {label} disagrees: {err}")
    check(empty_zero, f"segment sum on {label}: an empty segment is not 0")
    check(same_bits, f"segment sum on {label}: two launches differ")
    return dict(rows=m, valid_rows=valid, segments=n_seg,
                rows_a_segment=valid / n_seg, max_rows_a_segment=longest,
                lanes=lanes, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **b, **res)


def sorted_keys(torch, g, m, n_seg, n_pad):
    """Sorted uniform keys of m - n_pad rows over n_seg segments, then
    n_pad pad rows (key n_seg)."""
    keys = torch.randint(0, n_seg, (m - n_pad,), generator=g,
                         device=g.device)
    return torch.cat([keys.sort().values,
                      torch.full((n_pad,), n_seg, device=g.device)]).int()


def compare_kernels(torch, dev, report, card, baseline=None):
    """Phase 2: each kernel against its plain version at main-path
    shapes. Fills report[name] with max_abs_err, ms, plain_ms,
    library_ms and the bound; with a baseline, the time of K8's
    interface, of K1's stream entry and of K3 there too (baseline_ms,
    timed in turns with this checkout's)."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob

    g = torch.Generator(device=dev).manual_seed(0)

    def grid(interp):
        return hg.HashGridConfig.from_max_resolution(
            4096, n_levels=16, n_features=2, log2_hashmap_size=19,
            interp=interp)

    # encode: 2^20 points, L16 F2 T2^19, table U(-1,1); tet bit for bit
    # (the plain version's corner order and rounding), cube <= 1e-5
    n = 1 << 20
    x = torch.rand((n, 3), generator=g, device=dev)
    for interp in ("tet", "cube"):
        cfg = grid(interp)
        table = torch.rand((cfg.total_entries, 2), generator=g,
                           device=dev) * 2 - 1
        got = hg.encode_kernel(table, x, cfg)
        want = hg.encode_plain(table, x, cfg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: hg.encode_kernel(table, x, cfg))
        plain_ms = cuda_ms(lambda: hg.encode_plain(table, x, cfg), iters=5)
        b = encode_bound(torch, x, cfg)
        print(f"encode {interp}: {n} uniform points, {cfg.total_entries} "
              f"rows ({cfg.total_entries * 8 / 1e6:.1f} MB): max_abs_err "
              f"{err} (limit {0.0 if interp == 'tet' else 1e-5}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(err == 0.0 if interp == "tet" else err <= 1e-5,
              f"encode {interp} disagrees: {err}")
        entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, **b)
        if interp == "tet":  # the trainer default
            report["hashgrid_encode"] = entry
        else:
            report["hashgrid_encode"]["cube"] = entry
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
    b = bound(bits.numel() * bits.element_size() + q * 12 + q, q * 12)
    print(f"occupancy bits: {res}^3 grid, {q} queries: {mismatches} "
          f"mismatches (must be 0); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    check(mismatches == 0, "bit lookup is not bit-exact")
    report["occ_bits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None, **b)

    # segment sum (K3): 2^20 rows x 8 into 8192 segments (1/16 pads,
    # 120 rows a segment); then at the stage-4 pack cap, 163,840 rows
    # (1/8 pads), at 0.6, 2.5 and 8 rows a segment
    m = 1 << 20
    keys = sorted_keys(torch, g, m, 8192, m // 16)
    vals = torch.randn((m, 8), generator=g, device=dev)
    report["segment_sum"] = segment_sum_case(
        torch, "2^20 uniform rows", keys, vals, 8192, card, baseline)
    shapes = report["segment_sum"]["shapes"] = {}
    m, n_pad = 163_840, 20_480
    vals = torch.randn((m, 8), generator=g, device=dev)
    for per in (0.6, 2.5, 8.0):
        n_seg = round((m - n_pad) / per)
        keys = sorted_keys(torch, g, m, n_seg, n_pad)
        shapes[f"{per} rows a segment"] = segment_sum_case(
            torch, f"the pack cap's rows at {per} a segment", keys, vals,
            n_seg, card, baseline)
    del keys, vals

    # fused table gradient (K1): 2^18 points, L16 F2 T2^19, g ~ N(0,1);
    # atomics add in a varying order: limit 1e-5 * max |want|, want the
    # plain version's sum in float64 (an f32 index_add_ adds with atomics
    # too, and its own rounding is of the order of the limit)
    n = 1 << 18
    x = torch.rand((n, 3), generator=g, device=dev)
    for interp in ("tet", "cube"):
        cfg = grid(interp)
        cot = torch.randn((n, cfg.output_dim), generator=g, device=dev)
        got = hg.table_grad_kernel(x, cot, cfg)
        want = hg.table_grad_plain(x, cot.double(), cfg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ms = cuda_ms(lambda: hg.table_grad_kernel(x, cot, cfg))
        plain_ms = cuda_ms(lambda: hg.table_grad_plain(x, cot, cfg), iters=5)
        b = bound(n * 12 + n * cfg.output_dim * 4 + cfg.total_entries * 8,
                  2 * n * cfg.n_levels * cfg.corners * 2)
        print(f"table grad (fused) {interp}: {n} points, "
              f"{n * cfg.n_levels * cfg.corners} contributions into "
              f"{cfg.total_entries} rows: max_abs_err {err}, relative {rel} "
              f"(limit 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(rel <= 1e-5, f"table grad {interp} disagrees: {rel}")
        entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=None, **b)
        if interp == "tet":
            report["hashgrid_encode_bwd"] = entry
            contrib = (x, cot, cfg)
        else:
            report["hashgrid_encode_bwd"]["cube"] = entry
        del got, want

    # K1's stream interface on the same stream: (entry, w*g0, w*g1),
    # M = 16.8M point-major contributions; the same limit against the
    # plain sum in float64
    x, cot, cfg = contrib
    idx, w = hg._corner_indices_weights(x, cfg)
    L, C = cfg.n_levels, cfg.corners
    v = (w.reshape(n, L, C, 1) * cot.reshape(n, L, 1, 2)).reshape(-1, 2)
    idx = idx.reshape(-1).int()
    v0, v1 = v[:, 0].contiguous(), v[:, 1].contiguous()
    del w, v
    pairs = pairs_and_values(torch, "uniform 2^18-point L16 F2 stream",
                             idx, v0, v1, cfg.total_entries, baseline)
    # K1's yardstick: index_add_ of its own contribution stream
    report["hashgrid_encode_bwd"]["library_ms"] = pairs["library_ms"]
    report["table_grad_values"] = dict(pairs.pop("values"), stream=pairs)


def pairs_and_values(torch, label, idx, v0, v1, e, baseline=None):
    """K1's stream entry (the contributions as (entry, v0, v1), int32
    entries) and K8's interface (the same contributions as (row, lane0,
    v0, v1) of the value layout: value id = 2 * entry, int32) against
    their plain versions summed in float64, limit 1e-5 * max |want|;
    their times, their plain versions', the bound, and one index_add_
    of the prepared (entry, [v0, v1]) stream; with a baseline, the other
    checkout's stream entry and interface in turns. Returns K1's stream
    entry's report with K8's under "values"."""
    from quadraturefields_tpu_torch.ops import hashgrid_backward as hb
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    m = idx.shape[0]
    live = int(((v0 != 0) | (v1 != 0)).sum())
    vals = torch.stack([v0, v1], dim=1)
    acc = torch.zeros((e, 2), device=v0.device)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, vals))
    del vals, acc
    flat = idx.long() * 2
    rows, lane0 = (flat >> 7).int(), (flat & 127).int()
    total_values = 2 * e
    del flat
    out = {}
    for name, kernel, plain, args, n_bytes, old in (
        ("K1's stream entry", hs.table_grad_pairs_kernel,
         hs.table_grad_pairs_plain, (idx, v0, v1, e),
         m * 12 + e * 8, baseline and baseline.pairs_fn),
        ("K8's interface", hb.table_grad_values_kernel,
         hb.table_grad_values_plain, (rows, lane0, v0, v1, total_values),
         m * 16 + total_values * 4, baseline and baseline.values_fn),
    ):
        got = kernel(*args)
        want = plain(*as_f64(args))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        del got, want
        ms, res = timed(lambda: kernel(*args), old and (lambda: old(*args)))
        plain_ms = cuda_ms(lambda: plain(*args))
        b = bound(n_bytes, 2 * live)
        print(f"{name} on the {label}: {m} contributions ({live} nonzero) "
              f"into {e} entries: max_abs_err {err}, relative {rel} (limit "
              f"1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_add_ of the prepared stream {lib_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); baseline {res}")
        check(rel <= 1e-5, f"{name} on the {label} disagrees: {rel}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, contributions=m,
                         nonzero_contributions=live, **b, **res)
    return dict(out["K1's stream entry"], values=out["K8's interface"])


def as_f64(args):
    """args with every floating tensor in float64."""
    return [a.double() if hasattr(a, "is_floating_point")
            and a.is_floating_point() else a for a in args]


def knots_faces_ties(torch, cfg, g, dev):
    """Points where the cell math's branches decide, a few per row: the
    grid knots of every level (pos = x * scale + 0.5 an integer: frac 0
    on every axis, all three ranks tied), the upper faces (x = 1 on some
    axes: the cell clips to n_axis - 1 and frac to 1) and exact ties of
    two or three coordinates (fx == fy, fx == fz, fy == fz, all three)
    at every level. tests/test_torch_kernels.py uses it too."""
    knots = [((torch.randint(1, r, (64, 3), generator=g, device=dev)
               .double() - 0.5) / s).float()
             for s, r in zip(cfg.level_scales, cfg.level_resolutions)]
    faces = torch.rand((96, 3), generator=g, device=dev)
    faces[torch.arange(96), torch.arange(96) % 3] = 1.0
    faces[::4] = 1.0
    a = torch.rand((32, 1), generator=g, device=dev)
    b = torch.rand((32, 1), generator=g, device=dev)
    ties = torch.cat([torch.cat([a, a, b], 1), torch.cat([a, b, a], 1),
                      torch.cat([b, a, a], 1), torch.cat([a, a, a], 1)])
    return torch.cat([*knots, faces, ties]).contiguous()


def compare_cell_kernels(torch, dev, report, baseline=None):
    """Phase 2, the cell table gradients, on 2^20 uniform points x and a
    cotangent g [N, L*F] ~ N(0, 1) through the cell grid of
    run_nerfsynthetic_tpu_fast.sh (L8 F4, 2^16 rows a hashed level:
    E = 439,472 rows of 32 floats, M = 8,388,608 (point, level) pairs):
    K7 fused from (x, g) and from its stream; K5 fused from (x, g), tet
    and cube with f32 products and tet with bf16sim, beside the route it
    replaced (the [M, 8F] rows built by _cell_indices_weights, then K5's
    stream entry), and K5's stream entry alone; K6 fused from (x, g),
    beside the route it replaced (the lo/hi pair streams, then K6's
    stream entry), and K6's stream entry alone, and K6 fused on grid
    knots, upper faces and rank ties; K7 and K5 (tet f32) also on the
    L16 F2 cell grid (E = 903,456, M = 16.8M). Reference: the plain
    version summed in float64 on the same inputs, limit 1e-5 * max
    |want| (the atomics add in a varying order). library_ms: one
    index_add_ of the prepared [M, 8F] f32 contribution rows into
    [E, 8F]. With a baseline, its K6 route is timed in turns beside the
    fused K6."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    x = torch.rand((n, 3), generator=g, device=dev)

    def run(label, kernel, plain, args, e, lib, n_bytes, n_ops, old=None):
        got = kernel(*args)
        want = plain(*as_f64(args))
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        rel = err / scale
        del got, want
        ms, res = timed(lambda: kernel(*args), old)
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        lib_ms = cuda_ms(lib)
        b = bound(n_bytes, n_ops)
        print(f"{label}: {n * L} contributions into {e} rows: max_abs_err "
              f"{err}, relative {rel} (limit 1e-5); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ of "
              f"the [M, 8F] rows {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} "
              f"ms ({b['bound_by']}); baseline {res}")
        check(rel <= 1e-5, f"{label} disagrees: {rel}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, **b, **res)

    results, rows_x = {}, {}
    for L, F in ((8, 4), (16, 2)):
        cfg = hg.HashGridConfig.from_max_resolution(
            4096, n_levels=L, n_features=F, log2_hashmap_size=16,
            interp="tet", layout="cell", grad_payload="bf16factor")
        e, m = cfg.total_entries, n * L
        check(e == {4: 439_472, 2: 903_456}[F], f"cell grid has {e} rows")
        cot = torch.randn((n, L * F), generator=g, device=dev)
        idx, wk, s1, s2 = hg._cell_tet_levels(x, cfg)
        stream = (idx.reshape(-1), wk.reshape(m, 4), s1.reshape(-1),
                  s2.reshape(-1), cot.reshape(m, F), e)
        del idx, wk, s1, s2
        rows = hs.factor_rows(*stream[1:5])
        acc = torch.zeros((e, 8 * F), device=dev)

        def lib():
            acc.index_add_(0, stream[0], rows)

        out_bytes = e * 8 * F * 4
        # fused: x, g and the output once; the stream entry: idx int64,
        # wk, s1, s2 int32, g and the output; a multiply and an add for
        # each of the 4 x F products
        fused = run(f"cell factor grad (K7 fused) L{L} F{F}",
                    hg.tet_factor_grad_x_kernel, hg.tet_factor_grad_x_plain,
                    (x, cot, cfg), e, lib, n * 12 + m * F * 4 + out_bytes,
                    m * 8 * F)
        fused["stream"] = run(
            f"cell factor grad (K7 stream entry) L{L} F{F}",
            hs.tet_factor_grad_kernel, hs.tet_factor_grad_plain, stream,
            e, lib, m * (8 + 16 + 8 + 4 * F) + out_bytes, m * 8 * F)
        results[F] = fused
        del rows, acc, stream

        # K5 fused: the f32 rows route's interpolations and payloads
        variants = (("tet", "f32"), ("cube", "f32"), ("tet", "bf16sim"))
        for interp, payload in variants[:3 if F == 4 else 1]:
            rcfg = dataclasses.replace(cfg, interp=interp,
                                       grad_payload=payload)
            corners = 4 if interp == "tet" else 8
            ridx, w8 = hg._cell_indices_weights(x, rcfg)
            ridx = ridx.reshape(-1)
            vals = (w8.reshape(m, 8, 1)
                    * cot.reshape(m, F)[:, None, :]).reshape(m, 8 * F)
            del w8
            if payload == "bf16sim":
                vals = vals.to(torch.bfloat16).to(torch.float32)
            acc = torch.zeros((e, 8 * F), device=dev)
            label = f"cell row grad (K5 fused) {interp} {payload} L{L} F{F}"
            entry = run(
                label, hg.cell_row_grad_x_kernel, hg.cell_row_grad_x_plain,
                (x, cot, rcfg), e, lambda: acc.index_add_(0, ridx, vals),
                n * 12 + m * F * 4 + out_bytes, m * 2 * corners * F)
            # the route it replaced, with this checkout's stream entry
            entry["route_ms"] = cuda_ms(
                lambda: rows_route(x, cot, rcfg, hs.row_grad_kernel), iters=5)
            print(f"{label}: the route it replaced (_cell_indices_weights, "
                  f"the [M, 8F] rows, K5's stream entry) "
                  f"{entry['route_ms']:.4f} ms")
            if (interp, payload) == ("tet", "f32") and F == 4:
                # K5's stream entry alone, on the same rows
                entry["stream"] = run(
                    f"cell row grad (K5 stream entry) L{L} F{F}",
                    hs.row_grad_kernel, hs.row_grad_plain, (ridx, vals, e),
                    e, lambda: acc.index_add_(0, ridx, vals),
                    m * (8 + 32 * F) + out_bytes, m * 8 * F)
            rows_x[(interp, payload, F)] = entry
            del ridx, vals, acc
        if F == 4:
            pcfg = dataclasses.replace(cfg, grad_payload="bf16pair")
            idx, w8 = hg._cell_indices_weights(x, pcfg)
            idx, w8 = idx.reshape(-1), w8.reshape(m, 8, 1)
            cot2 = cot.reshape(m, F)
            lo = (w8 * cot2[:, None, 0::2]).reshape(m, 4 * F)
            hi = (w8 * cot2[:, None, 1::2]).reshape(m, 4 * F)
            del w8, cot2
            prows = hs.pair_rows(lo, hi)
            acc = torch.zeros((e, 8 * F), device=dev)

            def lib():
                acc.index_add_(0, idx, prows)

            label = f"cell pair grad (K6 fused) tet L{L} F{F}"
            entry = run(
                label, hg.cell_pair_grad_x_kernel, hg.cell_pair_grad_x_plain,
                (x, cot, pcfg), e, lib, n * 12 + m * F * 4 + out_bytes,
                m * 2 * 4 * F,
                baseline and (lambda: baseline.pair_route_fn(x, cot, pcfg)))
            entry["route_ms"] = cuda_ms(
                lambda: pair_route(x, cot, pcfg, hs.pair_grad_kernel),
                iters=5)
            print(f"{label}: the route it replaced (_cell_indices_weights, "
                  f"the lo/hi streams, K6's stream entry) "
                  f"{entry['route_ms']:.4f} ms")
            # K6's stream entry alone, on the same pair streams
            entry["stream"] = run(
                f"cell pair grad (K6 stream entry) L{L} F{F}",
                hs.pair_grad_kernel, hs.pair_grad_plain, (idx, lo, hi, e),
                e, lib, m * (8 + 2 * 16 * F) + out_bytes, m * 8 * F)
            del lo, hi, prows, idx, acc
            # the in-kernel cell math where it branches, few points a row
            edges = knots_faces_ties(torch, pcfg, g, dev)
            ecot = torch.randn((edges.shape[0], L * F), generator=g,
                               device=dev)
            got = hg.cell_pair_grad_x_kernel(edges, ecot, pcfg)
            want = hg.cell_pair_grad_x_plain(edges, ecot.double(), pcfg)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            print(f"{label} on {edges.shape[0]} grid knots, upper-face "
                  f"points and rank ties: max_abs_err {err}, relative {rel} "
                  f"(limit 1e-5)")
            check(rel <= 1e-5, f"{label} on knots and faces disagrees: {rel}")
            entry["edges_max_abs_err"] = err
            report["cell_pair_grad_x"] = entry
            del edges, ecot, got, want
        del cot
    report["cell_factor_grad"] = dict(results[4], at_f2=results[2])
    report["cell_row_grad_x"] = dict(
        rows_x[("tet", "f32", 4)], cube=rows_x[("cube", "f32", 4)],
        bf16sim=rows_x[("tet", "bf16sim", 4)], at_f2=rows_x[("tet", "f32", 2)])


def fixture_occupancy(trainer):
    """The fixture sphere's occupancy on the trainer's grid (4.1% of the
    128^3 cells), filled as bench.py fills the JAX grid."""
    import torch

    from quadraturefields_tpu_torch.data.fixture import FixtureScene

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


def plain_path():
    """Every kernel of the paths patched with its plain version."""
    from contextlib import ExitStack

    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob

    stack = ExitStack()
    for mod, name, plain in (
        (hg, "encode_kernel", hg.encode_plain),
        (hg, "table_grad_kernel", hg.table_grad_plain),
        (ob, "lookup_bits_kernel", ob.lookup_bits_plain),
        (hs, "segment_sum_kernel", hs.segment_sum_plain),
        (hs, "row_grad_kernel", hs.row_grad_plain),
        (hs, "pair_grad_kernel", hs.pair_grad_plain),
        (hs, "tet_factor_grad_kernel", hs.tet_factor_grad_plain),
        (hg, "tet_factor_grad_x_kernel", hg.tet_factor_grad_x_plain),
        (hg, "cell_row_grad_x_kernel", hg.cell_row_grad_x_plain),
        (hg, "cell_pair_grad_x_kernel", hg.cell_pair_grad_x_plain),
    ):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def count_launches(kernels, fn):
    """fn() with every kernel's count set to 0 just before; returns
    (fn's result, {name: launches})."""
    import torch

    for k in kernels:
        k.launches = 0
    result = fn()
    torch.cuda.synchronize()
    return result, {k.name: k.launches for k in kernels}


def render_slice(torch, kernels, card, views, captured, profile: bool):
    """Phase 3: the stage-1 evaluation path at full width. The encode's
    and K3's arguments in the eval chunk with the most valid samples land
    in captured["eval_chunk"] and ["eval_composite"], their count in
    captured["eval_chunk_valid"]."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.train.stage1_ngp import (
        Stage1Config,
        Stage1Trainer,
    )

    cfg = Stage1Config(eval_renderer="oneshot")
    trainer = Stage1Trainer(cfg, train_dataset=views, test_dataset=views)
    trainer.occ_state = fixture_occupancy(trainer)
    occ_frac = float(trainer.occ_state.binaries.float().mean())
    print(f"model: {trainer.ngp_cfg}")
    print(f"render: {trainer.rcfg}; occupied cells {occ_frac:.4f}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, launches = count_launches(kernels, trainer.evaluate)
    first_s = time.perf_counter() - t0
    print(f"evaluate (one-shot, first call): {metrics} in {first_s:.3f} s; "
          f"kernel launches {launches}")
    for name in ("hashgrid_encode", "occ_bits", "segment_sum"):
        check(launches[name] > 0, f"the eval path never launched {name}")
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
    samples, best = 0, (0, None)
    with torch.no_grad():
        for i in range(len(views)):
            rays = views.fetch_eval_view(i)["rays"]
            o = torch.as_tensor(rays.origins, device=trainer.device)
            d = torch.as_tensor(rays.viewdirs, device=trainer.device)
            for s in range(0, o.shape[0], cfg.eval_chunk):
                chunk = {}
                with capture(hg, "encode_kernel", chunk, "args"), \
                        capture(hs, "segment_sum_kernel", chunk, "k3"):
                    rgb, _, _, nv = trainer._eval_render_impl(
                        trainer.params, trainer.occ_state,
                        o[s:s + cfg.eval_chunk], d[s:s + cfg.eval_chunk])
                nv = int(nv)
                check(nv <= budget, f"chunk truncated: {nv} > {budget}")
                check(bool(torch.isfinite(rgb).all()), "non-finite rgb")
                samples += nv
                if nv > best[0]:
                    best = (nv, chunk["args"], chunk["k3"])
    check(samples > 0, "no valid samples")
    # the encode's arguments in the chunk with the most valid samples,
    # which come first (the budget's padding follows them)
    captured["eval_chunk"], captured["eval_chunk_valid"] = best[1], best[0]
    captured["eval_composite"] = best[2]
    print(f"eval chunk captured for phase 6: {best[0]} valid samples")
    n_rays = len(views) * views.HEIGHT * views.WIDTH
    print(f"stage-1 one-shot eval, {n_rays} rays, {samples} samples: "
          f"{eval_s:.4f} s -> {n_rays / eval_s:.1f} rays/s, "
          f"{samples / eval_s:.1f} samples/s [{card}]")

    # the kernel path against the plain path, on the card, same view
    data = views.fetch_eval_view(0)
    rgb_kernel = trainer.render_view(data)
    before = {k.name: k.launches for k in kernels}
    with plain_path():
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
    trainer.cfg.eval_renderer = "oneshot"
    if profile:
        profile_steps(torch, trainer.evaluate, card, n_steps=2,
                      label="evaluate (one-shot, 4 views)")
    return launches


def step_grads(torch, params, loss_fn):
    """Loss and every leaf's gradient of the params tree `params` (zeros
    where the loss does not reach) of one training step, loss_fn() ->
    the loss."""
    from quadraturefields_tpu_torch.train.stage1_ngp import _leaves

    leaves = _leaves(params)
    for p in leaves:
        p.grad = None
    loss = loss_fn()
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def ngp_step_grads(torch, trainer, batch):
    """step_grads of one stage-1 step on `batch` (origins, viewdirs,
    pixels, bkgd, t_jitter)."""
    return step_grads(torch, trainer.params, lambda: trainer._loss_fn(
        trainer.params, trainer.occ_state, *batch)[0])


def field_step_grads(torch, trainer, batch):
    """step_grads of one stage-2 step on `batch`, in the field's
    parameters (the decoder's output bias, which the loss does not
    reach, gets zeros)."""
    return step_grads(torch, trainer.field_params, lambda: trainer._loss_fn(
        trainer.field_params, *batch)[0])


def train_slice(torch, kernels, card, views, name, cfg, must_launch,
                table_grad, captured, profile: bool):
    """Phases 4 and 5: Stage1Trainer.train at `cfg` for 300 steps (the
    path `name`). Every kernel named in `must_launch` must launch in the
    run; `table_grad` names the table-gradient kernel whose output
    compare_step holds against a float64 sum. The arguments of the
    encode and of its table gradient (corner layout), of the fused cell
    table gradients (K7, K5, K6) and of K3 (the composite) in one
    training step land in captured["train_step"], ["corner_grad_step"],
    ["cell_step"], ["cell_f32_step"], ["cell_bf16pair_step"] and
    [name + "_composite"]. Returns (launches, training steps)."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.train.stage1_ngp import Stage1Trainer

    views.update_num_rays(cfg.init_batch_size)
    trainer = Stage1Trainer(cfg, train_dataset=views, test_dataset=views)
    budget = trainer.rcfg.max_samples_total
    record = []  # (end time, rays, samples, loss) per step
    one_step = trainer.train_one_step

    def timed_step():
        rays = views.num_rays
        loss, aux = one_step()
        loss = float(loss)  # waits for the step
        record.append((time.perf_counter(), rays,
                       min(int(aux["num_valid"]), budget), loss))
        return loss, aux

    trainer.train_one_step = timed_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, launches = count_launches(kernels, trainer.train)
    train_s = time.perf_counter() - t0
    losses = [r[3] for r in record]
    occ_frac = float(trainer.occ_state.binaries.float().mean())
    print(f"{name}: {len(record)} steps + final evaluate in {train_s:.2f} s; "
          f"eval {metrics}; occupied cells {occ_frac:.4f}; kernel "
          f"launches {launches}")
    for kernel_name in must_launch:
        check(launches[kernel_name] > 0,
              f"the training path never launched {kernel_name}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"loss: mean of the first 20 steps {first:.6f}, of the last 20 "
          f"{last:.6f} (must be < half)")
    check(last < 0.5 * first, "the training loss did not halve")
    check(metrics["psnr"] > 20.0, f"eval PSNR {metrics['psnr']} <= 20 dB")
    check(occ_frac < 0.5, f"occupied share {occ_frac} >= 0.5")

    # steady state over steps 150-300 (step 100 turned the dynamic
    # batch on, step 256 ended the occupancy warm-up)
    t_a, t_b = record[150][0], record[300][0]
    rays = sum(r[1] for r in record[151:301])
    samples = sum(r[2] for r in record[151:301])
    steady_s = t_b - t_a
    ms_step = steady_s / 150 * 1e3
    print(f"stage-1 training ({name}: {cfg.layout} layout, "
          f"{cfg.grad_payload} table gradient), steps 150-300: "
          f"{ms_step:.3f} ms/step, "
          f"{rays / steady_s:.1f} rays/s, {samples / steady_s:.1f} "
          f"samples/s (valid samples, at most {budget} a step); batch now "
          f"{views.num_rays} rays [{card}]")
    trainer.train_one_step = one_step

    # one step on the kernel path against the plain path, on the card,
    # with the trained weights, one batch and one stratified jitter
    data = views.fetch_train_batch()
    dev = trainer.device
    batch = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
             for a in (data["rays"].origins, data["rays"].viewdirs,
                       data["pixels"], data["color_bkgd"])]
    batch.append(torch.rand((batch[0].shape[0],), generator=trainer.generator,
                            device=dev))
    with capture(hg, "encode_kernel", captured, "train_step"), \
            capture(hg, "table_grad_kernel", captured, "corner_grad_step"), \
            capture(hg, "tet_factor_grad_x_kernel", captured, "cell_step"), \
            capture(hg, "cell_row_grad_x_kernel", captured, "cell_f32_step"), \
            capture(hg, "cell_pair_grad_x_kernel", captured,
                    "cell_bf16pair_step"), \
            capture(hs, "segment_sum_kernel", captured, f"{name}_composite"):
        ngp_step_grads(torch, trainer, batch)
    for dtype in ("float32", "bfloat16"):
        compare_step(torch, trainer, kernels, batch, dtype, table_grad)

    if profile:
        profile_steps(torch, trainer.train_one_step, card,
                      label=f"training step ({name})")
    return launches, len(record)


def compare_step(torch, trainer, kernels, batch, compute_dtype, table_grad):
    """Loss and gradients of one training step, kernel path against
    plain path, with the MLPs in `compute_dtype`. The loss must agree
    within 1e-5 relative. The table-gradient kernel's output in the
    kernel-path step (`table_grad` = (module, kernel function name, its
    plain version)) must lie within 1e-5 * max |want| of the plain
    version summed in float64 on the inputs it was given (the atomics
    add in a varying order). Every gradient must lie within a limit
    times its max |grad| of the plain path's: in float32 1e-4; in
    bfloat16 8 times the plain path's own spread (the largest such error
    between its first step and three more on the same inputs), and at
    least 2^-8, bf16's unit roundoff. The plain path is not
    deterministic on the card: its index_add_ composite adds with
    atomics, and in bf16 the operand casts turn those f32 ulps into bf16
    rounding flips. A cell table gradient with a bf16 payload rounds
    every contribution to bf16, so its leaf takes the bf16 rule (with
    its own spread) in float32 too."""
    mod, name, plain = table_grad
    saved = trainer.ngp_cfg
    trainer.ngp_cfg = dataclasses.replace(saved, compute_dtype=compute_dtype)
    table_calls = []
    kernel = getattr(mod, name)

    def recording(*args):
        out = kernel(*args)
        table_calls.append((args, out))
        return out

    try:
        with mock.patch.object(mod, name, recording):
            loss_k, grads_k = ngp_step_grads(torch, trainer, batch)
        before = {k.name: k.launches for k in kernels}
        with plain_path():
            loss_p, grads_p = ngp_step_grads(torch, trainer, batch)
            reruns = [ngp_step_grads(torch, trainer, batch)[1]
                      for _ in range(3)]
        check({k.name: k.launches for k in kernels} == before,
              "the plain-path step launched a kernel")
    finally:
        trainer.ngp_cfg = saved

    def rel(a, b):
        return [float((x - y).abs().max() / y.abs().max())
                for x, y in zip(a, b)]

    check(len(table_calls) == 1, f"{len(table_calls)} calls of {name}")
    args, got = table_calls[0]
    want = plain(*as_f64(args))
    table_err = float((got - want).abs().max() / want.abs().max())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = rel(grads_k, grads_p)
    spreads = [max(leaf) for leaf in zip(*(rel(r, grads_p) for r in reruns))]
    spread = max(spreads)
    if compute_dtype == "float32":
        limits = [1e-4] * len(errs)
        ngp = trainer.ngp_cfg
        if ngp.layout == "cell" and ngp.grad_payload != "f32":
            limits[0] = max(8 * spreads[0], 2**-8)
    else:
        limits = [max(8 * spread, 2**-8)] * len(errs)
    print(f"one training step ({compute_dtype} MLPs), kernel path vs plain "
          f"path: loss {loss_k} vs {loss_p} (relative {loss_rel}, limit "
          f"1e-5); {name} output vs float64 plain sum, same inputs: "
          f"{table_err} of max (limit 1e-5); gradient error / max |grad| "
          f"per leaf (table first) {errs} (limits {limits}); plain path vs "
          f"itself, largest of three reruns per leaf {spreads}")
    check(loss_rel <= 1e-5, f"kernel-path loss disagrees: {loss_rel}")
    check(table_err <= 1e-5, f"{name} in the step disagrees: {table_err}")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"kernel-path gradients disagree: {errs}")


# kernel-name patterns of the profile's classes, first match wins
PROFILE_CLASSES = (
    ("cell table gradient (K5-K7)", ("cell_",)),
    ("encode backward (K1 fused)", ("encode_bwd_kernel",)),
    ("encode forward (K2)", ("encode_tet_kernel", "encode_cube_kernel")),
    ("occupancy bits (K4)", ("bits",)),
    ("segment sum (K3)", ("segment_sum",)),
    ("MLP GEMMs (fwd + bwd)", ("gemm", "xmma", "cutlass", "sm90", "Kernel2")),
    ("Adam (multi-tensor)", ("multi_tensor", "foreach", "adam")),
    ("compaction (nonzero / cub)", ("nonzero", "cub::", "select", "flag")),
    ("copies and dtype casts (bf16 MLP operands)", ("copy",)),
    ("gathers / scatters / index_add_", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("elementwise (scans, composite, activations)",
     ("elementwise", "cat", "fill", "where", "pow", "clamp")),
)
# host ops that wait for the device: the march's nonzero compaction and
# the scalar reads (.item(), int(tensor))
SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense")


def profile_steps(torch, step, card, n_steps=10, label="step"):
    """torch.profiler over n_steps calls of step(): device time by kernel
    class (each hand-written kernel its own class: its in-situ time on
    this path), the device busy share, the top kernels, and the ATen ops
    whose own kernels take the most device time, with their input
    shapes. Times are per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel, sync_ms, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        if evt.key in SYNC_OPS:
            sync_ms[evt.key] = evt.cpu_time_total / 1e3
        # a user annotation (Optimizer.step#Adam.step) also shows as a
        # device event; its kernels are counted on their own
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e3)
            n_kernels += evt.count
    total = sum(by_kernel.values())
    classes = {}
    for name, ms in by_kernel.items():
        cls = next((c for c, pats in PROFILE_CLASSES
                    if any(p.lower() in name.lower() for p in pats)),
                   "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    print(f"profile of {label}: {n_steps} calls, {wall * 1e3 / n_steps:.3f} "
          f"ms/call wall (profiled), device kernel time "
          f"{total / n_steps:.3f} ms/call in {n_kernels / n_steps:.0f} "
          f"kernels, busy share {total / 1e3 / wall:.3f} [{card}]")
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms / n_steps:.4f} ms/call "
              f"({100 * ms / max(total, 1e-9):.1f}%)")
    print("  host time in ops that wait for the device (ms/call): "
          + ", ".join(f"{k} {v / n_steps:.3f}" for k, v in sync_ms.items()))
    print("  top kernels (ms/call):")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {ms / n_steps:.4f}  {name[:110]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    print("  top ATen ops by their own device time (ms/call, calls/call, "
          "input shapes):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3 / n_steps:.4f}  "
              f"{e.count / n_steps:.0f}x {e.key} {str(e.input_shapes)[:90]}")


# phase 7's quality gates, set from a CPU run of both packages at
# tests/test_pipeline_full.py's settings (tests/test_torch_stage2.py
# test_stage2_quality_gates_on_the_cpu: stage 1 220 steps, stage 2 120
# steps, field log2_T 14, a 48^3 export; each package from its own
# stage-1 run). Last-20 / first-20 mean loss: JAX 0.5658, the port
# 0.4647; the gate is 0.8, a margin of 0.23 over JAX's. The mean
# exported |grad| over the sphere's shell against its mean outside
# every sample: JAX 1.465, the port 1.242; against its mean deep inside
# the sphere: JAX 1.925, the port 1.967. JAX reaches 2 on neither, so
# each gate is half of JAX's: 0.73 and 0.96.
FIELD_LOSS_GATE = 0.8

# phase 8's stage-3 arguments: run_nerfsynthetic_mc.sh's (sigma,
# include_grad, omega, thres, axis, combine, grad_thres, density_thres),
# then downsample_mesh's vx. A CPU run of both packages at
# tests/test_pipeline_full.py's settings (tests/test_torch_stage4.py
# test_stage34_quality_gates_on_the_cpu) found a surface on the fixture
# with them: JAX 91,934 quadrature faces (92,234 with the density
# surface), the port 103,814 (103,982), so the script's thresholds are
# kept. The mesh's median radius in world units must lie in
# STAGE3_RADIUS, the pipeline test's bounds (JAX 0.744, the port 0.768).
# The stage-4 eval PSNR gate is JAX's floor of 14 dB
# (test_pipeline_full.py:151-165); that CPU run reached JAX 17.757 dB,
# the port 17.542 dB. The frozen steps leave the render where the mesh
# puts it (18.91-19.13 dB at step 200 on the H100, three smoke runs)
# and the 100 joint steps lift it by 11.45-12.92 dB (to 30.36-32.05),
# so the final evaluation must also gain FINETUNE_GAIN_GATE over the
# one at step 200: half the least gain seen, which 100 joint steps that
# did nothing (an rf never updated) cannot pass.
STAGE3_ARGS = ("100.0", "True", "100", "0", "0", "True", "0.01", "10.0",
               "150")
STAGE3_RADIUS = (0.3, 0.8)
FINETUNE_PSNR_GATE = 14.0
FINETUNE_GAIN_GATE = 5.5
FIELD_SHELL_GATE = 0.73
FIELD_INTERIOR_GATE = 0.96


def sphere_shell_ratios(grads_valid, field_scale=0.5):
    """(mean exported |grad| over the cells at field radius 0.13 < r <
    0.20, where the fixture sphere's surface is (world radius 0.5, field
    units world / 3), over its mean at r > 0.3, outside every sample; and
    over its mean at r < 0.1, deep inside the sphere, where both the
    forward and the reverse weights have died out). Cell centres of the
    2x-supersampled lattice linspace(-1, 1) * field_scale, pooled in
    pairs."""
    n = grads_valid.shape[0]
    lin = np.linspace(-1.0, 1.0, 2 * n) * field_scale
    c = (lin[0::2] + lin[1::2]) / 2
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    g = grads_valid.astype(np.float32)
    shell = g[(r > 0.13) & (r < 0.20)].mean()
    return float(shell / g[r > 0.3].mean()), float(shell / g[r < 0.1].mean())


def compare_field_step(torch, trainer, kernels, batch):
    """One stage-2 step, kernel path against plain path (every kernel
    patched with its plain version), f32 throughout the field: the loss
    within 1e-5 relative; the K1 output of the kernel-path step within
    1e-5 * max |want| of the plain version summed in float64 on the
    inputs it was given (the atomics add in a varying order); every
    field gradient, table and decoder, within 1e-4 of its max of the
    plain path's."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg

    calls = []
    kernel = hg.table_grad_kernel

    def recording(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    with mock.patch.object(hg, "table_grad_kernel", recording):
        loss_k, grads_k = field_step_grads(torch, trainer, batch)
    before = {k.name: k.launches for k in kernels}
    with plain_path():
        loss_p, grads_p = field_step_grads(torch, trainer, batch)
    check({k.name: k.launches for k in kernels} == before,
          "the plain-path stage-2 step launched a kernel")
    check(len(calls) == 1, f"{len(calls)} calls of K1 in one stage-2 step")
    args, got = calls[0]
    want = hg.table_grad_plain(*as_f64(args))
    k1_err = float((got - want).abs().max() / want.abs().max())
    del want, got, calls
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = [float((a - b).abs().max() / b.abs().max()) if b.abs().max() > 0
            else float(a.abs().max()) for a, b in zip(grads_k, grads_p)]
    print(f"one stage-2 step, kernel path vs plain path: loss {loss_k} vs "
          f"{loss_p} (relative {loss_rel}, limit 1e-5); K1 output vs "
          f"float64 plain sum, same inputs: {k1_err} of max (limit 1e-5); "
          f"gradient error / max |grad| per leaf (table first, the output "
          f"bias's gradient is 0) {errs} (limit 1e-4)")
    check(loss_rel <= 1e-5, f"kernel-path stage-2 loss disagrees: {loss_rel}")
    check(k1_err <= 1e-5, f"K1 in the stage-2 step disagrees: {k1_err}")
    check(all(e <= 1e-4 for e in errs),
          f"kernel-path stage-2 gradients disagree: {errs}")
    return dict(loss_rel=loss_rel, k1_rel=k1_err, grad_rel=errs)


def field_slice(torch, kernels, card, views, captured, report,
                profile: bool, export_size: int = 0):
    """Phase 7: stage 2 at run_nerfsynthetic_field.sh's widths. A
    stage-1 feeder (run_nerfsynthetic.sh's model flags, 300 steps at
    2^18) is saved with Stage1Trainer.save; Stage2Trainer reads it and
    runs train() for 300 steps with the 256^3 export. K2, K4, K3 and the
    fused K1 must launch, K1 once a step; no cell table gradient and no
    stream entry. Gates: finite losses that fall, the artifact contract,
    the fixture sphere in the exported |grad|. Then one step on the
    kernel path against the plain path, and (for phase 6) the field
    encode's, K1's and K3's arguments of that step. Fills
    report["train_field"] and returns the path's launches."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.train.stage1_ngp import (
        Stage1Config,
        Stage1Trainer,
        _leaves,
    )
    from quadraturefields_tpu_torch.train.stage2_field import (
        Stage2Config,
        Stage2Trainer,
    )

    root = tempfile.mkdtemp(prefix="qf_smoke_")
    # the feeder: run_nerfsynthetic.sh's --num_lobes 0 --num_layers 2
    # --scale 1.5 --reg_type occ --occ_thres 0.01, corner L16 F2 T2^19,
    # 300 steps at 2^18 samples
    c1 = Stage1Config(root=root, scene="fixture", max_steps=300,
                      num_lobes=0, num_layers=2, scale=1.5, reg_type="occ",
                      occ_thres=0.01, ckpt_every=10**9, log_every=10**9)
    views.update_num_rays(c1.init_batch_size)
    t1 = Stage1Trainer(c1, train_dataset=views, test_dataset=views)
    t0 = time.perf_counter()
    while t1.step <= c1.max_steps:
        loss, _ = t1.train_one_step()
    ckpt = os.path.join(root, "ngp.pt")
    t1.save(ckpt)
    feeder_occ = float(t1.occ_state.binaries.float().mean())
    print(f"stage-1 feeder: {c1.max_steps + 1} steps in "
          f"{time.perf_counter() - t0:.2f} s, last loss {float(loss):.6f}, "
          f"occupied cells {feeder_occ:.4f}; saved {ckpt}")
    del t1

    # stage 2: --num_lobes 0 --log2_hashmap_size 19
    # --field_log2_hashmap_size 30 --batch_size 18 --scale 1.5, 300 of its
    # 25,000 steps, a 256^3 export (the CLI's default is 1024^3)
    cfg = Stage2Config(root=root, scene="fixture", ckpt_path=ckpt,
                       num_lobes=0, log2_hashmap_size=19,
                       field_log2_hashmap_size=30, batch_size_log2=18,
                       scale=1.5, grid_export_size=256, max_steps=300,
                       log_every=50, ckpt_every=10**9)
    views.update_num_rays(cfg.init_batch_size)
    trainer = Stage2Trainer(cfg, train_dataset=views)
    fgrid = trainer.field_cfg.hashgrid
    e, budget = fgrid.total_entries, trainer.rcfg.max_samples_total
    check(e == 39_601_112, f"the field table has {e} rows")
    print(f"field: {trainer.field_cfg}; table {e} rows x "
          f"{fgrid.n_features} f32 ({e * fgrid.n_features * 4 / 1e6:.1f} MB)")

    record, export_s = [], []
    one_step, export = trainer.train_one_step, trainer.export_artifacts

    def timed_step():
        rays = views.num_rays
        loss, nv, mse = one_step()
        loss = float(loss)  # waits for the step
        record.append((time.perf_counter(), rays, min(nv, budget), loss))
        return loss, nv, mse

    def timed_export(out_dir):
        torch.cuda.synchronize()
        t = time.perf_counter()
        export(out_dir)
        torch.cuda.synchronize()
        export_s.append(time.perf_counter() - t)

    trainer.train_one_step, trainer.export_artifacts = timed_step, timed_export
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = count_launches(kernels, trainer.train)
    train_s = time.perf_counter() - t0
    trainer.train_one_step, trainer.export_artifacts = one_step, export
    n_steps = len(record)
    print(f"train_field: {n_steps} steps + export + checkpoint in "
          f"{train_s:.2f} s; kernel launches {launches}")
    path_kernels = (hg.ENCODE_KERNEL.name, "occ_bits", "segment_sum",
                    hg.ENCODE_BWD_KERNEL.name)
    for name in path_kernels:
        check(launches[name] > 0, f"train_field never launched {name}")
    check(launches[hg.ENCODE_BWD_KERNEL.name] == n_steps,
          f"K1 launched {launches[hg.ENCODE_BWD_KERNEL.name]} times in "
          f"{n_steps} steps")
    others = {k: n for k, n in launches.items() if k not in path_kernels}
    check(not any(others.values()), f"train_field launched {others}")

    losses = [r[3] for r in record]
    check(all(np.isfinite(losses)), "non-finite stage-2 loss")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"stage-2 loss: mean of the first 20 steps {first:.6f}, of the "
          f"last 20 {last:.6f} (ratio {last / first:.4f}, must be < "
          f"{FIELD_LOSS_GATE})")
    check(last < FIELD_LOSS_GATE * first, "the stage-2 loss did not fall")

    out_dir = os.path.join(root, "results", "fixture", "field")
    n = cfg.grid_export_size
    arrays = {}
    for name, dtype, shape in (
        ("binaries.npy", np.bool_, (1,) + (cfg.grid_resolution,) * 3),
        ("grids_valid.npy", np.float32, (n,) * 3),
        ("grads_valid.npy", np.float16, (n,) * 3),
        ("density_grids_valid.npy", np.float16, (n,) * 3),
    ):
        a = np.load(os.path.join(out_dir, name))
        check(a.dtype == dtype and a.shape == shape,
              f"{name}: {a.dtype} {a.shape}, the contract is {dtype} {shape}")
        check(bool(np.isfinite(a.astype(np.float32)).all()),
              f"{name} is not finite")
        arrays[name] = a
    check(os.path.exists(os.path.join(root, "ckpts", "fixture", "field",
                                      "field.pt")), "no stage-2 checkpoint")
    ratio, inner = sphere_shell_ratios(arrays["grads_valid.npy"],
                                       cfg.field_scale)
    print(f"exported |grad|: mean over the sphere shell 0.13 < r < 0.20 "
          f"over its mean at r > 0.3 {ratio:.4f} (must be >= "
          f"{FIELD_SHELL_GATE}), at r < 0.1 {inner:.4f} (must be >= "
          f"{FIELD_INTERIOR_GATE})")
    check(ratio >= FIELD_SHELL_GATE,
          f"the field did not learn the sphere: shell / outside {ratio}")
    check(inner >= FIELD_INTERIOR_GATE,
          f"the field did not learn the sphere: shell / interior {inner}")

    t_a, t_b = record[150][0], record[300][0]
    rays = sum(r[1] for r in record[151:301])
    samples = sum(r[2] for r in record[151:301])
    steady_s = t_b - t_a
    points = (2 * n) ** 3
    out = dict(
        steps=n_steps, ms_per_step=steady_s / 150 * 1e3,
        rays_per_s=rays / steady_s, samples_per_s=samples / steady_s,
        loss_first20=first, loss_last20=last, shell_ratio=ratio,
        shell_over_interior=inner,
        export_s=export_s[0], export_points=2 * points,
        export_points_per_s=2 * points / export_s[0],
        launches=launches, card=card)
    print(f"stage-2 training (train_field), steps 150-300: "
          f"{out['ms_per_step']:.3f} ms/step, {out['rays_per_s']:.1f} "
          f"rays/s, {out['samples_per_s']:.1f} samples/s (valid samples, "
          f"at most {budget} a step); batch now {views.num_rays} rays; "
          f"export {n}^3: {export_s[0]:.3f} s for {points} field and "
          f"{points} density points, {out['export_points_per_s']:.1f} "
          f"points/s [{card}]")

    # one step on the kernel path against the plain path, with the
    # trained weights, one batch and one jitter; the field encode's, K1's
    # and K3's arguments of the kernel-path step go to phase 6
    data = views.fetch_train_batch()
    dev = trainer.device
    batch = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
             for a in (data["rays"].origins, data["rays"].viewdirs,
                       data["pixels"], data["color_bkgd"])]
    batch.append(torch.rand((batch[0].shape[0],), generator=trainer.generator,
                            device=dev))
    with capture(hg, "encode_kernel", captured, "field_step",
                 when=lambda table, x, c: c == fgrid), \
            capture(hg, "table_grad_kernel", captured, "field_grad_step"), \
            capture(hs, "segment_sum_kernel", captured,
                    "train_field_composite"):
        field_step_grads(torch, trainer, batch)
    out["compare"] = compare_field_step(torch, trainer, kernels, batch)

    if export_size:
        # the same trained field and NGP exported at another size
        # (--export N), timed on its own
        trainer.cfg.grid_export_size = export_size
        big = tempfile.mkdtemp(prefix="qf_smoke_export_")
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.export_artifacts(big)
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t
        points = (2 * export_size) ** 3
        grads = np.load(os.path.join(big, "grads_valid.npy"), mmap_mode="r")
        check(grads.shape == (export_size,) * 3 and grads.dtype == np.float16,
              f"the {export_size}^3 export wrote {grads.shape} {grads.dtype}")
        del grads
        out[f"export_{export_size}"] = dict(
            s=big_s, points=2 * points, points_per_s=2 * points / big_s)
        print(f"export {export_size}^3 (the same field): {big_s:.3f} s for "
              f"{points} field and {points} density points, "
              f"{2 * points / big_s:.1f} points/s, the files written "
              f"included [{card}]")

    if profile:
        profile_steps(torch, trainer.train_one_step, card,
                      label="stage-2 step (train_field)")
    # Adam over the field's leaves (the 317 MB table and the decoder),
    # timed alone on zero gradients: p, g, m and v read, p, m and v
    # written at least once
    leaves = _leaves(trainer.field_params)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    n_params = sum(p.numel() for p in leaves)
    out["adam_ms"] = cuda_ms(trainer.optimizer.step, iters=5, warmup=1)
    out["adam_bound_ms"] = bound(7 * 4 * n_params, 0)["bound_ms"]
    print(f"Adam over the field's {n_params} parameters: {out['adam_ms']:.4f}"
          f" ms a step, bound {out['adam_bound_ms']:.4f} ms [{card}]")
    report["train_field"] = out
    del trainer, leaves
    torch.cuda.empty_cache()
    return launches, root, ckpt, big if export_size else None


def stage3_slice(torch, card, field_dir, label):
    """Phase 8's stage 3 on a stage-2 export: the port's marching_cubes
    and downsample_mesh CLIs with STAGE3_ARGS, the wall split into the
    device filters (from the blur's start to the first isosurface,
    which waits for the surface's copy to the host), marching
    tetrahedra, the files written and the decimation. Gates: a
    non-empty mesh whose median radius (world) lies in STAGE3_RADIUS,
    an smp_mesh with fewer vertices, the three files. Returns the
    readings."""
    from quadraturefields_tpu_torch.cli import downsample_mesh as cli_ds
    from quadraturefields_tpu_torch.cli import marching_cubes as cli_mc
    from quadraturefields_tpu_torch.geometry import extract as ex

    marks, spans = {}, {"marching_tets": 0.0, "ply": 0.0, "decimate": 0.0}

    def timed(name, real, first=None):
        def fn(*args, **kw):
            if first and first not in marks:
                marks[first] = time.perf_counter()
            t = time.perf_counter()
            out = real(*args, **kw)
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
            return out
        return fn

    def blur(*args, **kw):
        marks.setdefault("filters_start", time.perf_counter())
        return real_blur(*args, **kw)

    real_blur = ex.gaussian_smooth_3d
    faces = []

    def isosurface(*args, **kw):
        out = real_mt(*args, **kw)
        faces.append(out[1].shape[0])
        return out

    real_mt = ex.marching_tetrahedra
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(ex, "gaussian_smooth_3d", blur), \
            mock.patch.object(ex, "marching_tetrahedra", timed(
                "marching_tets", isosurface, first="filters_end")), \
            mock.patch.object(ex, "save_ply", timed("ply", ex.save_ply)), \
            mock.patch.object(ex, "decimate_vertex_clustering", timed(
                "decimate", ex.decimate_vertex_clustering)):
        mesh = cli_mc.main([field_dir, *STAGE3_ARGS[:8]])
        t1 = time.perf_counter()
        smp = cli_ds.main([os.path.join(field_dir, "mesh.ply"),
                           STAGE3_ARGS[8]])
    t2 = time.perf_counter()
    filters = marks["filters_end"] - marks["filters_start"]
    radius = float(np.median(np.linalg.norm(mesh.vertices * 1.5, axis=1)))
    out = dict(grid=int(np.load(os.path.join(field_dir, "grids_valid.npy"),
                                mmap_mode="r").shape[0]),
               marching_cubes_s=t1 - t0, filters_s=filters,
               marching_tets_s=spans["marching_tets"],
               ply_s=spans["ply"], downsample_s=t2 - t1,
               decimate_s=spans["decimate"],
               quad_faces=faces[0], density_faces=faces[1],
               faces=int(mesh.faces.shape[0]),
               vertices=int(mesh.vertices.shape[0]),
               smp_faces=int(smp.faces.shape[0]),
               smp_vertices=int(smp.vertices.shape[0]),
               median_radius=radius)
    print(f"stage 3 ({label}, {out['grid']}^3 grids, args {STAGE3_ARGS}): "
          f"marching_cubes {out['marching_cubes_s']:.3f} s (device filters "
          f"{filters:.3f} s, marching tetrahedra {spans['marching_tets']:.3f}"
          f" s, ply {spans['ply']:.3f} s), downsample_mesh "
          f"{out['downsample_s']:.3f} s (decimation {spans['decimate']:.3f}"
          f" s); faces: quadrature {faces[0]}, density {faces[1]}, "
          f"mesh.ply {out['faces']} ({out['vertices']} vertices), "
          f"smp_mesh.ply {out['smp_faces']} ({out['smp_vertices']} "
          f"vertices); median radius {radius:.4f} (gate {STAGE3_RADIUS}) "
          f"[{card}]")
    check(out["faces"] > 0, f"stage 3 ({label}) extracted no surface")
    check(STAGE3_RADIUS[0] < radius < STAGE3_RADIUS[1],
          f"stage-3 mesh ({label}) off the fixture sphere: {radius}")
    check(out["smp_vertices"] < out["vertices"],
          "smp_mesh.ply has no fewer vertices than mesh.ply")
    for name in ("mesh.ply", "mesh_nerf.ply", "smp_mesh.ply"):
        check(os.path.exists(os.path.join(field_dir, name)),
              f"stage 3 wrote no {name}")
    return out


def finetune_step_inputs(torch, trainer, views):
    """One stage-4 step's inputs: a batch of `views`, its hits cast and
    packed by the trainer's BVH, sliced to their bucket, and the step's
    noise from the trainer's generator."""
    batch = views.fetch_train_batch()
    o, d = batch["rays"]
    item = (batch, *trainer.mesh_intersect.intersect_packed(
        o, d, trainer.cfg.pack_cap))
    batch, hit_args = trainer._hit_args(item)
    dev = trainer.device
    tb = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
          for a in (o, d, batch["pixels"], batch["color_bkgd"])]
    n = tb[0].shape[0]
    t_jitter = torch.rand((n,), generator=trainer.generator, device=dev)
    bary = torch.rand((n, trainer.cfg.max_hits, 3),
                      generator=trainer.generator, device=dev)
    return (*tb, hit_args, t_jitter, bary)


def finetune_step_grads(torch, trainer, inputs, freeze):
    """step_grads of one stage-4 step over the rf's and the field's
    leaves (zeros where the loss does not reach: the rf when frozen)."""
    return step_grads(torch, trainer.params, lambda: trainer._loss_fn(
        trainer.params, *inputs, freeze)[0])


def compare_finetune_step(torch, trainer, kernels, inputs, freeze):
    """One stage-4 step, kernel path against plain path, held to
    compare_step's rules: the loss within 1e-5 relative; each K1 output
    of the kernel-path step (the field's and, joint, the NGP's at the
    hits and at the twin's samples) within
    1e-5 * max |want| of the plain version summed in float64 on its own
    inputs; the rf's gradients (bf16 MLPs) within 8 times the plain
    path's own spread over three reruns, and at least 2^-8; the field's
    (f32) within 1e-4 of max of the plain path's, or 8 times the plain
    path's own spread over its leaves where that is larger (a joint
    step, whose field gradient comes through the bf16 NGP)."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.train.stage1_ngp import _leaves

    calls, kernel = [], hg.table_grad_kernel

    def recording(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    with mock.patch.object(hg, "table_grad_kernel", recording):
        loss_k, grads_k = finetune_step_grads(torch, trainer, inputs, freeze)
    before = {k.name: k.launches for k in kernels}
    with plain_path():
        loss_p, grads_p = finetune_step_grads(torch, trainer, inputs, freeze)
        reruns = [finetune_step_grads(torch, trainer, inputs, freeze)[1]
                  for _ in range(3)]
    check({k.name: k.launches for k in kernels} == before,
          "the plain-path stage-4 step launched a kernel")
    check(len(calls) == (1 if freeze else 3),
          f"{len(calls)} calls of K1 in one {'frozen' if freeze else 'joint'}"
          f" stage-4 step")
    k1_errs = []
    for args, got in calls:
        want = hg.table_grad_plain(*as_f64(args))
        k1_errs.append(float((got - want).abs().max() / want.abs().max()))
        del want
    del calls

    def rel(a, b):
        return [float((x - y).abs().max() / y.abs().max())
                if float(y.abs().max()) > 0 else float(x.abs().max())
                for x, y in zip(a, b)]

    n_rf = len(_leaves(trainer.params["rf"]))
    errs = rel(grads_k, grads_p)
    spreads = [max(leaf) for leaf in zip(*(rel(r, grads_p) for r in reruns))]
    rf_limit = max(8 * max(spreads[:n_rf]), 2**-8)
    # a joint step's field gradient passes through the NGP's bf16 MLPs
    # at the deformed hits and the plain composite's index_add_ atomics:
    # the plain path moves it by up to ~1.6e-4 of max between reruns
    field_limit = max(8 * max(spreads[n_rf:]), 1e-4)
    limits = [rf_limit] * n_rf + [field_limit] * (len(errs) - n_rf)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    label = "frozen" if freeze else "joint"
    print(f"one {label} stage-4 step, kernel path vs plain path: loss "
          f"{loss_k} vs {loss_p} (relative {loss_rel}, limit 1e-5); K1 "
          f"outputs vs float64 plain sums, same inputs: {k1_errs} of max "
          f"(limit 1e-5); gradient error / max |grad| per leaf (rf first) "
          f"{errs} (limits {limits}); plain path vs itself, largest of "
          f"three reruns per leaf {spreads}")
    check(loss_rel <= 1e-5, f"kernel-path stage-4 loss disagrees: {loss_rel}")
    check(all(e <= 1e-5 for e in k1_errs),
          f"K1 in the stage-4 step disagrees: {k1_errs}")
    check(all(e <= lim for e, lim in zip(errs, limits)),
          f"kernel-path stage-4 gradients disagree: {errs}")
    return dict(loss_rel=loss_rel, k1_rel=k1_errs, grad_rel=errs,
                rf_limit=rf_limit, field_limit=field_limit)


def finetune_slice(torch, kernels, card, views, captured, report, root,
                   ckpt, big_export, profile: bool):
    """Phase 8: stage 3 on phase 7's 256^3 export (and on its 1024^3
    export with --export 1024), then stage 4 at
    run_nerfsynthetic_finetune.sh's flags from phase 7's feeder
    checkpoint and the stage-3 smp_mesh.ply: Stage4Trainer.train for
    400 steps (300 frozen), a mesh update at step 200 between two
    2-view evaluations, the final update, then an evaluation. K2, K4, K3
    and K1 must launch (K1 once a frozen step, into the deformation
    table; a joint step adds the NGP's at the hits and at the twin's
    samples), no
    cell table gradient and no stream entry. Gates: finite losses whose
    last-20 mean is below the first-20 mean, the eval PSNR at least
    FINETUNE_PSNR_GATE and at least FINETUNE_GAIN_GATE above the
    evaluation at step 200. Reports ms/step (frozen over steps 150-300,
    joint over 300-400), rendered hits/s, rays a step and the wait on
    the prefetcher; then a frozen and a joint step on the kernel path
    against the plain path, and (for phase 6) one step's field encode,
    field table gradient, packed composite and the twin's composite.
    Fills report["train_finetune"] and returns the path's launches."""
    from quadraturefields_tpu_torch.geometry.intersect import HitPrefetcher
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.render import quadrature, renderer
    from quadraturefields_tpu_torch.train.stage1_ngp import _leaves
    from quadraturefields_tpu_torch.train.stage4_finetune import (
        Stage4Config,
        Stage4Trainer,
    )

    field_dir = os.path.join(root, "results", "fixture", "field")
    out = {"stage3": stage3_slice(torch, card, field_dir, "256^3 export")}
    if big_export:
        out["stage3_1024"] = stage3_slice(torch, card, big_export,
                                          "1024^3 export")
        shutil.rmtree(big_export)

    # run_nerfsynthetic_finetune.sh: --scaling 0.0434 --up_sample 2
    # --voxel_size 150 --max_hits 25 --num_lobes 0 --num_layers 2
    # --log2_hashmap_size 19 --batch_size 17 --scale 1.5; 400 of its
    # 10,000 steps (300 frozen; steps 0-399, max_steps 399, as train()
    # runs max_steps + 1), a mesh update every 200 steps (2000)
    cfg = Stage4Config(
        root=root, scene="fixture", ckpt_path=ckpt,
        mesh_path=os.path.join(field_dir, "smp_mesh.ply"), scaling=0.0434,
        up_sample=2, voxel_size=150, max_hits=25, num_lobes=0, num_layers=2,
        log2_hashmap_size=19, batch_size_log2=17, scale=1.5, max_steps=399,
        mesh_update_every=200, eval_views=2, log_every=50,
        ckpt_every=10**9)
    up = views.upsampled(cfg.up_sample, cfg.init_batch_size)
    trainer = Stage4Trainer(cfg, train_dataset=up, test_dataset=up)
    fgrid = trainer.field_cfg.hashgrid
    e = fgrid.total_entries
    check(e == 101_626_144, f"the deformation field table has {e} rows")
    print(f"deformation field: {trainer.field_cfg}; table {e} rows x "
          f"{fgrid.n_features} f32 ({e * fgrid.n_features * 4 / 1e6:.1f} "
          f"MB); mesh {trainer.mesh_intersect.n_faces} faces; views "
          f"{len(up)} x {up.HEIGHT}x{up.WIDTH} rays on {views.res}^2 pixels")

    k1 = hg.ENCODE_BWD_KERNEL
    record, evals, waits = [], [], []
    one_step, evaluate = trainer.train_one_step, trainer.evaluate
    real_next = trainer.prefetcher.next

    def timed_next():
        t = time.perf_counter()
        item = real_next()
        waits.append(time.perf_counter() - t)
        return item

    def timed_step():
        rays, k1_before = up.num_rays, k1.launches
        t = time.perf_counter()
        loss, nh, mse = one_step()
        loss = float(loss)  # waits for the step
        record.append((time.perf_counter() - t, rays, nh, loss,
                       k1.launches - k1_before))
        return loss, nh, mse

    def recorded_evaluate(*args, **kw):
        metrics = evaluate(*args, **kw)
        evals.append(metrics)
        return metrics

    trainer.prefetcher.next = timed_next
    trainer.train_one_step, trainer.evaluate = timed_step, recorded_evaluate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = count_launches(kernels, trainer.train)
    train_s = time.perf_counter() - t0
    trainer.train_one_step, trainer.evaluate = one_step, evaluate
    n_steps = len(record)
    print(f"train_finetune: {n_steps} steps + 2 evaluations + 2 mesh "
          f"updates + checkpoint in {train_s:.2f} s; kernel launches "
          f"{launches}")
    path_kernels = (hg.ENCODE_KERNEL.name, "occ_bits", "segment_sum",
                    k1.name)
    for name in path_kernels:
        check(launches[name] > 0, f"train_finetune never launched {name}")
    others = {k: n for k, n in launches.items() if k not in path_kernels}
    check(not any(others.values()), f"train_finetune launched {others}")
    frozen = cfg.freeze_rf_steps
    k1_frozen = [r[4] for r in record[:frozen]]
    k1_joint = [r[4] for r in record[frozen:]]
    print(f"K1 launches a step: frozen {sorted(set(k1_frozen))} over "
          f"{len(k1_frozen)} steps, joint {sorted(set(k1_joint))} over "
          f"{len(k1_joint)} steps")
    check(set(k1_frozen) == {1} and set(k1_joint) == {3},
          "K1 did not launch once a frozen and three times a joint step")

    losses = [r[3] for r in record]
    check(all(np.isfinite(losses)), "non-finite stage-4 loss")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"stage-4 loss: mean of the first 20 steps {first:.6f}, of the "
          f"last 20 {last:.6f} (ratio {last / first:.4f}, must be < 1)")
    check(last < first, "the stage-4 loss did not fall")
    final = trainer.evaluate(up, n_views=cfg.eval_views)
    gain = final["psnr"] - evals[0]["psnr"]
    print(f"evaluations ({cfg.eval_views} views, box-downsampled from "
          f"{up.HEIGHT}^2): step 200 before the mesh update {evals[0]}, "
          f"after {evals[1]}; after training {final} (PSNR gate "
          f"{FINETUNE_PSNR_GATE}); gain over step 200 {gain:.4f} dB (gate "
          f"{FINETUNE_GAIN_GATE})")
    check(final["psnr"] >= FINETUNE_PSNR_GATE,
          f"stage-4 eval PSNR {final['psnr']} < {FINETUNE_PSNR_GATE}")
    check(gain >= FINETUNE_GAIN_GATE,
          f"the joint steps lifted the eval PSNR by {gain} dB < "
          f"{FINETUNE_GAIN_GATE}")

    def window(a, b):
        rows = record[a:b]
        s = sum(r[0] for r in rows)
        hits = sum(min(r[2], cfg.pack_cap) for r in rows)
        return dict(ms_per_step=s / len(rows) * 1e3,
                    rendered_hits_per_s=hits / s,
                    rays_per_step=sum(r[1] for r in rows) / len(rows),
                    hits_per_step=hits / len(rows),
                    prefetch_wait_ms=float(np.mean(waits[a:b])) * 1e3)

    out.update(
        steps=n_steps, frozen=window(150, frozen),
        joint=window(frozen, n_steps), loss_first20=first, loss_last20=last,
        eval_before_update=evals[0], eval_after_update=evals[1],
        eval_final=final, psnr_gain=gain, launches=launches,
        k1_per_step={"frozen": k1_frozen[0], "joint": k1_joint[0]},
        train_s=train_s, card=card)
    for label in ("frozen", "joint"):
        w = out[label]
        print(f"stage-4 training (train_finetune), {label} steps: "
              f"{w['ms_per_step']:.3f} ms/step, "
              f"{w['rendered_hits_per_s']:.1f} rendered hits/s, "
              f"{w['rays_per_step']:.1f} rays and {w['hits_per_step']:.1f}"
              f" hits a step, prefetcher wait {w['prefetch_wait_ms']:.3f} "
              f"ms a step [{card}]")

    # a frozen and a joint step on the kernel path against the plain
    # path; the joint step's field encode, field table gradient, packed
    # composite and its volumetric twin's composite go to phase 6
    for freeze in (True, False):
        inputs = finetune_step_inputs(torch, trainer, up)
        if not freeze:
            with capture(hg, "encode_kernel", captured, "finetune_step",
                         when=lambda table, x, c: c == fgrid), \
                    capture(hg, "table_grad_kernel", captured,
                            "finetune_grad_step",
                            when=lambda x, g, c: c == fgrid), \
                    capture(quadrature, "presorted_row_segment_sum_vjp",
                            captured, "finetune_composite"), \
                    capture(renderer, "presorted_row_segment_sum_vjp",
                            captured, "finetune_twin_composite"):
                finetune_step_grads(torch, trainer, inputs, freeze)
        out["compare_" + ("frozen" if freeze else "joint")] = \
            compare_finetune_step(torch, trainer, kernels, inputs, freeze)
        del inputs

    if profile:
        trainer.prefetcher = HitPrefetcher(
            up.fetch_train_batch, trainer.mesh_intersect, depth=2,
            packed_cap=cfg.pack_cap)
        try:
            profile_steps(torch, trainer.train_one_step, card,
                          label="stage-4 joint step (train_finetune)")
        finally:
            trainer.prefetcher.stop()
    leaves = _leaves(trainer.params)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    n_params = sum(p.numel() for p in leaves)
    out["adam_ms"] = cuda_ms(trainer.optimizer.step, iters=5, warmup=1)
    out["adam_bound_ms"] = bound(7 * 4 * n_params, 0)["bound_ms"]
    print(f"Adam over the rf's and the field's {n_params} parameters: "
          f"{out['adam_ms']:.4f} ms a step, bound "
          f"{out['adam_bound_ms']:.4f} ms [{card}]")
    report["train_finetune"] = out
    del trainer, leaves
    torch.cuda.empty_cache()
    return launches


def time_captured(torch, report, captured, card, baseline=None):
    """Phase 6: K2, K1, K5, K6, K7 and K8 on the inputs that the main
    paths gave them (captured in phases 3-5), against their plain
    versions, with the bound of these inputs; with a baseline, its K8
    interface, K1 stream entry and K6 route in turns beside. K2 runs on
    the eval chunk's slots, on its valid samples alone (the padding
    after them sits at one position) and on the corner step's slots,
    each tet (as the paths run it) and cube (the same table and
    positions); K1 on the corner step's positions and cotangent, tet and
    cube; K8 and K1's stream entry on that step's contributions in ray
    order (level by level, corner by corner, then the samples as the
    march laid them out); K7, K5 and K6 on one step of their cell paths.
    Adds report[...]["captured"]."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    for key in ("eval_chunk", "train_step", "corner_grad_step", "cell_step",
                "cell_f32_step", "cell_bf16pair_step", "field_step",
                "field_grad_step", "finetune_step", "finetune_grad_step"):
        check(key in captured, f"no kernel call captured in {key}")
    table, x, cfg = captured["eval_chunk"]
    inputs = {"eval_chunk": (table, x, cfg),
              "eval_chunk_valid": (table,
                                   x[:captured["eval_chunk_valid"]], cfg),
              "train_step": captured["train_step"],
              "field_step": captured["field_step"],
              "finetune_step": captured["finetune_step"]}
    enc = report["hashgrid_encode"]
    for path, (table, x, path_cfg) in inputs.items():
        distinct = int(torch.unique(x, dim=0).shape[0])
        for interp, entry in (("tet", enc), ("cube", enc["cube"])):
            cfg = dataclasses.replace(path_cfg, interp=interp)
            got = hg.encode_kernel(table, x, cfg)
            want = hg.encode_plain(table, x, cfg)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            del got, want
            ms = cuda_ms(lambda: hg.encode_kernel(table, x, cfg))
            plain_ms = cuda_ms(lambda: hg.encode_plain(table, x, cfg),
                               iters=5)
            b = encode_bound(torch, x, cfg)
            entry.setdefault("captured", {})[path] = dict(
                points=x.shape[0], distinct_points=distinct,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)
            print(f"encode {interp} on the {path} positions ({x.shape[0]} "
                  f"points, {distinct} distinct): max_abs_err {err}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
            check(err == 0.0 if interp == "tet" else err <= 1e-5,
                  f"encode {interp} on the {path} positions disagrees: "
                  f"{err}")

    def table_grad(label, kernel, plain, x, g, cfg, out_bytes, corners,
                   old=None):
        """A table gradient on captured (x, g): error against the plain
        sum in float64, times, and the bound: x, g and the output once; a
        multiply and an add for each product of the (point, level) pairs
        with a nonzero cotangent. `old` (x, g, cfg): the baseline's."""
        n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
        got = kernel(x, g, cfg)
        want = plain(x, g.double(), cfg)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        del got, want
        ms, res = timed(lambda: kernel(x, g, cfg),
                        old and (lambda: old(x, g, cfg)))
        plain_ms = cuda_ms(lambda: plain(x, g, cfg), iters=5)
        live = int((g.reshape(n, L, F) != 0).any(dim=2).sum())
        b = bound(n * 12 + n * L * F * 4 + out_bytes,
                  live * 2 * corners * F)
        print(f"{label} ({n} points, {live} of {n * L} (point, level) "
              f"pairs with a nonzero cotangent): max_abs_err {err}, "
              f"relative {err / scale} (limit 1e-5); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); baseline {res} [{card}]")
        check(err <= 1e-5 * scale, f"{label} disagrees: {err}")
        return dict(points=n, live_pairs=live, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, **b, **res)

    x, g, path_cfg = captured["corner_grad_step"]
    k1 = report["hashgrid_encode_bwd"]
    for interp, entry in (("tet", k1), ("cube", k1["cube"])):
        cfg = dataclasses.replace(path_cfg, interp=interp)
        entry["captured"] = {"train_step": table_grad(
            f"table grad (K1 fused) {interp} on one corner step's x and g",
            hg.table_grad_kernel, hg.table_grad_plain, x, g, cfg,
            cfg.total_entries * cfg.n_features * 4, cfg.corners)}
    # K1 on the stage-2 step's x and g into the 317 MB field table; its
    # wrapper zeroes the gradient before the launch, timed alone too
    x, g, cfg = captured["field_grad_step"]
    entry = table_grad(
        "table grad (K1 fused) tet on one stage-2 step's x and g, field "
        f"table {cfg.total_entries} rows", hg.table_grad_kernel,
        hg.table_grad_plain, x, g, cfg,
        cfg.total_entries * cfg.n_features * 4, cfg.corners)
    entry["memset_ms"] = cuda_ms(lambda: torch.zeros(
        (cfg.total_entries, cfg.n_features), device=x.device))
    print(f"the field gradient's zeroing alone ({cfg.total_entries} x "
          f"{cfg.n_features} f32): {entry['memset_ms']:.4f} ms [{card}]")
    k1["captured"]["field_step"] = entry
    del x, g
    x, g, path_cfg = captured["corner_grad_step"]
    # K8 and K1's stream entry on the same step's contributions, ordered
    # (level, corner, sample): neighbouring samples of a ray share the
    # rows of the coarse levels, so lanes merge as in K1
    idx, w = hg._corner_indices_weights(x, path_cfg)
    n, L, C = x.shape[0], path_cfg.n_levels, path_cfg.corners
    v = (w.reshape(n, L, C, 1) * g.reshape(n, L, 1, 2))
    idx = idx.reshape(n, L, C).permute(1, 2, 0).reshape(-1).int()
    v = v.permute(1, 2, 0, 3).reshape(-1, 2)
    v0, v1 = v[:, 0].contiguous(), v[:, 1].contiguous()
    del w, v
    pairs = pairs_and_values(torch, "corner step's ray-ordered stream", idx,
                             v0, v1, path_cfg.total_entries, baseline)
    report["table_grad_values"]["captured"] = {
        "train_step": pairs.pop("values")}
    report["table_grad_values"]["stream"]["captured"] = {
        "train_step": pairs}
    del idx, v0, v1

    x, g, cfg = captured["cell_step"]
    report["cell_factor_grad"]["captured"] = {"cell_step": table_grad(
        "cell factor grad (K7 fused) on one cell step's x and g",
        hg.tet_factor_grad_x_kernel, hg.tet_factor_grad_x_plain, x, g, cfg,
        cfg.total_entries * cfg.row_width * 4, 4)}

    x, g, cfg = captured["cell_f32_step"]
    entry = table_grad(
        "cell row grad (K5 fused) on one f32 cell step's x and g",
        hg.cell_row_grad_x_kernel, hg.cell_row_grad_x_plain, x, g, cfg,
        cfg.total_entries * cfg.row_width * 4, cfg.corners)
    entry["route_ms"] = cuda_ms(
        lambda: rows_route(x, g, cfg, hs.row_grad_kernel), iters=5)
    print(f"cell row grad (K5) on the same inputs, the route it replaced: "
          f"{entry['route_ms']:.4f} ms [{card}]")
    report["cell_row_grad_x"]["captured"] = {"cell_f32_step": entry}

    x, g, cfg = captured["cell_bf16pair_step"]
    entry = table_grad(
        "cell pair grad (K6 fused) on one bf16pair cell step's x and g",
        hg.cell_pair_grad_x_kernel, hg.cell_pair_grad_x_plain, x, g, cfg,
        cfg.total_entries * cfg.row_width * 4, cfg.corners,
        baseline and baseline.pair_route_fn)
    entry["route_ms"] = cuda_ms(
        lambda: pair_route(x, g, cfg, hs.pair_grad_kernel), iters=5)
    print(f"cell pair grad (K6) on the same inputs, the route it replaced: "
          f"{entry['route_ms']:.4f} ms [{card}]")
    report["cell_pair_grad_x"]["captured"] = {"cell_bf16pair_step": entry}
    time_finetune_captured(torch, report, captured, card, table_grad)



def time_finetune_captured(torch, report, captured, card, table_grad):
    """Phase 6's stage-4 part: K1 (table_grad, time_captured's helper)
    on the stage-4 step's field positions and cotangent into the
    deformation table, against its plain version."""
    from quadraturefields_tpu_torch.ops import hashgrid as hg

    k1 = report["hashgrid_encode_bwd"]
    # K1 on the stage-4 step's field positions and cotangent into the
    # 813 MB deformation table, its zeroing alone too
    x, g, cfg = captured["finetune_grad_step"]
    entry = table_grad(
        "table grad (K1 fused) tet on one stage-4 step's x and g, "
        f"deformation table {cfg.total_entries} rows", hg.table_grad_kernel,
        hg.table_grad_plain, x, g, cfg,
        cfg.total_entries * cfg.n_features * 4, cfg.corners)
    entry["memset_ms"] = cuda_ms(lambda: torch.zeros(
        (cfg.total_entries, cfg.n_features), device=x.device))
    print(f"the deformation gradient's zeroing alone ({cfg.total_entries} "
          f"x {cfg.n_features} f32): {entry['memset_ms']:.4f} ms [{card}]")
    k1["captured"]["finetune_step"] = entry
    del x, g


def time_segment_sums(torch, report, captured, card, baseline=None):
    """Phase 6's K3 part: the per-ray segment sum on each path's own
    inputs (captured in phases 3-5, 7 and 8): the composite of the
    busiest eval chunk, of a step of each stage-1 training path, of a
    stage-2 step, and of a joint stage-4 step's volumetric twin and its
    packed quadrature stream (keys = the ray, pads = n); with a baseline,
    the other checkout's K3 in turns beside. Adds
    report["segment_sum"]["captured"]."""
    paths = {
        "eval": ("eval_composite", "the busiest eval chunk's composite"),
        "train": ("train_composite", "a corner step's composite"),
        "train_cell": ("train_cell_composite",
                       "a cell (bf16factor) step's composite"),
        "train_cell_f32": ("train_cell_f32_composite",
                           "an f32 cell step's composite"),
        "train_cell_bf16pair": ("train_cell_bf16pair_composite",
                                "a bf16pair cell step's composite"),
        "train_field": ("train_field_composite",
                        "a stage-2 step's composite"),
        "train_finetune_twin": ("finetune_twin_composite",
                                "a joint stage-4 step's twin composite"),
        "train_finetune_packed": ("finetune_composite",
                                  "a joint stage-4 step's packed composite"),
    }
    out = report["segment_sum"]["captured"] = {}
    for path, (key, label) in paths.items():
        check(key in captured, f"no K3 call captured in {key}")
        keys, vals, n_seg = captured.pop(key)
        out[path] = segment_sum_case(torch, label, keys,
                                     vals.contiguous(), n_seg, card,
                                     baseline)
        del keys, vals


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

    from quadraturefields_tpu_torch._cuda import build
    from quadraturefields_tpu_torch.geometry.native import (
        build as build_qfgeom,
    )
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_backward as hb
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs
    from quadraturefields_tpu_torch.ops import occ_bits as ob

    args = sys.argv[1:]
    profile = "--profile" in args
    baseline = (Baseline(args[args.index("--baseline") + 1])
                if "--baseline" in args else None)
    # the eight kernels of the JSON line (K5, K6 and K7 are their fused
    # entries, K8 its one-launch interface); their stream entries are
    # counted too (K8's: K1's stream interface on K8's kernel), and must
    # stay off the paths
    kernels = [hg.ENCODE_KERNEL, ob.BITS_KERNEL, hs.SEGMENT_SUM_KERNEL,
               hg.ENCODE_BWD_KERNEL, hb.TABLE_GRAD_VALUES_KERNEL,
               hg.CELL_ROW_GRAD_X_KERNEL, hg.CELL_PAIR_GRAD_X_KERNEL,
               hg.CELL_FACTOR_GRAD_X_KERNEL]
    streams = {"cell_row_grad_x": hs.CELL_ROW_GRAD_KERNEL,
               "cell_pair_grad_x": hs.CELL_PAIR_GRAD_KERNEL,
               "cell_factor_grad": hs.CELL_FACTOR_GRAD_KERNEL,
               "table_grad_values": hs.TABLE_GRAD_PAIRS_KERNEL}
    counted = kernels + list(streams.values())
    libraries = sorted({k.library for k in counted})
    jobs = [partial(build, lib) for lib in libraries]
    # the host geometry library of phase 8 (g++), beside them
    jobs.append(build_qfgeom)
    if baseline is not None:
        jobs += [k.load for k in baseline.kernels]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: job(), jobs))
    for k in counted:
        k.load()
    print(f"built {', '.join(libraries)} and qfgeom"
          f"{' and the baseline' if baseline else ''} (one nvcc per "
          f"source, in parallel) in {time.perf_counter() - t0:.1f} s")

    report, captured = {}, {}
    compare_kernels(torch, dev, report, card, baseline)
    compare_cell_kernels(torch, dev, report, baseline)

    t0 = time.perf_counter()
    views = FixtureViews()
    print(f"fixture views: {len(views)} x {views.HEIGHT}x{views.WIDTH} "
          f"built in {time.perf_counter() - t0:.1f} s")
    eval_launches = render_slice(torch, counted, card, views, captured,
                                 profile)

    from quadraturefields_tpu_torch.train.stage1_ngp import Stage1Config

    common = dict(max_steps=300, log_every=50, ckpt_every=10**9,
                  scene="fixture")
    # phase 4: the trainer defaults (corner layout, 2^18 samples)
    train_launches, _ = train_slice(
        torch, counted, card, views, "train",
        Stage1Config(root=tempfile.mkdtemp(prefix="qf_smoke_"), **common),
        ("hashgrid_encode", "occ_bits", "segment_sum", "hashgrid_encode_bwd"),
        (hg, "table_grad_kernel", hg.table_grad_plain),
        captured, profile)
    # phase 5: run_nerfsynthetic_tpu_fast.sh's flags (--layout cell
    # --grad_payload bf16factor --n_levels 8 --n_features 4 --num_lobes 0
    # --num_layers 2 --log2_hashmap_size 19 --batch_size 20 --scale 1.5
    # --reg_type occ --occ_thres 0.01), 300 of its 20,000 steps
    cell_cfg = Stage1Config(
        root=tempfile.mkdtemp(prefix="qf_smoke_"), layout="cell",
        grad_payload="bf16factor", n_levels=8, n_features=4, num_lobes=0,
        num_layers=2, log2_hashmap_size=19, batch_size_log2=20, scale=1.5,
        reg_type="occ", occ_thres=0.01, **common)
    print(f"cell model: {cell_cfg.ngp_config()}, "
          f"{cell_cfg.ngp_config().hashgrid.total_entries} rows")
    cell_grads = [k.name for k in counted if k.library in
                  ("cell_table_grad", "cell_factor_grad")]

    def cell_path(name, payload, kernel, fn, plain):
        """The cell configuration with `payload`: the path `name` must
        launch the fused cell table gradient `kernel` once a step and
        every other cell table gradient never."""
        cfg = dataclasses.replace(
            cell_cfg, root=tempfile.mkdtemp(prefix="qf_smoke_"),
            grad_payload=payload)
        launches, n_steps = train_slice(
            torch, counted, card, views, name, cfg,
            ("occ_bits", "segment_sum", kernel.name), (hg, fn, plain),
            captured, profile)
        check(launches[kernel.name] == n_steps,
              f"{kernel.name} launched {launches[kernel.name]} times in "
              f"{n_steps} steps of {name}")
        others = {k: launches[k] for k in cell_grads if k != kernel.name}
        check(not any(others.values()),
              f"{name} launched another cell table gradient: {others}")
        return launches

    cell_launches = cell_path(
        "train_cell", "bf16factor", hg.CELL_FACTOR_GRAD_X_KERNEL,
        "tet_factor_grad_x_kernel", hg.tet_factor_grad_x_plain)
    # the CLI's default table gradient for --layout cell (--grad_payload
    # f32): the rows route, K5 fused
    f32_launches = cell_path(
        "train_cell_f32", "f32", hg.CELL_ROW_GRAD_X_KERNEL,
        "cell_row_grad_x_kernel", hg.cell_row_grad_x_plain)
    # --grad_payload bf16pair: the pair route, K6 fused
    pair_launches = cell_path(
        "train_cell_bf16pair", "bf16pair", hg.CELL_PAIR_GRAD_X_KERNEL,
        "cell_pair_grad_x_kernel", hg.cell_pair_grad_x_plain)

    # phase 7: stage 2 at run_nerfsynthetic_field.sh's widths
    field_launches, root7, ckpt7, big7 = field_slice(
        torch, counted, card, views, captured, report, profile,
        int(args[args.index("--export") + 1]) if "--export" in args else 0)

    # phase 8: stages 3 and 4 at run_nerfsynthetic_mc.sh's and
    # run_nerfsynthetic_finetune.sh's flags, on phase 7's artifacts
    finetune_launches = finetune_slice(
        torch, counted, card, views, captured, report, root7, ckpt7, big7,
        profile)

    time_captured(torch, report, captured, card, baseline)
    time_segment_sums(torch, report, captured, card, baseline)

    check("jax" not in sys.modules, "the port imported jax")
    ref = sorted(k for k in sys.modules if k == "quadraturefields_tpu"
                 or k.startswith("quadraturefields_tpu."))
    check(not ref, f"the port imported the JAX package: {ref}")

    paths = {"eval": eval_launches, "train": train_launches,
             "train_cell": cell_launches, "train_cell_f32": f32_launches,
             "train_cell_bf16pair": pair_launches,
             "train_field": field_launches,
             "train_finetune": finetune_launches}
    for name, stream in streams.items():
        report[name]["stream"]["launches_by_path"] = {
            p: n[stream.name] for p, n in paths.items()}
    report["cell_row_grad_x"]["also_replaces"] = (
        "quadraturefields_tpu/ops/hashgrid_sorted.py:116")
    print(json.dumps({"train_field": report["train_field"]}))
    print(json.dumps({"train_finetune": report["train_finetune"]},
                     default=float))
    print(card)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(p[k.name] for p in paths.values()),
         "launches_by_path": {p: n[k.name] for p, n in paths.items()},
         "path": ", ".join(p for p, n in paths.items() if n[k.name])
         or "none (phase 2 only)",
         **report[k.name]}
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
