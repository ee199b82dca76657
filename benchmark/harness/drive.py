"""One run of a cell: set-up, the measured window, the traced slice,
and the plain reference that decides `correct`.

The program is `quadraturefields_tpu_torch`'s `Stage1Trainer`, built
from the configuration file and driven through its own entry points:
`train_one_step` (the "train" loop) and `render_view` (the "render"
loop). The benchmark makes everything the trainer is fed: the fixture
views, the weights (copied into the trainer's own leaves), the
occupancy grid of the render loop, and the generator the trainer draws
its march and occupancy uniforms from. The reference gets the same and
works out again what the program derived from them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from ..reference import ngp as rngp
from ..reference import render as rrender
from ..reference import train as rtrain
from . import check, fixture, tracing, weights as wts

JITTER_SEED_OFFSET = 1
VIEW_SEED_OFFSET = 2


def grid_of(stage1: dict) -> rngp.Grid:
    return rngp.Grid(n_levels=stage1["n_levels"],
                     n_features=stage1["n_features"],
                     log2_hashmap_size=stage1["log2_hashmap_size"],
                     layout=stage1["layout"], interp=stage1["interp"])


def field_of(stage1: dict, precision=rngp.Precision()) -> rngp.Field:
    return rngp.Field(grid=grid_of(stage1), payload=stage1["grad_payload"],
                      precision=precision)


def aabb_of(stage1: dict) -> np.ndarray:
    return np.array([-1, -1, -1, 1, 1, 1], np.float32) * stage1["scale"]


def march_of(stage1: dict, budget: int) -> rrender.March:
    aabb, dt = aabb_of(stage1), stage1["render_step_size"]
    res, cf = stage1["grid_resolution"], stage1["coarse_factor"]
    two_level = cf > 1 and res // cf >= 32
    stride, dil = (rrender.coarse_stride_dilation(aabb, res, cf, dt)
                   if two_level else (0, 0))
    return rrender.March(step=dt, max_steps=rrender.max_march_steps(aabb, dt),
                         budget=budget, coarse_factor=cf if two_level else 0,
                         coarse_stride=stride, coarse_dilation=dil)


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak():
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


class CallLog:
    """The shapes of the calls into the port's kernel entry points (K2,
    and the fused table gradients K1 and K7) while installed: each
    call's point count, and every `hold_every`-th call's positions,
    from which the touched table rows are counted afterwards."""

    ENTRIES = (("encode", "encode_kernel", 1),
               ("table_grad", "table_grad_kernel", 0),
               ("table_grad", "tet_factor_grad_x_kernel", 0))

    def __init__(self, hold_every: int):
        self.hold_every = max(1, int(hold_every))
        self.calls = {"encode": [], "table_grad": []}

    @contextlib.contextmanager
    def installed(self):
        from quadraturefields_tpu_torch.ops import hashgrid as hg

        saved = {}

        def wrap(role, fn, x_arg):
            def logged(*args, **kwargs):
                x = args[x_arg]
                log = self.calls[role]
                held = x if len(log) % self.hold_every == 0 else None
                log.append((int(x.shape[0]), held))
                return fn(*args, **kwargs)
            return logged

        for role, name, x_arg in self.ENTRIES:
            fn = getattr(hg, name, None)
            if fn is not None:
                saved[name] = fn
                setattr(hg, name, wrap(role, fn, x_arg))
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(hg, name, fn)

    def shapes(self, role: str, grid: rngp.Grid) -> list:
        """[(points, touched rows)] of every call; a call whose
        positions were not held gets the mean rows of those that were."""
        log = self.calls[role]
        held = [rngp.rows_touched(x, grid) for _, x in log if x is not None]
        if not held:
            return []
        mean = statistics.mean(held)
        rows = iter(held)
        return [(n, next(rows) if x is not None else mean) for n, x in log]


@dataclasses.dataclass
class Window:
    units: int = 0          # steps or views completed
    seconds: float = 0.0
    rays: int = 0
    samples: int = 0        # samples composited (train)
    memory_peak_bytes: int = 0


class Run:
    """Shared parts of the two loops."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.stage1 = dict(cell.config["stage1"])
        self.grid = grid_of(self.stage1)
        self.trainer = None
        self.call_log = None
        self.slice = None
        self.marks = [("start", time.perf_counter())]

    def mark(self, name: str):
        """Note the end of a set-up phase (the run logs their seconds)."""
        sync()
        self.marks.append((name, time.perf_counter()))

    def phases(self) -> str:
        return ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                         in zip(self.marks, self.marks[1:]))

    def _trainer(self, views):
        from quadraturefields_tpu_torch.train.stage1_ngp import (
            Stage1Config,
            Stage1Trainer,
        )

        cfg = Stage1Config(**self.stage1, scene=self.cell.config["scene"],
                           seed=self.seed)
        return Stage1Trainer(cfg, train_dataset=views, test_dataset=views,
                             device=self.device)

    def _views(self):
        v = self.cell.traffic["views"]
        return fixture.FixtureViews(
            n_views=v["n"], res=v["res"], fov_deg=v["fov_deg"],
            pose_seed=v["pose_seed"],
            num_rays=self.stage1["init_batch_size"], seed=self.seed,
            pixel_step=v["pixel_step"], device=self.device)

    def trace_slice(self):
        """Trace `trace_units` whole steps or views, with the calls into
        the kernels' entry points logged."""
        t = self.cell.traffic
        self.call_log = CallLog(t.get("trace_hold_every", 1))
        self._align_trace()
        with self.call_log.installed():
            self.slice = tracing.trace(
                lambda: self._units(t["trace_units"]), sync,
                t["trace_units"])
        return self.slice

    def _align_trace(self):
        pass

    def free_program(self):
        self.trainer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def to_host(tree):
    """A copy of a dict of tensors (nested one deep) in host memory."""
    return {k: (to_host(v) if isinstance(v, dict) else v.detach().cpu())
            for k, v in tree.items()}


def to_device(tree, device):
    return {k: (to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


@torch.no_grad()
def taken_gradient_norm(optimizer, leaf, exp_avg_before, beta1) -> float:
    """The norm of the gradient Adam took in its last step of `leaf`,
    from its first moment before and after; NaN where it holds none."""
    m = optimizer.state.get(leaf, {}).get("exp_avg")
    if m is None:
        return float("nan")
    return float((m - beta1 * exp_avg_before).norm()) / (1.0 - beta1)


@dataclasses.dataclass
class Checked:
    """Steps the reference follows: the state they start from (host
    memory), the generator's state, the batches they draw, and the
    program's readings of them."""

    step: int           # the trainer's step at the first of them
    adam_steps: int     # Adam's updates before them
    generator: torch.Tensor
    start: dict         # leaves, exp_avg, exp_avg_sq, occs
    batches: list
    prog: dict


class TrainRun(Run):
    """The "train" loop: `train_one_step` in a closed loop."""

    def setup(self):
        t = self.cell.traffic
        n = t["checked_steps"]
        self.views = self._views()
        self.mark("views")
        self.weights = wts.make_weights(self.grid, t["table_scale"],
                                        self.seed, self.device)
        self.mark("weights")
        self.trainer = tr = self._trainer(self.views)
        self.mark("trainer")
        wts.load_into(tr.params, self.weights)
        tr.generator = torch.Generator(device=self.device).manual_seed(
            self.seed + JITTER_SEED_OFFSET)
        # the start: from the seeded weights, through the warm-up's refresh
        self.checked = [self._checked_steps(n)]
        self._units(t["warm_steps"] - n)
        self.mark("warm steps")
        # the window's batch, from a refresh after the warm-up
        self.checked.append(self._checked_steps(n))
        self.mark("checked steps")

    def _checked_steps(self, n: int) -> Checked:
        """n steps through `train_one_step` on the trainer the window
        goes on with, from an occupancy refresh. Keeps what the
        reference needs and the program's readings: each loss, the first
        gradient as Adam took it (from its first moment before and after
        the first step), the refresh's densities and binaries, and each
        leaf's change over the n steps."""
        tr, opt = self.trainer, self.trainer.optimizer
        period = tr.occ_cfg.update_interval
        if tr.step % period or not 0 < n <= period:
            raise ValueError(f"{n} checked steps from step {tr.step} do not "
                             f"start on a refresh (every {period} steps)")
        beta1 = opt.param_groups[0]["betas"][0]
        leaves = wts.program_leaves(tr.params)
        states = {k: opt.state.get(p, {}) for k, p in leaves.items()}
        adam_steps = {int(s.get("step", 0)) for s in states.values()}
        if len(adam_steps) != 1:
            raise ValueError(f"Adam has stepped the leaves {adam_steps} "
                             "times")
        start = {m: {k: (s[m].clone() if m in s
                         else torch.zeros_like(leaves[k]))
                     for k, s in states.items()}
                 for m in ("exp_avg", "exp_avg_sq")}
        start["leaves"] = {k: p.detach().clone() for k, p in leaves.items()}
        start["occs"] = tr.occ_state.occs.clone()
        checked = Checked(step=tr.step, adam_steps=adam_steps.pop(),
                          generator=tr.generator.get_state(), start=start,
                          batches=[], prog={"losses": []})
        self.views.recorded, self.views.record = checked.batches, n
        prog = checked.prog
        for k in range(n):
            loss, _ = tr.train_one_step()
            prog["losses"].append(float(loss))
            if k == 0:
                prog["occs"] = tr.occ_state.occs.clone()
                prog["binaries"] = tr.occ_state.binaries.clone()
                prog["grad_norms"] = {
                    name: taken_gradient_norm(opt, p, start["exp_avg"][name],
                                              beta1)
                    for name, p in leaves.items()}
        self.views.record = 0
        with torch.no_grad():
            prog["change_norms"] = {
                name: float((p - start["leaves"][name]).norm())
                for name, p in leaves.items()}
        checked.start = to_host(start)
        return checked

    def _units(self, n: int):
        for _ in range(n):
            self.trainer.train_one_step()

    def window(self, seconds: float) -> Window:
        tr, budget = self.trainer, 1 << self.stage1["batch_size_log2"]
        valid, rays, stamps = [], 0, []
        reset_peak()
        sync()
        t0 = time.perf_counter()
        while True:
            rays += tr.train_dataset.num_rays
            _, aux = tr.train_one_step()
            valid.append(aux["num_valid"])
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= seconds:
                break
        sync()
        self.stamps = [t0] + stamps
        w = Window(units=len(valid), seconds=time.perf_counter() - t0,
                   rays=rays,
                   memory_peak_bytes=peak_bytes())
        w.samples = int(torch.stack(valid).clamp(max=budget).sum())
        return w

    def blocks(self, n: int = 10) -> str:
        """ms a step in n consecutive blocks of the window."""
        st, k = self.stamps, max(1, (len(self.stamps) - 1) // n)
        return " ".join(f"{1e3 * (st[i + k] - st[i]) / k:.2f}"
                        for i in range(0, len(st) - k, k))

    def _align_trace(self):
        period = self.trainer.occ_cfg.update_interval
        self._units(-self.trainer.step % period)

    def reference(self, precision=rngp.Precision(), half_batch=False):
        """The reference's readings of each run of checked steps."""
        return [self._reference(c, precision, half_batch)
                for c in self.checked]

    def _reference(self, c: Checked, precision, half_batch) -> dict:
        """From the state the checked steps started from, on the same
        batches and uniforms (the generator's state replayed in the
        trainer's order: the refresh's jitter, then each step's march
        jitter); it marches on the program's binaries after the
        refresh, which it checks by itself."""
        dev = self.device
        start = to_device(c.start, dev)
        field = field_of(self.stage1, precision)
        aabb = torch.as_tensor(aabb_of(self.stage1), device=dev)
        res = self.stage1["grid_resolution"]
        gen = torch.Generator(device=dev)
        gen.set_state(c.generator)
        occ_jitter = torch.rand((res**3 // rrender.OCC_PARTITIONS, 3),
                                generator=gen, device=dev)
        batches = []
        for b in c.batches:
            n = b["rays"].origins.shape[0]
            jit = torch.rand((n,), generator=gen, device=dev)
            batch = {
                "origins": torch.as_tensor(b["rays"].origins, device=dev),
                "viewdirs": torch.as_tensor(b["rays"].viewdirs, device=dev),
                "pixels": torch.as_tensor(b["pixels"], device=dev),
                "bkgd": torch.as_tensor(b["color_bkgd"], device=dev),
                "t_jitter": jit,
            }
            if half_batch:
                batch = {k: (v if k == "bkgd" else v[:n // 2])
                         for k, v in batch.items()}
            batches.append(batch)
        params = rtrain.as_params(start["leaves"])
        occs = rrender.occupancy_refresh(
            field, params, aabb, start["occs"], occ_jitter,
            self.stage1["render_step_size"], c.step)
        recipe = rtrain.Recipe(lr=self.stage1["lr"],
                               max_steps=self.stage1["max_steps"],
                               weight_decay=self.stage1["weight_decay"],
                               o_lambda=self.stage1["o_lambda"])
        march = march_of(self.stage1, 1 << self.stage1["batch_size_log2"])
        adam = rtrain.Adam(start["leaves"], recipe, start["exp_avg"],
                           start["exp_avg_sq"], c.adam_steps)
        losses, first, leaves = rtrain.train_steps(
            field, dict(start["leaves"]), aabb, c.prog["binaries"], batches,
            march, recipe, adam, c.step)
        return {
            "losses": losses,
            "grad_norms": {n: float(g.norm()) for n, g in first.items()},
            "change_norms": {
                n: float((leaves[n] - start["leaves"][n]).norm())
                for n in leaves},
            "occs": occs,
        }

    def readings(self, ref: list, prog: list | None = None) -> dict:
        """Each number, the larger over the runs of checked steps, of
        the program against the reference; `prog` puts other readings
        (the control's, a fault's) in the program's place."""
        progs = prog or [c.prog for c in self.checked]
        each = [check.train_readings(p, r, self.stage1["occ_thres"])
                for p, r in zip(progs, ref)]
        return {k: max(r[k] for r in each) for k in each[0]}

    def as_program(self, other: list) -> list:
        """Reference results in the program's place: their binaries are
        their own densities' threshold."""
        res, thre = self.stage1["grid_resolution"], self.stage1["occ_thres"]
        return [dict(o, binaries=(o["occs"] > torch.clamp(
                    o["occs"].mean(), max=thre)).reshape(res, res, res))
                for o in other]


class RenderRun(Run):
    """The "render" loop: `render_view` over the fixture's poses in a
    cycle, from a pose drawn from the seed."""

    def setup(self):
        t, s = self.cell.traffic, self.stage1
        self.views = self._views()
        self.mark("views")
        self.occs, self.binaries = fixture.occupancy_from_scene(
            s["grid_resolution"], s["render_step_size"], s["occ_thres"],
            self.device)
        self.weights = wts.make_weights(self.grid, t["table_scale"],
                                        self.seed, self.device)
        self.fit_rms = wts.fit_density(
            self.weights, field_of(s),
            torch.as_tensor(aabb_of(s), device=self.device), self.binaries,
            fixture.FixtureScene().sigma, self.seed, t["fit_points"])
        self.mark("weights")
        self.trainer = tr = self._trainer(self.views)
        self.mark("trainer")
        wts.load_into(tr.params, self.weights)
        tr.occ_state = tr.occ_state._replace(occs=self.occs.clone(),
                                             binaries=self.binaries.clone())
        self.first_view = self.next_view = self.seed % len(self.views)
        self.kept, self.pose_s, self.view_s = [], {}, []
        for _ in range(t["warm_units"]):
            tr.render_view(self.views.fetch_eval_view(self.next_view))
        self.mark("warm views")

    def _render_next(self):
        pose = self.next_view % len(self.views)
        rgb = self.trainer.render_view(self.views.fetch_eval_view(pose))
        self.next_view += 1
        return pose, rgb

    def _units(self, n: int):
        for _ in range(n):
            self._render_next()

    def window(self, seconds: float) -> Window:
        """Views until `seconds` have passed and the poses have come
        round whole cycles: every seed renders the same views."""
        keep, cycle = self.cell.traffic["keep_views"], len(self.views)
        reset_peak()
        sync()
        t0 = time.perf_counter()
        last, views = t0, 0
        while True:
            pose, rgb = self._render_next()
            sync()
            now = time.perf_counter()
            self.pose_s.setdefault(pose, []).append(now - last)
            self.view_s.append(now - last)
            last, views = now, views + 1
            if len(self.kept) < keep:
                self.kept.append((pose, rgb))
            if now - t0 >= seconds and views % cycle == 0:
                break
        return Window(units=views, seconds=last - t0,
                      rays=views * self.views.res**2,
                      memory_peak_bytes=peak_bytes())

    def blocks(self, n: int = 10) -> str:
        """Seconds of each view of the window, in order."""
        return " ".join(f"{t:.3f}" for t in self.view_s)

    def checked(self) -> list:
        """The kept views the reference renders: `checked_views` of
        them, drawn from the seed."""
        rng = np.random.default_rng(self.seed + VIEW_SEED_OFFSET)
        n = min(self.cell.traffic["checked_views"], len(self.kept))
        return sorted(int(i) for i in
                      rng.choice(len(self.kept), size=n, replace=False))

    def render_checked(self):
        """The program's render of the views a full window would check,
        alone (calibration): the window's kept views with only the
        checked ones rendered."""
        keep = self.cell.traffic["keep_views"]
        self.kept = [None] * keep
        for i in self.checked():
            pose = (self.first_view + i) % len(self.views)
            self.kept[i] = (pose, self.trainer.render_view(
                self.views.fetch_eval_view(pose)))
        sync()

    def reference(self, precision=rngp.Precision(), poses=None):
        """The reference's rgb of each checked view (or of `poses`), and
        the samples it composited."""
        s, dev = self.stage1, self.device
        if s["eval_renderer"] == "oneshot" or (
                s["eval_renderer"] == "auto"
                and s["eval_chunk"] * march_of(s, 1).max_steps <= 1 << 20):
            raise NotImplementedError("the reference renders with the "
                                      "evaluation's window renderer only")
        field = field_of(s, precision)
        aabb = torch.as_tensor(aabb_of(s), device=dev)
        march = march_of(s, 1 << 20)
        chunk = s["eval_chunk"]
        window_steps = int(np.clip((1 << 20) // chunk, 16, 256))
        params = rtrain.as_params(self.weights)
        if poses is None:
            poses = [self.kept[i][0] for i in self.checked()]
        out = []
        for pose in poses:
            data = self.views.fetch_eval_view(pose)
            o = torch.as_tensor(data["rays"].origins, device=dev)
            d = torch.as_tensor(data["rays"].viewdirs, device=dev)
            rgbs, samples = [], 0
            for i in range(0, o.shape[0], chunk):
                oc, dc = o[i:i + chunk], d[i:i + chunk]
                if oc.shape[0] < chunk:   # the program pads the last chunk
                    pad = chunk - oc.shape[0]
                    oc = torch.cat([oc, torch.zeros((pad, 3), device=dev)])
                    dc = torch.cat([dc, torch.tensor(
                        [[0.0, 0.0, 1.0]], device=dev).expand(pad, 3)])
                rgb, n = rrender.render_eval(field, params, aabb,
                                             self.binaries, oc, dc, march,
                                             window_steps)
                rgbs.append(rgb)
                samples += n
            out.append((pose, torch.cat(rgbs)[:o.shape[0]], samples))
        return out

    def readings(self, ref: list, prog: list | None = None) -> dict:
        """The kept views' readings against the reference's; `prog`
        (the control's views) puts another render in their place."""
        if prog is None:
            prog = [self.kept[i][1] for i in self.checked()]
        else:
            prog = [r for _, r, _ in prog]
        return check.render_readings(prog, [r for _, r, _ in ref])

    def as_program(self, other: list) -> list:
        return other


def make_run(cell, seed: int, device: str = "cuda") -> Run:
    loops = {"train": TrainRun, "render": RenderRun}
    return loops[cell.traffic["loop"]](cell, seed, device)
