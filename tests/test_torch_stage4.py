"""The port's stage 4 (train/stage4_finetune.py, cli/train_finetune.py)
against the JAX package's: Stage4Config field for field; the trainers
stepping in lockstep on the same NGP and deformation field (JAX's init
carried across), occupancy, mesh, rays, hits and noise (JAX's draws fed
to the port) across the freeze boundary, for the packed and the dense
hit transport; the mesh update's vertices; the evaluation's box
downsample against cv2.INTER_AREA. Then the port alone: the CLI chain
stage 1 -> 2 -> 3 -> 4 on the CPU, and save and load. The slow case
trains both packages' chain at tests/test_pipeline_full.py's settings
and prints the readings that chip_smoke.py's phase 8 gates."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.geometry.meshio import Mesh as JMesh
from quadraturefields_tpu.ops.grid import OccGridState as JOccGridState
from quadraturefields_tpu.train import stage4_finetune as jst4
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from quadraturefields_tpu_torch.train import stage4_finetune as tst4
from quadraturefields_tpu_torch.train.stage1_ngp import _as_leaf_params
from quadraturefields_tpu_torch.utils.batching import snap_pack_cap
from quadraturefields_tpu_torch.utils.convert import (
    field_params_from_jax,
    occ_state_from_jax,
    params_from_jax,
)
from test_torch_quadrature import (
    SMALL,
    assert_grads_match,
    leaves,
    sphere_mesh,
)
from test_torch_render_field import occupancy, rays

torch.set_num_threads(1)


class _Views:
    """A stand-in dataset that returns one fixed batch: the steps under
    test take their rays directly, and the prefetchers are stopped."""
    HEIGHT = WIDTH = 8

    def __init__(self, n=96):
        o, d = rays("synthetic", n)
        rng = np.random.default_rng(4)
        self.num_rays = n
        self.batch = {"rays": Rays(o, d),
                      "pixels": rng.uniform(0, 1, (n, 3)).astype(np.float32),
                      "color_bkgd": np.array([0.3, 0.6, 0.9], np.float32)}

    def __len__(self):
        return 1

    def update_num_rays(self, n):
        self.num_rays = n

    def fetch_train_batch(self):
        return self.batch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def trainers(pack_slack, freeze_rf_steps=2, **cell):
    """A JAX and a port stage-4 trainer at a small size (L4, T 2^12,
    f32 MLPs; `cell` may set the layout, payload, levels and features)
    on the same NGP (JAX's init, table scaled by 1e4), deformation field
    (JAX's init, table scaled by 1e3), fixture occupancy and sphere mesh
    (radius 0.5, 0.75 in the world); their prefetchers stopped."""
    kw = dict(SMALL, scene="fixture", batch_size_log2=13, max_hits=6,
              render_step_size=2e-2, freeze_rf_steps=freeze_rf_steps,
              max_steps=100, pack_slack=pack_slack, **cell)
    jcfg, tcfg = jst4.Stage4Config(**kw), tst4.Stage4Config(**kw)
    verts, faces = sphere_mesh()
    occs, binaries = occupancy("synthetic", jcfg.grid_resolution,
                               jcfg.render_step_size)
    from quadraturefields_tpu.models import ngp as jngp

    jn = jcfg.ngp_config()
    rf = jngp.ngp_init(jax.random.PRNGKey(1), jn)
    rf["table"] = rf["table"] * 1e4
    views = _Views()
    jtr = jst4.Stage4Trainer(
        jcfg, ngp_params=rf, mesh=JMesh(verts, faces), train_dataset=views,
        occ_state=JOccGridState(jnp.asarray(occs), jnp.asarray(binaries),
                                jnp.asarray(jcfg.aabb)))
    jtr.prefetcher.stop()
    jtr.params["field"]["table"] = jtr.params["field"]["table"] * 1e3
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.ngp_cfg = dataclasses.replace(jn, compute_dtype="float32")
    ttr = tst4.Stage4Trainer(
        tcfg, ngp_params=params_from_jax(_np(rf)), mesh=TMesh(verts, faces),
        occ_state=occ_state_from_jax(occs, binaries, jcfg.aabb),
        train_dataset=views, device="cpu")
    ttr.prefetcher.stop()
    ttr.params["field"] = _as_leaf_params(
        field_params_from_jax(_np(jtr.params["field"])))
    ttr._make_optimizer()
    ttr.ngp_cfg = dataclasses.replace(ttr.ngp_cfg, compute_dtype="float32")
    return jtr, ttr, views.batch


def hit_args(jtr, ttr, batch):
    """Both trainers' hit_args of one batch, cast by the JAX trainer's
    BVH (the same C++ source as the port's): the packed stream sliced to
    its bucket, or the dense rows and their face vertices."""
    o, d = batch["rays"]
    mi = jtr.mesh_intersect
    if jtr._packed:
        cap = jtr.cfg.pack_cap
        slots, tri, ts, total = mi.intersect_packed(o, d, cap)
        b = snap_pack_cap(total, cap)
        return total, (
            (jnp.asarray(slots[:b]), jnp.asarray(tri[:b]),
             jnp.asarray(ts[:b]), jnp.asarray(np.int32(total)),
             jtr.face_verts_dev),
            (torch.as_tensor(slots[:b]), torch.as_tensor(tri[:b]),
             torch.as_tensor(ts[:b]), total, ttr.face_verts_dev))
    tri, ts, valid = mi.intersect_rows(o, d)
    fv = mi.face_vertices(tri)
    return int(valid.sum()), (
        tuple(jnp.asarray(a) for a in (tri, ts, valid, fv)),
        tuple(torch.as_tensor(a) for a in (tri, ts, valid, fv)))


def _rf_update_rel(before, after_t, after_j):
    """|port update - JAX update| / |JAX update| over the rf leaves."""
    num = den = 0.0
    for (_, b), (_, t), (_, j) in zip(leaves(before), leaves(after_t),
                                      leaves(after_j)):
        dt = t.detach().numpy() - b
        dj = np.asarray(j) - b
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / den) ** 0.5


# the cell layout (--layout cell): run_nerfsynthetic_tpu_fast.sh's rf,
# tet L8 F4, with its bf16factor payload and with the CLI's default f32;
# the deformation field takes the layout and the payload at L16 F2
_CELL = dict(layout="cell", interp="tet", n_levels=8, n_features=4)


@pytest.mark.parametrize("pack_slack,cell", [
    pytest.param(1.25, {}, id="1.25"),
    pytest.param(0.0, {}, id="0.0"),
    pytest.param(1.25, dict(_CELL, grad_payload="bf16factor"),
                 id="cell-bf16factor"),
    pytest.param(1.25, dict(_CELL, grad_payload="f32"), id="cell-f32"),
])
def test_trainer_steps_in_lockstep_with_jax(pack_slack, cell):
    """Four steps of each trainer's _train_step_impl on the same batch,
    hits and JAX noise (the twin's stratified jitter and the barycentric
    uniforms of jax.random.uniform(key, ...)), freeze_rf_steps 2. Each
    step's loss within 1e-5 relative of JAX's _loss_fn run eagerly on
    the same state (JAX's jitted step lands up to ~1.05e-5 from its own
    eager forward on one of these steps: XLA's fused rounding), its hit
    count equal. Each step's gradients, before the update, against
    jax.grad of that _loss_fn: every field leaf on the frozen steps and
    the first joint step, and every rf leaf on that joint step, within
    1e-4 of max (measured <= 6.5e-5); on the second joint step within
    1e-4 of jax.grad at the port's own state, and within 1e-2 of JAX's
    at its state as a drift bound (measured 1.3e-3: the states carry
    Adam's first joint update, which moves tiny rf gradients by
    ~lr * sign(g) where their signs differ). In the cell layout JAX's
    steps run eagerly: jitted, XLA's fusion moves JAX's own rf table
    gradient at the second joint step 1.7e-2 of max from its eager
    run's, from which the port lies 4.5e-5. The field table within
    2.0001 lr of JAX's after every step (Adam's first steps move an
    entry by ~lr * sign(g)); the rf unmoved while frozen,
    its Adam step count 3 at the first joint step (optax's shared count;
    torch's per-parameter count would say 1 had the frozen steps given
    no gradient, and its update would be ~1.6x JAX's), and its updates
    within 15% of JAX's in L2 (5% measured: Adam moves a tiny gradient
    by ~lr * sign(g), and the signs of some flip; the trap gives >50%);
    the per-face caches within 1e-4 of max (dh carries the field's
    drift). The same holds in the cell layout, where the CPU routes
    both payloads' table gradients to f32 rows, as JAX does off an
    accelerator."""
    jtr, ttr, batch = trainers(pack_slack, **cell)
    total, (jhit, thit) = hit_args(jtr, ttr, batch)
    assert total > 100
    o, d = batch["rays"]
    args = [batch["pixels"], batch["color_bkgd"]]
    tb = [torch.as_tensor(a) for a in (o, d, *args)]
    jb = [jnp.asarray(a) for a in (o, d, *args)]
    R, H = o.shape[0], jtr.cfg.max_hits
    for step in range(4):
        freeze = step < 2
        key = jax.random.PRNGKey(100 + step)
        t_jitter = torch.as_tensor(np.array(jax.random.uniform(key, (R,))))
        bary = torch.as_tensor(np.array(jax.random.uniform(key, (R, H, 3))))
        rf_before = _np(jtr.params["rf"])
        (jl, _), jg = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jtr.params, jtr.occ_state, *jb, jhit, key, freeze)
        if step == 3:
            # JAX's gradient at the port's own state, which Adam's first
            # joint update has moved from JAX's
            at_port = jax.tree_util.tree_map(
                lambda t: jnp.asarray(t.detach().numpy()), ttr.params)
            jg_port = jax.grad(jtr._loss_fn, has_aux=True)(
                at_port, jtr.occ_state, *jb, jhit, key, freeze)[0]
        fn = jtr._train_step_frozen if freeze else jtr._train_step_joint
        with jax.disable_jit(bool(cell)):
            (jtr.params, jtr.opt_state, jtr.cache_d, jtr.cache_w, _, jnh,
             _) = fn(jtr.params, jtr.opt_state, jtr.occ_state, jtr.cache_d,
                     jtr.cache_w, *jb, jhit, key)
        lr = float(ttr.optimizer.param_groups[0]["lr"])
        tl, tnh, _ = ttr._train_step_impl(*tb, thit, t_jitter, bary,
                                          freeze_rf=freeze)
        assert int(tnh) == int(jnh) == total
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"step {step}")
        if step < 3:
            assert_grads_match(ttr.params["field"], jg["field"])
            if not freeze:
                assert_grads_match(ttr.params["rf"], jg["rf"])
        else:
            for part in ("field", "rf"):
                assert_grads_match(ttr.params[part], jg_port[part])
                assert_grads_match(ttr.params[part], jg[part], 1e-2)
        jt = np.asarray(jtr.params["field"]["table"])
        tt = ttr.params["field"]["table"].detach().numpy()
        assert np.abs(tt - jt).max() <= 2.0001 * lr, step
        rf_t = ttr.params["rf"]
        if freeze:
            for (name, b), (_, t) in zip(leaves(rf_before), leaves(rf_t)):
                assert np.array_equal(t.detach().numpy(), b), name
        else:
            assert _rf_update_rel(rf_before, rf_t, jtr.params["rf"]) < 0.15
        counts = {int(ttr.optimizer.state[p]["step"])
                  for _, p in leaves(rf_t)}
        assert counts == {step + 1} == {int(jtr.opt_state[0].count)}
    for t, j in ((ttr.cache_d, jtr.cache_d), (ttr.cache_w, jtr.cache_w)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
    assert float(ttr.cache_w.max()) > 1e-2


def test_apply_mesh_update_matches_jax(tmp_path):
    """After two steps on the same inputs, apply_mesh_update moves the
    vertices as JAX's does (within 1e-6), writes mesh.ply, resets the
    caches and refreshes the face table."""
    jtr, ttr, batch = trainers(1.25)
    _, (jhit, thit) = hit_args(jtr, ttr, batch)
    o, d = batch["rays"]
    args = [batch["pixels"], batch["color_bkgd"]]
    R, H = o.shape[0], jtr.cfg.max_hits
    for step in range(2):
        key = jax.random.PRNGKey(step)
        (jtr.params, jtr.opt_state, jtr.cache_d, jtr.cache_w, *_) = \
            jtr._train_step_frozen(
                jtr.params, jtr.opt_state, jtr.occ_state, jtr.cache_d,
                jtr.cache_w, *(jnp.asarray(a) for a in (o, d, *args)),
                jhit, key)
        ttr._train_step_impl(
            *(torch.as_tensor(a) for a in (o, d, *args)), thit,
            torch.as_tensor(np.array(jax.random.uniform(key, (R,)))),
            torch.as_tensor(np.array(jax.random.uniform(key, (R, H, 3)))),
            freeze_rf=True)
    before = ttr.mesh_intersect.mesh.vertices.copy()
    jtr.apply_mesh_update()
    ttr.apply_mesh_update(str(tmp_path))
    got = ttr.mesh_intersect.mesh.vertices
    np.testing.assert_allclose(got, jtr.mesh_intersect.mesh.vertices,
                               rtol=0, atol=1e-6)
    assert np.abs(got - before).max() > 1e-5
    assert os.path.exists(tmp_path / "mesh.ply")
    assert float(ttr.cache_d.abs().max()) == 0.0
    np.testing.assert_array_equal(
        ttr.face_verts_dev.numpy(), got[ttr.mesh_intersect.mesh.faces])


def test_stage4_config_matches_jax():
    """Stage4Config field for field, and the configs it derives (NGP,
    field, render) and its properties, for a synthetic and a 360
    scene."""
    from quadraturefields_tpu_torch.render.renderer import RenderConfig

    names = [f.name for f in dataclasses.fields(jst4.Stage4Config)]
    assert [f.name for f in dataclasses.fields(tst4.Stage4Config)] == names
    for kw in (dict(), dict(scene="garden"), dict(pack_slack=0.0)):
        j, t = jst4.Stage4Config(**kw), tst4.Stage4Config(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("is_unbounded", "target_sample_batch_size", "pack_cap",
                     "eff_render_step_size", "eff_near_plane",
                     "eff_far_plane", "eff_alpha_thre", "eff_cone_angle"):
            assert getattr(t, prop) == getattr(j, prop), prop
        np.testing.assert_array_equal(t.aabb, j.aabb)
        for derived in ("ngp_config", "field_config"):
            assert dataclasses.asdict(getattr(t, derived)()) == \
                dataclasses.asdict(getattr(j, derived)()), derived
        assert t.render_config() == RenderConfig(
            **dataclasses.asdict(j.render_config()))
    fc = tst4.Stage4Config().field_config()
    assert (fc.log2_hashmap_size, fc.n_levels, fc.hidden_size, fc.nl,
            fc.output_dim) == (24, 16, 32, "relu", 1)
    assert fc.hashgrid.total_entries == 101_626_144


def test_evaluate_downsample_matches_cv2_inter_area():
    """evaluate() box-averages the up_sample x render back to the
    dataset's resolution: its PSNR and SSIM equal those of
    cv2.resize(..., INTER_AREA) of the same render (integer factors 2
    and 3), within 1e-5."""
    import cv2

    from quadraturefields_tpu_torch.utils.metrics import psnr, ssim

    _, ttr, _ = trainers(1.25)
    rng = np.random.default_rng(0)
    for u, (h, w) in ((2, (24, 18)), (3, (15, 14))):
        img = rng.uniform(0, 1, (h * u, w * u, 3)).astype(np.float32)
        pixels = rng.uniform(0, 1, (h * w, 3)).astype(np.float32)

        class View:
            HEIGHT, WIDTH = h * u, w * u

            def __len__(self):
                return 1

            def fetch_eval_view(self, i):
                return {"pixels": pixels}

        ttr.cfg.up_sample = u
        ttr.render_view = lambda data: torch.as_tensor(img.reshape(-1, 3))
        got = ttr.evaluate(View())
        want = torch.as_tensor(
            cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
        ref = torch.as_tensor(pixels.reshape(h, w, 3))
        assert got["psnr"] == pytest.approx(float(psnr(want, ref)),
                                            abs=1e-5)
        assert got["ssim"] == pytest.approx(float(ssim(want, ref)),
                                            abs=1e-5)


def test_cli_chain_stage1_to_stage4(tmp_path, monkeypatch):
    """The port's CLIs chained on the CPU as the scripts chain them: the
    stage-1 checkpoint feeds stage 2, whose export feeds stage 3's two
    CLIs, whose smp_mesh.ply and the stage-1 checkpoint feed stage 4
    (run_nerfsynthetic_finetune.sh's flags at tiny widths, 4 steps, 2
    frozen, a mesh update at step 2). Stage 4 writes mesh.ply and
    finetune.pt; a new trainer loads the checkpoint (both fields, Adam,
    the step) and steps on; --num_devices 2 without a process group is
    refused. No flag sets the occupancy grid, the freeze or the update
    interval, so the configs the CLIs build get them patched in (a 32^3
    grid)."""
    from quadraturefields_tpu_torch.cli import downsample_mesh as tcli_ds
    from quadraturefields_tpu_torch.cli import marching_cubes as tcli_mc
    from quadraturefields_tpu_torch.cli import train_field as tcli2
    from quadraturefields_tpu_torch.cli import train_finetune as tcli4
    from quadraturefields_tpu_torch.cli import train_ngp as tcli1
    from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
    from quadraturefields_tpu_torch.geometry.meshio import load_ply
    from quadraturefields_tpu_torch.train import stage1_ngp as tst1
    from quadraturefields_tpu_torch.train import stage2_field as tst2

    monkeypatch.setattr(tcli1, "Stage1Config", functools.partial(
        tst1.Stage1Config, grid_resolution=32, eval_chunk=256,
        ckpt_every=3))
    monkeypatch.setattr(tcli2, "Stage2Config", functools.partial(
        tst2.Stage2Config, grid_resolution=32))
    monkeypatch.setattr(tcli4, "Stage4Config", functools.partial(
        tst4.Stage4Config, grid_resolution=32, freeze_rf_steps=2,
        mesh_update_every=2, field_max_res=32, max_num_rays=1 << 12))
    data = str(tmp_path / "data")
    write_fixture_dataset(data, res=16, n_train=2, n_test=1)
    runs = str(tmp_path / "runs")
    common = ["--scene", "fixture", "--data_root", data, "--root", runs,
              "--num_lobes", "0", "--log2_hashmap_size", "10"]
    tcli1.main(common + ["--exp_name", "nerf", "--batch_size", "12",
                         "--max_steps", "3"], device="cpu")
    ckpt = os.path.join(runs, "ckpts", "fixture", "nerf", "ngp.pt")
    tcli2.main(common + ["--ckpt_path", ckpt, "--batch_size", "12",
                         "--max_steps", "3", "--field_log2_hashmap_size",
                         "10", "--grid_export_size", "24"], device="cpu")
    field = os.path.join(runs, "results", "fixture", "field")
    tcli_mc.main([field, "100.0", "True", "30", "0", "0", "True", "1e-4",
                  "5.0"], device="cpu")
    tcli_ds.main([os.path.join(field, "mesh.ply"), "150"], device="cpu")
    mesh_path = os.path.join(field, "smp_mesh.ply")
    assert load_ply(mesh_path).faces.shape[0] > 100
    argv = common + ["--ckpt_path", ckpt, "--mesh_path", mesh_path,
                     "--scaling", "0.0434", "--up_sample", "2.0",
                     "--voxel_size", "150", "--max_hits", "25",
                     "--num_layers", "2", "--max_iterations", "3",
                     "--batch_size", "11", "--scale", "1.5"]
    tcli4.main(argv, device="cpu")
    out = os.path.join(runs, "results", "fixture", "finetune", "mesh.ply")
    assert load_ply(out).faces.shape == load_ply(mesh_path).faces.shape
    path = os.path.join(runs, "ckpts", "fixture", "finetune",
                        "finetune.pt")
    state = torch.load(path, weights_only=True)
    assert state["step"] == 4

    cfg = tst4.Stage4Config(
        scene="fixture", data_root=data, ckpt_path=ckpt, mesh_path=mesh_path,
        num_lobes=0, log2_hashmap_size=10, grid_resolution=32,
        field_max_res=32, max_steps=3, batch_size_log2=11)
    other = tst4.Stage4Trainer(cfg, device="cpu")
    try:
        other.load(path)
        assert other.step == 4
        assert torch.equal(other.params["field"]["table"],
                           state["field_model"]["table"])
        assert torch.equal(other.params["rf"]["table"],
                           state["radiance_field"]["table"])
        exp_avg = other.optimizer.state_dict()["state"][0]["exp_avg"]
        assert torch.equal(exp_avg, state["opt_state"]["state"][0]["exp_avg"])
        loss, nh, mse = other.train_one_step()
        assert np.isfinite(float(loss)) and nh > 0 and other.step == 5
    finally:
        other.prefetcher.stop()
    # no torchrun process group: the trainer refuses num_devices 2
    with pytest.raises(RuntimeError, match="torchrun"):
        tcli4.main(argv + ["--num_devices", "2"], device="cpu")


@pytest.mark.slow
def test_stage34_quality_gates_on_the_cpu(tmp_path):
    """Both packages' chain at tests/test_pipeline_full.py's settings
    (stage 1: 220 steps at 2^13 samples on a 40^2 fixture; stage 2: 120
    steps, field log2_T 14, a 48^3 export; stage 3 with
    run_nerfsynthetic_mc.sh's thresholds and with the pipeline test's;
    stage 4: 50 steps, 20 frozen, a mesh update at step 30), each from
    its own stage-1 run. Prints the faces each threshold set leaves, the
    extracted mesh's median radius, the stage-4 loss's mean over its
    first and last 20 steps and the eval PSNR of one view: chip_smoke.py
    phase 8 set STAGE3_ARGS and its gates (STAGE3_RADIUS,
    FINETUNE_PSNR_GATE) from them, and each package must pass those
    gates here."""
    from chip_smoke import FINETUNE_PSNR_GATE, STAGE3_ARGS, STAGE3_RADIUS
    from quadraturefields_tpu.data.fixture import (
        write_fixture_dataset as jax_write_fixture,
    )
    from quadraturefields_tpu.data.nerf_synthetic import (
        SubjectLoader as JLoader,
    )
    from quadraturefields_tpu.geometry import extract as jex
    from quadraturefields_tpu.train import stage1_ngp as jst1
    from quadraturefields_tpu.train import stage2_field as jst2
    from quadraturefields_tpu_torch.data.nerf_synthetic import (
        SubjectLoader as TLoader,
    )
    from quadraturefields_tpu_torch.geometry import extract as tex
    from quadraturefields_tpu_torch.train import stage1_ngp as tst1
    from quadraturefields_tpu_torch.train import stage2_field as tst2

    data = str(tmp_path / "data")
    jax_write_fixture(data, res=40, n_train=8, n_test=2)
    s1 = dict(scene="fixture", data_root=data, max_steps=220,
              init_batch_size=512, batch_size_log2=13, grid_resolution=32,
              render_step_size=2e-2, num_lobes=0, eval_chunk=2048,
              ckpt_every=10**9, log_every=10**9)
    s2 = dict(scene="fixture", data_root=data, max_steps=120,
              batch_size_log2=13, grid_resolution=32, render_step_size=2e-2,
              num_lobes=0, field_log2_hashmap_size=14, field_max_res=64,
              grid_export_size=48, ckpt_every=10**9, log_every=10**9)
    s4 = dict(scene="fixture", data_root=data, max_steps=50,
              init_batch_size=512, batch_size_log2=12, grid_resolution=32,
              render_step_size=2e-2, num_lobes=0, up_sample=1, max_hits=8,
              freeze_rf_steps=20, mesh_update_every=30, ckpt_every=10**9,
              log_every=10**9, scaling=0.02, max_num_rays=1 << 13,
              field_log2_hashmap_size=14, field_max_res=64)
    script = dict(sigma=100.0, include_grad=True, omega=100.0, thres=0.0,
                  combine=True, grad_thres=0.01, density_thres=10.0)
    chosen = dict(sigma=float(STAGE3_ARGS[0]),
                  include_grad=STAGE3_ARGS[1] == "True",
                  omega=float(STAGE3_ARGS[2]), thres=float(STAGE3_ARGS[3]),
                  combine=STAGE3_ARGS[5] == "True",
                  grad_thres=float(STAGE3_ARGS[6]),
                  density_thres=float(STAGE3_ARGS[7]))
    results = {}
    for name, m1, m2, m4, ex, loader, kw, ekw in (
        ("jax", jst1, jst2, jst4, jex, JLoader, {}, {}),
        ("port", tst1, tst2, tst4, tex, TLoader, dict(device="cpu"),
         dict(device="cpu")),
    ):
        root = str(tmp_path / name)
        t1 = m1.Stage1Trainer(m1.Stage1Config(root=root, **s1), **kw)
        while t1.step <= 220:
            t1.train_one_step()
        t2 = m2.Stage2Trainer(m2.Stage2Config(root=root, **s2),
                              ngp_params=t1.params, occ_state=t1.occ_state,
                              **kw)
        while t2.step <= 120:
            t2.train_one_step()
        out = os.path.join(root, "export")
        t2.export_artifacts(out)
        faces = {}
        for label, args in (("script", script), ("chosen", chosen)):
            m = ex.extract_mesh(out, save=False, **args, **ekw)
            quad = ex.extract_mesh(out, save=False, **dict(args,
                                                          combine=False),
                                   **ekw)
            faces[label] = (quad.faces.shape[0], m.faces.shape[0])
        mesh = ex.extract_mesh(out, **chosen, **ekw)
        smp = ex.downsample_mesh(mesh, vx=float(STAGE3_ARGS[8]))
        radius = float(np.median(np.linalg.norm(mesh.vertices * 1.5,
                                                axis=1)))
        t4 = m4.Stage4Trainer(m4.Stage4Config(root=root, **s4),
                              ngp_params=t1.params, occ_state=t1.occ_state,
                              mesh=smp, **kw)
        losses = []
        while t4.step <= 50:
            losses.append(float(t4.train_one_step()[0]))
            if t4.step == 30:
                t4.apply_mesh_update()
        t4.prefetcher.stop()
        test = loader(subject_id="fixture", root_fp=data, split="test",
                      num_rays=None)
        psnr = t4.evaluate(test, n_views=1)["psnr"]
        first, last = np.mean(losses[:20]), np.mean(losses[-20:])
        results[name] = (first, last, psnr, radius, smp)
        print(f"{name}: stage 3 quadrature/combined faces with the "
              f"script's thresholds {faces['script']}, with "
              f"{STAGE3_ARGS} {faces['chosen']}; median radius {radius:.3f}"
              f", smp_mesh {smp.vertices.shape[0]} of "
              f"{mesh.vertices.shape[0]} vertices; stage-4 loss first 20 "
              f"{first:.6f}, last 20 {last:.6f}; eval PSNR {psnr:.3f}")
    for name, (first, last, psnr, radius, smp) in results.items():
        assert np.isfinite([first, last]).all(), name
        assert last < first, name
        assert psnr >= FINETUNE_PSNR_GATE, name
        assert STAGE3_RADIUS[0] < radius < STAGE3_RADIUS[1], name
        assert smp.faces.shape[0] > 0, name
