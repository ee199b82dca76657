"""The port's stage 5 (render/quadrature.py's SG renderers,
train/stage5_fit_sg.py, cli/train_fit_sg.py) against the JAX package's:
the four SG renderers on the same SG model and teacher (JAX's init
carried across with utils/convert.py), hits and background, forward and
the SG model's gradients; Stage5Config field for field; the trainers
stepping in lockstep for 8 steps on the same weights, hits and batches
for the packed and the dense hit transport; params_from_jax on the
45-output SG head. Then the port alone: save and load, and the CLI
chain stage 4 -> stage 5 on the CPU."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.geometry.meshio import Mesh as JMesh
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops.grid import OccGridState as JOccGridState
from quadraturefields_tpu.render import quadrature as jq
from quadraturefields_tpu.train import stage5_fit_sg as jst5
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.render import quadrature as tq
from quadraturefields_tpu_torch.train import stage5_fit_sg as tst5
from quadraturefields_tpu_torch.train.stage1_ngp import _as_leaf_params
from quadraturefields_tpu_torch.utils.batching import snap_pack_cap
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)
from test_torch_quadrature import (
    _j_rgb_sigma,
    _t_rgb_sigma,
    assert_grads_match,
    hits_inputs,
    host_pack,
    leaves,
    sphere_mesh,
)
from test_torch_render_field import occupancy

torch.set_num_threads(1)

# L4, T 2^12, 2 lobes, 8 hits a ray
SMALL = dict(n_levels=4, log2_hashmap_size=12, num_lobes=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def sg_models(compute_dtype="float32"):
    """(JAX {"sg", "teacher"}, port leaf params of the same, configs
    (jax sg, jax teacher), (port sg, port teacher), aabb): Stage5Config's
    SG model and teacher at SMALL, JAX's init with each table scaled by
    1e4, carried across."""
    jcfg, tcfg = jst5.Stage5Config(**SMALL), tst5.Stage5Config(**SMALL)
    jcfgs = tuple(dataclasses.replace(c, compute_dtype=compute_dtype)
                  for c in (jcfg.sg_config(), jcfg.teacher_config()))
    tcfgs = tuple(dataclasses.replace(c, compute_dtype=compute_dtype)
                  for c in (tcfg.sg_config(), tcfg.teacher_config()))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = {"sg": jngp.ngp_init(k1, jcfgs[0]),
          "teacher": jngp.ngp_init(k2, jcfgs[1])}
    for p in jp.values():
        p["table"] = p["table"] * 1e4
    tp = {k: _as_leaf_params(params_from_jax(_np(v)))
          for k, v in jp.items()}
    return jp, tp, jcfgs, tcfgs, jcfg.aabb


@pytest.mark.parametrize("route", ["rows", "packed", "packed_trunc",
                                   "stream", "baking_rows"])
def test_sg_renderers_match_jax(route):
    """render_fit_sg_rows, render_fit_sg_packed (with and without
    truncation), render_fit_sg_packed_stream and
    render_finetune_baking_rows on the same f32 SG model, teacher, hits
    (8 a ray, equal-depth ties included) and background: rgb, alpha,
    depth and weights within 1e-5 of max, the ray mask equal; then a
    loss of rgb and depth: every SG gradient within 1e-5 of max of
    JAX's. The teacher gets no gradient in the port (no graph) and
    zeros in JAX (stop_gradient). The step is 0.25, so that the
    untrained teacher's alphas lie well inside (0, 1) as a trained
    teacher's do: at a 5e-3 step they are ~4e-3, and 1 - exp(-tau)
    rounds to a few ulps of 1 in each package. JAX runs eagerly."""
    h = hits_inputs(max_hits=8)
    R, H = h["tri"].shape
    cap = 37 if route.endswith("trunc") else R * H
    jp, tp, jcfgs, tcfgs, aabb = sg_models()
    rng = np.random.default_rng(11)
    cot_rgb = rng.normal(size=(R, 3)).astype(np.float32)
    cot_depth = rng.normal(size=(R, 1)).astype(np.float32)
    bary = rng.uniform(0.1, 1, (R, H, 3)).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    bkgd = np.array([0.3, 0.6, 0.9], np.float32)

    def run(mod, ngp_mod, params, pack, fwd, cfgs):
        kw = dict(render_step_size=0.25, bg_color="random",
                  render_bkgd=pack(bkgd))
        hits = mod.HitRows(pack(h["tri"]), pack(h["ts"]), pack(h["valid"]))
        args = (params["sg"], params["teacher"])
        if route == "rows":
            out = mod.render_fit_sg_rows(
                *args, hits, pack(h["o"]), pack(h["d"]), pack(aabb), *cfgs,
                ngp_forward_fn=fwd, **kw)
        elif route.startswith("packed"):
            out = mod.render_fit_sg_packed(
                *args, hits, pack(h["o"]), pack(h["d"]), pack(aabb), *cfgs,
                ngp_forward_fn=fwd, pack_cap=cap, **kw)
        elif route == "stream":
            slots, tri, t, total = host_pack(h["tri"], h["ts"], cap)
            ph = mod.packed_hits_from_host(pack(slots), pack(tri), pack(t),
                                           total, R, H)
            out = mod.render_fit_sg_packed_stream(
                *args, ph, R, pack(h["o"]), pack(h["d"]), pack(aabb),
                *cfgs, ngp_forward_fn=fwd, **kw)
        else:
            out = mod.render_finetune_baking_rows(
                params["sg"], hits, pack(h["o"]), pack(h["d"]),
                pack(h["fv"]), pack(bary), pack(aabb), cfgs[0],
                features_fn=ngp_mod.ngp_features,
                features_to_rgb_fn=ngp_mod.ngp_features_to_rgb, **kw)
        return out

    def jloss(params):
        out = run(jq, jngp, params, jnp.asarray, _j_rgb_sigma, jcfgs)
        return (jnp.sum(out[0] * cot_rgb)
                + jnp.sum(out[2] * cot_depth)), out

    # eager, op by op: under jit XLA fuses the hit positions' multiply-add,
    # whose ulps the finest level (resolution 4096) magnifies ~1e3-fold
    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tout = run(tq, tngp, tp, torch.as_tensor, _t_rgb_sigma, tcfgs)
    tl = ((tout[0] * torch.as_tensor(cot_rgb)).sum()
          + (tout[2] * torch.as_tensor(cot_depth)).sum())
    tl.backward()
    for i, name in enumerate(("rgb", "alpha", "depth", "weights")):
        want = np.asarray(jout[i])
        err = np.abs(tout[i].detach().numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)
    if route.startswith("packed") or route == "stream":
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
        assert (not np.asarray(jout[5]).all()) == route.endswith("trunc")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_match(tp["sg"], jg["sg"], rtol=1e-5)
    assert all(p.grad is None for _, p in leaves(tp["teacher"]))
    assert not any(np.asarray(g).any() for _, g in leaves(jg["teacher"]))


def test_stage5_config_matches_jax():
    """Stage5Config field for field, its properties and the SG and
    teacher configs it derives, for a synthetic and a 360 scene and the
    dense transport."""
    names = [f.name for f in dataclasses.fields(jst5.Stage5Config)]
    assert [f.name for f in dataclasses.fields(tst5.Stage5Config)] == names
    for kw in (dict(), dict(scene="garden"), dict(pack_slack=0.0),
               dict(num_lobes=3, batch_size_log2=16)):
        j, t = jst5.Stage5Config(**kw), tst5.Stage5Config(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("is_unbounded", "target_sample_batch_size", "pack_cap",
                     "eff_render_step_size"):
            assert getattr(t, prop) == getattr(j, prop), prop
        np.testing.assert_array_equal(t.aabb, j.aabb)
        for derived in ("sg_config", "teacher_config"):
            assert dataclasses.asdict(getattr(t, derived)()) == \
                dataclasses.asdict(getattr(j, derived)()), derived
    sg = tst5.Stage5Config().sg_config()
    assert sg.head_output_dim == 45 and sg.hashgrid.total_entries == \
        6_299_960
    assert tst5.Stage5Config().pack_cap == 327_680


def test_params_from_jax_carries_the_45_output_sg_head():
    """params_from_jax on JAX's init of the scripts' SG model (6 lobes,
    2 head layers; the head's last layer 64 -> 45): every leaf's shape
    and values, and the port's forward, features and decode within 1e-5
    of JAX's (f32 MLPs) at the same points."""
    cfg = dataclasses.replace(jst5.Stage5Config(n_levels=4,
                                                log2_hashmap_size=12)
                              .sg_config(), compute_dtype="float32")
    tcfg = dataclasses.replace(tst5.Stage5Config(n_levels=4,
                                                 log2_hashmap_size=12)
                               .sg_config(), compute_dtype="float32")
    jp = jngp.ngp_init(jax.random.PRNGKey(5), cfg)
    jp["table"] = jp["table"] * 1e4
    tp = params_from_jax(_np(jp))
    for (name, t), (_, j) in zip(leaves(tp), leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    assert tp["mlp_head"]["layers"][-1]["w"].shape[1] == 45
    assert tp["mlp_head"]["layers"][-1]["b"].shape == (45,)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.4, 1.4, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aabb = np.array([-1.5] * 3 + [1.5] * 3, np.float32)
    jrgb, jdens = jngp.ngp_forward(jp, jnp.asarray(x), jnp.asarray(d),
                                   jnp.asarray(aabb), cfg)
    trgb, tdens = tngp.ngp_forward(tp, torch.as_tensor(x),
                                   torch.as_tensor(d),
                                   torch.as_tensor(aabb), tcfg)
    jf = jngp.ngp_features(jp, jnp.asarray(x), jnp.asarray(aabb), cfg)
    tf = tngp.ngp_features(tp, torch.as_tensor(x), torch.as_tensor(aabb),
                           tcfg)
    assert tf.shape == (256, 46)
    for t, j in ((trgb, jrgb), (tdens, jdens), (tf, jf)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-5 * max(np.abs(j).max(),
                                                         1.0)
    np.testing.assert_allclose(
        tngp.ngp_features_to_rgb(tf[:, :-1], torch.as_tensor(d),
                                 tcfg).numpy(),
        np.asarray(jngp.ngp_features_to_rgb(jf[:, :-1], jnp.asarray(d),
                                            cfg)), atol=1e-5)
    old = rng.normal(size=(64, jngp.ngp_sg_old_head_output_dim(2))) \
        .astype(np.float32)
    assert tngp.ngp_sg_old_head_output_dim(2) == 33
    np.testing.assert_allclose(
        tngp.ngp_sg_old_features_to_rgb(torch.as_tensor(old),
                                        torch.as_tensor(d[:64]), 2).numpy(),
        np.asarray(jngp.ngp_sg_old_features_to_rgb(
            jnp.asarray(old), jnp.asarray(d[:64]), 2)), atol=1e-6)


class _Views:
    """A stand-in dataset that returns one fixed batch: the steps under
    test take their rays directly, and the prefetchers are stopped."""
    HEIGHT = WIDTH = 8

    def __init__(self, n=64):
        rng = np.random.default_rng(4)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        self.num_rays = n
        self.batch = {"rays": Rays(np.zeros((n, 3), np.float32), d),
                      "pixels": rng.uniform(0, 1, (n, 3)).astype(np.float32),
                      "color_bkgd": np.ones(3, np.float32)}

    def __len__(self):
        return 1

    def update_num_rays(self, n):
        self.num_rays = n

    def fetch_train_batch(self):
        return self.batch


def trainers(pack_slack):
    """A JAX and a port stage-5 trainer at SMALL (f32 MLPs, 8 hits a
    ray, 2^12 sample target) on the same teacher and SG model (JAX's
    init, tables scaled by 1e4), fixture occupancy and sphere mesh;
    their prefetchers stopped."""
    kw = dict(SMALL, scene="fixture", batch_size_log2=12, max_hits=8,
              render_step_size=2e-2, grid_resolution=32, max_steps=100,
              pack_slack=pack_slack)
    jcfg, tcfg = jst5.Stage5Config(**kw), tst5.Stage5Config(**kw)
    verts, faces = sphere_mesh()
    occs, binaries = occupancy("synthetic", 32, jcfg.render_step_size)
    teacher = jngp.ngp_init(jax.random.PRNGKey(1), jcfg.teacher_config())
    teacher["table"] = teacher["table"] * 1e4
    views = _Views()
    jtr = jst5.Stage5Trainer(
        jcfg, teacher_params=teacher, mesh=JMesh(verts, faces),
        train_dataset=views,
        occ_state=JOccGridState(jnp.asarray(occs), jnp.asarray(binaries),
                                jnp.asarray(jcfg.aabb)))
    jtr.prefetcher.stop()
    jtr.sg_params["table"] = jtr.sg_params["table"] * 1e4
    jtr.opt_state = jtr.optimizer.init(jtr.sg_params)
    jtr.sg_cfg = dataclasses.replace(jtr.sg_cfg, compute_dtype="float32")
    jtr.teacher_cfg = dataclasses.replace(jtr.teacher_cfg,
                                          compute_dtype="float32")
    ttr = tst5.Stage5Trainer(
        tcfg, teacher_params=params_from_jax(_np(teacher)),
        mesh=TMesh(verts, faces),
        occ_state=occ_state_from_jax(occs, binaries, jcfg.aabb),
        train_dataset=views, device="cpu")
    ttr.prefetcher.stop()
    ttr.sg_params = _as_leaf_params(params_from_jax(_np(jtr.sg_params)))
    ttr._make_optimizer()
    ttr.sg_cfg = dataclasses.replace(ttr.sg_cfg, compute_dtype="float32")
    ttr.teacher_cfg = dataclasses.replace(ttr.teacher_cfg,
                                          compute_dtype="float32")
    return jtr, ttr


def step_inputs(jtr, ttr, step, n=64):
    """Step `step`'s batch (rays from a sphere of radius 2.8 towards the
    mesh, seeded pixels and background) and its hits cast by the JAX
    trainer's BVH (the same C++ source as the port's): the packed
    stream sliced to its bucket, or the dense rows; for both trainers."""
    rng = np.random.default_rng(100 + step)
    o = rng.normal(size=(n, 3))
    o = (2.8 * o / np.linalg.norm(o, axis=1, keepdims=True))
    d = rng.uniform(-0.4, 0.4, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    pixels = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    bkgd = rng.uniform(0, 1, 3).astype(np.float32)
    mi = jtr.mesh_intersect
    if jtr._packed:
        cap = jtr.cfg.pack_cap
        slots, tri, ts, total = mi.intersect_packed(o, d, cap)
        b = snap_pack_cap(total, cap)
        jhit = (jnp.asarray(slots[:b]), jnp.asarray(tri[:b]),
                jnp.asarray(ts[:b]), jnp.asarray(np.int32(total)))
        thit = (torch.as_tensor(slots[:b]), torch.as_tensor(tri[:b]),
                torch.as_tensor(ts[:b]), total)
    else:
        tri, ts, valid = mi.intersect_rows(o, d)
        total = int(valid.sum())
        jhit = tuple(jnp.asarray(a) for a in (tri, ts, valid))
        thit = tuple(torch.as_tensor(a) for a in (tri, ts, valid))
    args = (o, d, pixels, bkgd)
    return (total, [jnp.asarray(a) for a in args], jhit,
            [torch.as_tensor(a) for a in args], thit)


@pytest.mark.parametrize("pack_slack", [1.25, 0.0])
def test_trainer_steps_in_lockstep_with_jax(pack_slack):
    """Eight steps of each trainer's train step on the same weights, a
    new batch and its hits each step: each step's loss within 1e-4
    relative of JAX's, its hit count equal; the SG table within 2.0001
    times the sum of the learning rates so far of JAX's (Adam's first
    steps move an entry by ~lr * sign(g), so an entry whose tiny
    gradient takes the other sign in the port moves the other way) and
    the head within 1e-4 of max after the first step; Adam's step count
    and learning rate JAX's."""
    jtr, ttr = trainers(pack_slack)
    lr_sum = 0.0
    for step in range(8):
        total, jb, jhit, tb, thit = step_inputs(jtr, ttr, step)
        assert total > 50
        lr = float(ttr.optimizer.param_groups[0]["lr"])
        lr_sum += lr
        jtr.sg_params, jtr.opt_state, jl, jnh, _ = jtr._train_step(
            jtr.sg_params, jtr.opt_state, *jb, jhit)
        tl, tnh, _ = ttr._train_step_impl(*tb, thit)
        assert int(tnh) == int(jnh) == total
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                   err_msg=f"step {step}")
        jt = np.asarray(jtr.sg_params["table"])
        tt = ttr.sg_params["table"].detach().numpy()
        assert np.abs(tt - jt).max() <= 2.0001 * lr_sum, step
        if step == 0:
            for (name, t), (_, j) in zip(leaves(ttr.sg_params["mlp_head"]),
                                         leaves(jtr.sg_params["mlp_head"])):
                j = np.asarray(j)
                assert np.abs(t.detach().numpy() - j).max() <= \
                    1e-4 * np.abs(j).max(), name
        counts = {int(ttr.optimizer.state[p]["step"])
                  for _, p in leaves(ttr.sg_params)}
        assert counts == {step + 1}
    assert lr == pytest.approx(2e-2 * (0.01 + 0.99 * 7 / 1000), rel=1e-6)


def test_save_and_load(tmp_path):
    """A trainer's save, read by a new trainer: the SG model, Adam's
    state, the occupancy and the step; the new trainer steps on."""
    jtr, ttr = trainers(1.25)
    for step in range(2):
        _, _, _, tb, thit = step_inputs(jtr, ttr, step)
        ttr._train_step_impl(*tb, thit)
        ttr.step += 1
    path = str(tmp_path / "fit_sg.pt")
    ttr.save(path)
    _, other = trainers(1.25)
    other.load(path)
    assert other.step == 2
    for (name, a), (_, b) in zip(leaves(other.sg_params),
                                 leaves(ttr.sg_params)):
        assert torch.equal(a, b), name
        assert a.requires_grad
    sa, sb = other.optimizer.state_dict(), ttr.optimizer.state_dict()
    assert torch.equal(sa["state"][0]["exp_avg"], sb["state"][0]["exp_avg"])
    assert torch.equal(other.occ_state.binaries, ttr.occ_state.binaries)
    _, _, _, tb, thit = step_inputs(jtr, other, 2)
    loss, nh, _ = other._train_step_impl(*tb, thit)
    assert np.isfinite(float(loss)) and int(nh) > 0


def stage4_checkpoint(tmp_path, monkeypatch):
    """Stages 1 -> 4 through the port's CLIs at tiny widths: a stage-1
    checkpoint of the untrained NGP (Stage1Trainer.save; its table
    scaled by 1e4 so that the teacher's density varies), a sphere
    mesh as stage 3's smp_mesh.ply, and the stage-4 CLI for 3 steps.
    Returns (data_root, runs root, finetune.pt, stage 4's mesh.ply)."""
    from quadraturefields_tpu_torch.cli import train_finetune as tcli4
    from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
    from quadraturefields_tpu_torch.geometry.meshio import save_ply
    from quadraturefields_tpu_torch.train import stage1_ngp as tst1
    from quadraturefields_tpu_torch.train import stage4_finetune as tst4

    data = str(tmp_path / "data")
    write_fixture_dataset(data, res=16, n_train=2, n_test=1)
    runs = str(tmp_path / "runs")
    t1 = tst1.Stage1Trainer(tst1.Stage1Config(
        scene="fixture", data_root=data, root=runs, num_lobes=0,
        log2_hashmap_size=10, grid_resolution=32), device="cpu")
    with torch.no_grad():
        t1.params["table"].mul_(1e4)
    ckpt1 = os.path.join(runs, "ckpts", "fixture", "nerf", "ngp.pt")
    t1.save(ckpt1)
    verts, faces = sphere_mesh(16)
    smp = str(tmp_path / "smp_mesh.ply")
    save_ply(smp, TMesh(verts * 1.5, faces))
    monkeypatch.setattr(tcli4, "Stage4Config", functools.partial(
        tst4.Stage4Config, grid_resolution=32, freeze_rf_steps=2,
        mesh_update_every=10**9, field_max_res=32,
        field_log2_hashmap_size=10, max_num_rays=1 << 12))
    tcli4.main(["--scene", "fixture", "--data_root", data, "--root", runs,
                "--ckpt_path", ckpt1, "--mesh_path", smp, "--num_lobes",
                "0", "--log2_hashmap_size", "10", "--up_sample", "2.0",
                "--max_hits", "8", "--max_iterations", "2", "--batch_size",
                "10", "--scale", "1.5"], device="cpu")
    ckpt4 = os.path.join(runs, "ckpts", "fixture", "finetune",
                         "finetune.pt")
    mesh4 = os.path.join(runs, "results", "fixture", "finetune", "mesh.ply")
    return data, runs, ckpt4, mesh4


def run_stage5_cli(data, runs, ckpt4, mesh4, monkeypatch, extra=()):
    """The stage-5 CLI with run_nerfsynthetic_fit_sg.sh's flags at tiny
    widths (log2_T 10, 2 lobes, 8 hits a ray, a 2^10 sample target, a
    32^3 grid by a patched config, 4 steps); returns fit_sg.pt."""
    from quadraturefields_tpu_torch.cli import train_fit_sg as tcli5

    monkeypatch.setattr(tcli5, "Stage5Config", functools.partial(
        tst5.Stage5Config, grid_resolution=32, max_num_rays=1 << 12))
    tcli5.main(["--scene", "fixture", "--data_root", data, "--root", runs,
                "--exp_name", "finetune_sg", "--scaling", "0.0434",
                "--mesh_path", mesh4, "--up_sample", "2.0", "--max_hits",
                "8", "--num_lobes", "2", "--num_layers", "2",
                "--ckpt_path", ckpt4, "--max_iterations", "3",
                "--log2_hashmap_size", "10", "--batch_size", "10",
                "--scale", "1.5", *extra], device="cpu")
    return os.path.join(runs, "ckpts", "fixture", "finetune_sg",
                        "fit_sg.pt")


def test_cli_chain_stage4_to_stage5(tmp_path, monkeypatch):
    """The stage-4 CLI's finetune.pt and mesh.ply feed the stage-5 CLI
    (run_nerfsynthetic_fit_sg.sh's flags at tiny widths, both hit
    transports): it writes fit_sg.pt with the SG model (45 outputs at 6
    lobes; here 3 + 7 * 2), the teacher's occupancy and the step;
    --num_devices 2 without a process group is refused."""
    from quadraturefields_tpu_torch.cli import train_fit_sg as tcli5

    data, runs, ckpt4, mesh4 = stage4_checkpoint(tmp_path, monkeypatch)
    stage4 = torch.load(ckpt4, weights_only=True)
    for extra in ((), ("--pack_slack", "0")):
        path = run_stage5_cli(data, runs, ckpt4, mesh4, monkeypatch, extra)
        state = torch.load(path, weights_only=True)
        assert state["step"] == 4
        assert state["radiance_field"]["mlp_head"]["layers"][-1]["b"] \
            .shape == (17,)
        assert state["radiance_field"]["table"].shape == \
            stage4["radiance_field"]["table"].shape
        assert torch.isfinite(state["radiance_field"]["table"]).all()
        assert state["binaries"].shape == (32, 32, 32)
        os.remove(path)
    # no torchrun process group: the trainer refuses num_devices 2
    with pytest.raises(RuntimeError, match="torchrun"):
        tcli5.main(["--ckpt_path", ckpt4, "--mesh_path", mesh4,
                    "--num_devices", "2"], device="cpu")
