"""The port's stage 2 (train/stage2_field.py, cli/train_field.py,
utils/grid_export.py) against the JAX package's: one training step's
loss and field gradients on the same NGP, field, occupancy, rays and
stratified jitter (JAX's draw fed to the port), synthetic and 360; one
full trainer step with Adam; the grid export at 16^3; then the port
alone: its stage-1 CLI checkpoint through the stage-2 CLI on the CPU,
save and load, and a run that loads neither jax nor the JAX package.
The slow case trains both packages' stage 1 and stage 2 at
tests/test_pipeline_full.py's settings and prints the two quality gates
that chip_smoke.py's phase 7 holds the card's run to."""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    FIELD_INTERIOR_GATE,
    FIELD_LOSS_GATE,
    FIELD_SHELL_GATE,
    sphere_shell_ratios,
)
from quadraturefields_tpu.models import field as jf
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.render import renderer as jr
from quadraturefields_tpu.train import stage2_field as jst2
from quadraturefields_tpu_torch.cli import train_field as tcli2
from quadraturefields_tpu_torch.cli import train_ngp as tcli1
from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
from quadraturefields_tpu_torch.train import stage1_ngp as tst1
from quadraturefields_tpu_torch.train import stage2_field as tst2
from quadraturefields_tpu_torch.utils.convert import (
    field_params_from_jax,
    occ_state_from_jax,
    params_from_jax,
)
from test_torch_render_field import occupancy, rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


class _Rays:
    """A stand-in dataset: the steps under test take their rays
    directly, so nothing is loaded."""
    HEIGHT = WIDTH = 8
    num_rays = 96

    def __len__(self):
        return 1

    def update_num_rays(self, n):
        self.num_rays = n


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trainers(scene_type, field_table_scale=1.0):
    """A JAX and a port stage-2 trainer at a small size on the same NGP
    (JAX's init, table scaled by 1e4), field (JAX's init, table scaled
    by `field_table_scale`) and occupancy (the fixture sphere's; every
    cell for 360), with 96 rays."""
    kw = dict(n_levels=4, log2_hashmap_size=12, batch_size_log2=13,
              render_step_size=2e-2, num_lobes=0, field_log2_hashmap_size=12,
              field_max_res=64, grid_export_size=16, scene_type=scene_type,
              scene="fixture" if scene_type == "synthetic" else "garden")
    jcfg, tcfg = jst2.Stage2Config(**kw), tst2.Stage2Config(**kw)
    jp = jngp.ngp_init(jax.random.PRNGKey(0), jcfg.ngp_config())
    jp["table"] = jp["table"] * 1e4
    occs, binaries = occupancy(scene_type, jcfg.grid_resolution,
                               jcfg.render_step_size)
    tocc = occ_state_from_jax(occs, binaries, jcfg.aabb)
    jtr = jst2.Stage2Trainer(
        jcfg, ngp_params=jp, train_dataset=_Rays(),
        occ_state=jst2.OccGridState(jnp.asarray(occs), jnp.asarray(binaries),
                                    jnp.asarray(jcfg.aabb)))
    jtr.field_params["table"] = jtr.field_params["table"] * field_table_scale
    jtr.opt_state = jtr.optimizer.init(jtr.field_params)
    ttr = tst2.Stage2Trainer(tcfg, ngp_params=params_from_jax(_np(jp)),
                             occ_state=tocc, train_dataset=_Rays(),
                             device="cpu")
    ttr.field_params = tst1._as_leaf_params(
        field_params_from_jax(_np(jtr.field_params)))
    ttr._make_optimizer()
    o, d = rays(scene_type, _Rays.num_rays)
    rng = np.random.default_rng(10)
    batch = (o, d, rng.uniform(0, 1, (_Rays.num_rays, 3)).astype(np.float32),
             np.array([0.3, 0.6, 0.9], np.float32))
    return jtr, ttr, batch


def _jax_loss_fn(jtr, batch, key):
    """JAX's stage-2 loss of Stage2Trainer._train_step_impl, as a
    function of the field params: (loss, num_valid)."""
    o, d, _, bkgd = (jnp.asarray(a) for a in batch)

    def loss_fn(fp):
        res = jr.render_rays_field(
            jtr.ngp_params, jtr.aabb, jtr.ngp_cfg, jtr.occ_state, o, d,
            jtr.rcfg, render_bkgd=bkgd, stratified=True, key=key)
        _, pos01 = jngp.ngp_normalize(res.positions, jtr.aabb, jtr.ngp_cfg)
        positions = jax.lax.stop_gradient(pos01 - 0.5)
        _, fgrad = jf.field_with_grad(fp, positions, jtr.field_cfg)
        loss = jf.field_loss(res.weights, res.weights_rev, fgrad, res.dirs,
                             mask=res.valid)
        return loss, res.num_valid

    return loss_fn


def _field_leaves(tree):
    """(name, leaf) of a field tree: the table, then each decoder layer's
    w and b."""
    out = [("table", tree["table"])]
    for i, layer in enumerate(tree["decoder"]["layers"]):
        out += [(f"{i}.{k}", layer[k]) for k in sorted(layer)]
    return out


@pytest.mark.parametrize("scene_type", ["synthetic", "360"])
def test_training_step_matches_jax(scene_type):
    """num_valid equal, the loss within 1e-4 relative of JAX's, and each
    field gradient with cosine >= 0.999 and norm within 1% (the NGP's
    bf16 MLPs render both). The decoder's output bias moves the field,
    not its gradient: its gradient is 0 in both. Then one full step of
    each trainer (Adam at the first step's lr 2e-4): the same loss, and
    every weight, the output bias included (weight decay alone moves
    it), within 2 lr of JAX's."""
    jtr, ttr, batch = _trainers(scene_type)
    key = jax.random.PRNGKey(5)
    (lj, nvj), gj = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jtr, batch, key), has_aux=True))(jtr.field_params)
    u = np.array(jax.random.uniform(key, (batch[0].shape[0],)))
    tb = [torch.as_tensor(a) for a in batch]
    lt, aux = ttr._loss_fn(ttr.field_params, *tb, torch.as_tensor(u))
    lt.backward()
    assert int(aux["num_valid"]) == int(nvj) > 500
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    got, want = _field_leaves(ttr.field_params), _field_leaves(gj)
    last_b = f"{len(gj['decoder']['layers']) - 1}.b"
    for (name, leaf), (_, g) in zip(got, want):
        b = np.asarray(g).ravel()
        if name == last_b:
            assert leaf.grad is None and not b.any()
            continue
        a = leaf.grad.numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0, name
        assert a @ b / (na * nb) >= 0.999, name
        assert abs(na / nb - 1.0) <= 0.01, name

    before = _np(jtr.field_params)
    lr = float(ttr.optimizer.param_groups[0]["lr"])
    assert lr == pytest.approx(2e-4)  # 2e-2 at the warm-up's 1%
    jfp, _, jl, jnv, _ = jtr._train_step(
        jtr.field_params, jtr.opt_state, jtr.ngp_params, jtr.occ_state,
        *(jnp.asarray(a) for a in batch), key)
    tl, taux = ttr._train_step_impl(*tb, torch.as_tensor(u))
    assert int(taux["num_valid"]) == int(jnv)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for (name, t), (_, j), (_, b) in zip(_field_leaves(ttr.field_params),
                                         _field_leaves(_np(jfp)),
                                         _field_leaves(before)):
        t = t.detach().numpy()
        # 360 scenes have no weight decay: nothing moves the output bias
        if name != last_b or ttr.weight_decay > 0:
            assert np.abs(t - b).max() > 0, name
        # Adam's first step is lr * sign(g): a sign that differs moves an
        # entry 2 lr apart
        assert np.abs(t - j).max() <= 2.0001 * lr, name
    assert ttr.scheduler.last_epoch == 1


def test_training_step_with_back_prop_matches_jax():
    """back_prop=True (the position gradient through the encode, which
    the loss differentiates again), set on both trainers' field_cfg
    after construction: the loss within 1e-5 relative of JAX's, every
    field gradient within 1e-4 of its max; then one full step of each
    trainer: the same loss, every weight within 2 lr of JAX's."""
    jtr, ttr, batch = _trainers("synthetic")
    jtr.field_cfg = dataclasses.replace(jtr.field_cfg, back_prop=True)
    ttr.field_cfg = dataclasses.replace(ttr.field_cfg, back_prop=True)
    key = jax.random.PRNGKey(5)
    (lj, nvj), gj = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jtr, batch, key), has_aux=True))(jtr.field_params)
    u = np.array(jax.random.uniform(key, (batch[0].shape[0],)))
    tb = [torch.as_tensor(a) for a in batch]
    lt, aux = ttr._loss_fn(ttr.field_params, *tb, torch.as_tensor(u))
    lt.backward()
    assert int(aux["num_valid"]) == int(nvj) > 500
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    last_b = f"{len(gj['decoder']['layers']) - 1}.b"
    for (name, leaf), (_, g) in zip(_field_leaves(ttr.field_params),
                                    _field_leaves(gj)):
        g = np.asarray(g)
        if name == last_b:
            assert leaf.grad is None and not g.any()
            continue
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= 1e-4 * np.abs(g).max(), name
        leaf.grad = None

    lr = float(ttr.optimizer.param_groups[0]["lr"])
    jfp, _, jl, jnv, _ = jtr._train_step(
        jtr.field_params, jtr.opt_state, jtr.ngp_params, jtr.occ_state,
        *(jnp.asarray(a) for a in batch), key)
    tl, taux = ttr._train_step_impl(*tb, torch.as_tensor(u))
    assert int(taux["num_valid"]) == int(jnv)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for (name, t), (_, j) in zip(_field_leaves(ttr.field_params),
                                 _field_leaves(_np(jfp))):
        assert np.abs(t.detach().numpy() - j).max() <= 2.0001 * lr, name


def test_stage2_config_matches_jax():
    """Stage2Config field for field, and the configs it derives (NGP,
    field, render), for a synthetic and a 360 scene."""
    names = [f.name for f in dataclasses.fields(jst2.Stage2Config)]
    assert [f.name for f in dataclasses.fields(tst2.Stage2Config)] == names
    for kw in (dict(), dict(scene="garden"), dict(scene="drums")):
        j, t = jst2.Stage2Config(**kw), tst2.Stage2Config(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("is_unbounded", "target_sample_batch_size",
                     "eff_render_step_size", "eff_near_plane",
                     "eff_far_plane", "eff_alpha_thre", "eff_cone_angle"):
            assert getattr(t, prop) == getattr(j, prop), prop
        np.testing.assert_array_equal(t.aabb, j.aabb)
        for derived in ("ngp_config", "field_config", "render_config"):
            assert dataclasses.asdict(getattr(t, derived)()) == \
                dataclasses.asdict(getattr(j, derived)()), derived


def test_plot_field_writes_three_slices(tmp_path):
    """plot_field draws the mid-plane slice across each axis."""
    from quadraturefields_tpu_torch.utils.field_plots import plot_field

    _, ttr, _ = _trainers("synthetic")
    plot_field(ttr.field_with_grad_fn(), str(tmp_path), grid_size=16,
               step=7)
    assert sorted(os.listdir(tmp_path)) == [
        f"field_axis{a}_step7.png" for a in range(3)]


def _f16_ulps(a, b):
    """Largest distance between two float16 arrays in units of their last
    place (the spacing at the larger magnitude)."""
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    return float((np.abs(a32 - b32) / spacing.astype(np.float32)).max())


@pytest.mark.parametrize("scene_type", ["synthetic", "360"])
def test_grid_export_matches_jax(scene_type, tmp_path):
    """export_artifacts at grid_export_size 16 in both packages on the
    same field (table scaled by 1e3) and NGP: the binaries equal, the f32
    field grid within 1e-5 of max, the f16 |grad| and density grids
    within one f16 ulp. 360 scenes write the unpooled h5 file."""
    jtr, ttr, _ = _trainers(scene_type, field_table_scale=1e3)
    jtr.export_artifacts(str(tmp_path / "jax"))
    ttr.export_artifacts(str(tmp_path / "port"))

    def load(d, name):
        return np.load(tmp_path / d / name)

    np.testing.assert_array_equal(load("port", "binaries.npy"),
                                  load("jax", "binaries.npy"))
    assert load("port", "binaries.npy").shape == (1, 128, 128, 128)
    if scene_type == "360":
        import h5py

        with h5py.File(tmp_path / "jax" / "grids_valid.h5") as hj, \
                h5py.File(tmp_path / "port" / "grids_valid.h5") as ht:
            fj, ft = hj["grids"][...], ht["grids"][...]
            gj, gt = hj["grads"][...], ht["grads"][...]
    else:
        fj, ft = load("jax", "grids_valid.npy"), load("port", "grids_valid.npy")
        gj, gt = load("jax", "grads_valid.npy"), load("port", "grads_valid.npy")
    assert ft.dtype == np.float32 and gt.dtype == np.float16
    assert ft.shape == gt.shape == (16, 16, 16)
    assert np.abs(ft - fj).max() <= 1e-5 * np.abs(fj).max()
    assert gj.astype(np.float32).max() > 0
    assert _f16_ulps(gt, gj) <= 1.0
    dj = load("jax", "density_grids_valid.npy")
    dt = load("port", "density_grids_valid.npy")
    assert dt.dtype == np.float16 and dt.shape == (16, 16, 16)
    assert dj.astype(np.float32).max() > 0
    assert _f16_ulps(dt, dj) <= 1.0


def test_cli_trains_and_exports_from_the_stage1_cli(tmp_path, monkeypatch):
    """The stage-1 CLI's checkpoint feeds the stage-2 CLI (the JAX CLI's
    flags, device "cpu"), which writes the binaries, the three grids and
    its checkpoint; save and load carry the field, Adam and the step;
    --num_devices > 1 outside a torchrun process group of that size is
    refused. The configs the CLIs build get a 32^3
    occupancy grid (no flag sets it; stage 2 must match stage 1's) and
    stage 1 a checkpoint at its last step."""
    monkeypatch.setattr(tcli1, "Stage1Config", functools.partial(
        tst1.Stage1Config, grid_resolution=32, eval_chunk=256,
        ckpt_every=3))
    monkeypatch.setattr(tcli2, "Stage2Config", functools.partial(
        tst2.Stage2Config, grid_resolution=32))
    write_fixture_dataset(str(tmp_path / "data"), res=16, n_train=2,
                          n_test=1)
    runs = str(tmp_path / "runs")
    common = ["--scene", "fixture", "--data_root", str(tmp_path / "data"),
              "--root", runs, "--num_lobes", "0", "--log2_hashmap_size",
              "10", "--max_steps", "3"]
    tcli1.main(common + ["--exp_name", "nerf", "--batch_size", "12"],
               device="cpu")
    ckpt = os.path.join(runs, "ckpts", "fixture", "nerf", "ngp.pt")
    assert os.path.exists(ckpt)
    argv = common + ["--ckpt_path", ckpt, "--batch_size", "12",
                     "--field_log2_hashmap_size", "10",
                     "--grid_export_size", "8"]
    tcli2.main(argv, device="cpu")
    out = os.path.join(runs, "results", "fixture", "field")
    for name, dtype, shape in (
        ("binaries.npy", bool, (1, 32, 32, 32)),
        ("grids_valid.npy", np.float32, (8, 8, 8)),
        ("grads_valid.npy", np.float16, (8, 8, 8)),
        ("density_grids_valid.npy", np.float16, (8, 8, 8)),
    ):
        a = np.load(os.path.join(out, name))
        assert a.dtype == dtype and a.shape == shape, name
        assert np.isfinite(a.astype(np.float32)).all(), name
    path = os.path.join(runs, "ckpts", "fixture", "field", "field.pt")
    assert os.path.exists(path)

    cfg = tst2.Stage2Config(
        scene="fixture", data_root=str(tmp_path / "data"), ckpt_path=ckpt,
        num_lobes=0, log2_hashmap_size=10, field_log2_hashmap_size=10,
        grid_resolution=32, max_steps=3)
    other = tst2.Stage2Trainer(cfg, device="cpu")
    other.load(path)
    state = torch.load(path, weights_only=True)
    assert other.step == 4
    assert torch.equal(other.field_params["table"],
                       state["field_params"]["table"])
    assert torch.equal(other.optimizer.state_dict()["state"][0]["exp_avg"],
                       state["opt_state"]["state"][0]["exp_avg"])
    loss, nv, mse = other.train_one_step()
    assert np.isfinite(float(loss)) and nv > 0 and other.step == 5
    with pytest.raises(RuntimeError, match="torchrun"):
        tcli2.main(argv + ["--num_devices", "2"], device="cpu")


def test_stage2_runs_without_jax():
    """A fresh interpreter trains and exports stage 2 through the port
    alone: neither jax nor the JAX package gets imported."""
    code = r"""
import sys, tempfile
import numpy as np, torch
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
from quadraturefields_tpu_torch.models.ngp import ngp_init
from quadraturefields_tpu_torch.train.stage2_field import (
    Stage2Config, Stage2Trainer)

class Views:
    num_rays = 128
    def update_num_rays(self, n):
        self.num_rays = n
    def fetch_train_batch(self):
        d = np.tile([[0.0, 0.1, 1.0]], (self.num_rays, 1)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile([[0.0, 0.0, -3.0]], (self.num_rays, 1)).astype(np.float32)
        return {"pixels": np.ones((self.num_rays, 3), np.float32),
                "rays": Rays(o, d), "color_bkgd": np.ones(3, np.float32)}

cfg = Stage2Config(n_levels=2, log2_hashmap_size=10, num_lobes=0,
                   grid_resolution=32, batch_size_log2=12,
                   field_log2_hashmap_size=10, grid_export_size=4)
ngp = ngp_init(torch.Generator().manual_seed(0), cfg.ngp_config())
tr = Stage2Trainer(cfg, ngp_params=ngp, train_dataset=Views(), device="cpu")
loss, nv, mse = tr.train_one_step()
assert np.isfinite(float(loss)) and nv > 0, (loss, nv)
tr.export_artifacts(tempfile.mkdtemp())
assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
ref = sorted(k for k in sys.modules if k == "quadraturefields_tpu"
             or k.startswith("quadraturefields_tpu."))
assert not ref, ref
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.slow
def test_stage2_quality_gates_on_the_cpu(tmp_path):
    """Both packages at tests/test_pipeline_full.py's settings (stage 1:
    220 steps at 2^13 samples on a 40^2 fixture; stage 2: 120 steps,
    field log2_T 14, max_res 64, a 48^3 export), each from its own
    stage-1 run: the stage-2 loss's mean over the last 20 steps against
    the first 20, and the two sphere-shell |grad| ratios. Prints them
    for both packages; chip_smoke.py's phase 7 set its gates from them
    (FIELD_LOSS_GATE, FIELD_SHELL_GATE, FIELD_INTERIOR_GATE), and each
    package must pass them here."""
    from quadraturefields_tpu.data.fixture import (
        write_fixture_dataset as jax_write_fixture,
    )
    from quadraturefields_tpu.train import stage1_ngp as jst1

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
    results = {}
    for name, m1, m2, kw in (
        ("jax", jst1, jst2, {}),
        ("port", tst1, tst2, dict(device="cpu")),
    ):
        t1 = m1.Stage1Trainer(m1.Stage1Config(root=str(tmp_path / name),
                                              **s1), **kw)
        while t1.step <= 220:
            t1.train_one_step()
        t2 = m2.Stage2Trainer(m2.Stage2Config(root=str(tmp_path / name),
                                              **s2),
                              ngp_params=t1.params, occ_state=t1.occ_state,
                              **kw)
        losses = []
        while t2.step <= 120:
            losses.append(float(t2.train_one_step()[0]))
        out = str(tmp_path / name / "export")
        t2.export_artifacts(out)
        ratio, inner = sphere_shell_ratios(
            np.load(os.path.join(out, "grads_valid.npy")))
        first, last = np.mean(losses[:20]), np.mean(losses[-20:])
        results[name] = (first, last, ratio, inner)
        print(f"{name}: stage-2 loss first 20 {first:.6f}, last 20 "
              f"{last:.6f} (ratio {last / first:.4f}); sphere-shell |grad| "
              f"over outside {ratio:.3f}, over the interior {inner:.3f}")
    for name, (first, last, ratio, inner) in results.items():
        assert np.isfinite([first, last]).all(), name
        assert last < FIELD_LOSS_GATE * first, name
        assert ratio >= FIELD_SHELL_GATE, name
        assert inner >= FIELD_INTERIOR_GATE, name
