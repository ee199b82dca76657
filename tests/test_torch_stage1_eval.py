"""The port's stage-1 evaluation against the JAX trainer's, on the same
weights, occupancy grid and fixture views; the port's metrics and
checkpoints; and a check that the port trains and renders without
importing jax or the JAX package."""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.data.fixture import FixtureScene, write_fixture_dataset
from quadraturefields_tpu.train import stage1_ngp as jst
from quadraturefields_tpu.utils import metrics as jm
from quadraturefields_tpu_torch.train import stage1_ngp as tst
from quadraturefields_tpu_torch.utils import metrics as tm
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(root, **kw):
    base = dict(scene="fixture", data_root=root, n_levels=4,
                log2_hashmap_size=12, grid_resolution=128,
                batch_size_log2=14, eval_chunk=1024,
                eval_renderer="oneshot")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A JAX and a port trainer on one fixture dataset (32 px, 2 test
    views), with the JAX trainer's weights (table lifted off its 1e-4
    init so the views show structure) and the fixture sphere's
    occupancy, filled as bench.py fills it."""
    root = str(tmp_path_factory.mktemp("data"))
    write_fixture_dataset(root, res=32, n_train=2, n_test=2)
    jtr = jst.Stage1Trainer(jst.Stage1Config(**_config(root)))
    jtr.params["table"] = jtr.params["table"] * 1e4
    res = jtr.occ_cfg.resolution
    lin = np.linspace(-1.5, 1.5, res)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = (FixtureScene().sigma(grid.reshape(-1, 3)) * 5e-3) \
        .astype(np.float32)
    binaries = (occs > 0.01).reshape(res, res, res)
    jtr.occ_state = jtr.occ_state._replace(
        occs=jnp.asarray(occs), binaries=jnp.asarray(binaries))

    ttr = tst.Stage1Trainer(tst.Stage1Config(**_config(root)), device="cpu")
    ttr.params = tst._as_leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    ttr._make_optimizer()
    ttr.occ_state = occ_state_from_jax(occs, binaries, ttr.cfg.aabb)
    return jtr, ttr


def test_evaluate_matches_jax_trainer(trainers):
    """PSNR within 0.05 dB and SSIM within 1e-3 of the JAX trainer's
    one-shot evaluate; the views themselves within 5e-3 (bf16 MLPs: an
    operand may round to the neighbouring bf16 value)."""
    jtr, ttr = trainers
    jm_ = jtr.evaluate()
    tm_ = ttr.evaluate()
    assert abs(tm_["psnr"] - jm_["psnr"]) <= 0.05, (tm_, jm_)
    assert abs(tm_["ssim"] - jm_["ssim"]) <= 1e-3, (tm_, jm_)
    assert np.isnan(tm_["lpips"]) and np.isnan(jm_["lpips"])
    data = ttr.test_dataset.fetch_eval_view(0)
    j_img = np.asarray(jtr.render_view(data))
    t_img = ttr.render_view(data).numpy()
    assert t_img.shape == (32 * 32, 3) and np.isfinite(t_img).all()
    assert t_img.min() < 0.9          # the sphere shows against white
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=5e-3)


def test_window_eval_agrees_with_oneshot(trainers, tmp_path):
    """The "auto" evaluator picks the window renderer at this chunk and
    budget; its view is the one-shot view within 1e-3. Save and load
    round-trip the weights and grid."""
    _, ttr = trainers
    data = ttr.test_dataset.fetch_eval_view(1)
    one = ttr.render_view(data)
    ttr.cfg.eval_renderer = "auto"
    try:
        assert ttr._use_window_eval()
        win = ttr.render_view(data)
    finally:
        ttr.cfg.eval_renderer = "oneshot"
    np.testing.assert_allclose(win.numpy(), one.numpy(), rtol=0, atol=1e-3)

    path = str(tmp_path / "ngp.pt")
    ttr.save(path)
    other = tst.Stage1Trainer(ttr.cfg, train_dataset=ttr.train_dataset,
                              test_dataset=ttr.test_dataset, device="cpu")
    other.load(path)
    assert torch.equal(other.params["table"], ttr.params["table"])
    assert torch.equal(other.occ_state.binaries, ttr.occ_state.binaries)
    assert torch.equal(other.render_view(data), one)


class _Views360:
    """A stand-in dataset for the 360 trainers: nerf_360_v2 scenes are
    not in the repo, and render_view takes its rays directly."""
    HEIGHT = WIDTH = 16
    num_rays = 64

    def __len__(self):
        return 1


def test_360_oneshot_view_matches_jax():
    """The unbounded 360 path (scene_type "360": the contracted [-1, 1]^3
    aabb, cone stepping from near 0.2 to far 100, ~1,554 march slots a
    ray, no coarse level) through render_view's one-shot renderer: the
    port's view within 1e-4 of the JAX trainer's, on the same weights
    (f32 MLPs; the table lifted off its init), occupancy grid (a seeded
    third of the 32^3 cells) and rays (origins near the centre, random
    directions, so the march crosses the contracted shell). JAX runs
    eagerly (jax.disable_jit): jitted, XLA's fused f32 moves one ray's
    march across an occupancy cell's boundary, 3e-3 off its eager
    render, which the port's equals."""
    kw = dict(scene="garden", scene_type="360", n_levels=4,
              log2_hashmap_size=12, grid_resolution=32, eval_chunk=256,
              eval_renderer="oneshot")
    views = dict(train_dataset=_Views360(), test_dataset=_Views360())
    jtr = jst.Stage1Trainer(jst.Stage1Config(**kw), **views)
    jtr.params["table"] = jtr.params["table"] * 1e4
    jtr.ngp_cfg = dataclasses.replace(jtr.ngp_cfg, compute_dtype="float32")
    ttr = tst.Stage1Trainer(tst.Stage1Config(**kw), device="cpu", **views)
    ttr.params = tst._as_leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    ttr.ngp_cfg = dataclasses.replace(ttr.ngp_cfg, compute_dtype="float32")
    assert ttr.rcfg.cone_angle == 0.004 and ttr.rcfg.near_plane == 0.2
    rng = np.random.default_rng(11)
    res = kw["grid_resolution"]
    occs = rng.uniform(0, 0.03, res ** 3).astype(np.float32)
    binaries = (occs > 0.02).reshape(res, res, res)
    jtr.occ_state = jtr.occ_state._replace(
        occs=jnp.asarray(occs), binaries=jnp.asarray(binaries))
    ttr.occ_state = occ_state_from_jax(occs, binaries, ttr.cfg.aabb)
    n = _Views360.HEIGHT * _Views360.WIDTH
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = types.SimpleNamespace(
        origins=rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        viewdirs=d)
    with jax.disable_jit():
        j_img = np.asarray(jtr.render_view({"rays": rays}))
    t_img = ttr.render_view({"rays": rays}).numpy()
    assert t_img.shape == (n, 3) and np.isfinite(t_img).all()
    assert t_img.std() > 1e-2          # the view has structure
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-4)


def test_config_matches_jax():
    """Stage1Config derives the same render and model settings."""
    for kw in (dict(), dict(scene="garden"), dict(coarse_stride=0),
               dict(num_lobes=0, interp="cube")):
        j, t = jst.Stage1Config(**kw), tst.Stage1Config(**kw)
        assert t.render_config().__dict__ == j.render_config().__dict__
        assert t.ngp_config().__dict__ == j.ngp_config().__dict__
        np.testing.assert_array_equal(t.aabb, j.aabb)


def test_metrics_match_jax():
    """MSE/PSNR/smooth-L1 within 1e-6 relative; SSIM within 1e-5 (full
    f32 convolutions in both)."""
    rng = np.random.default_rng(0)
    a = rng.random((40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tf, jf in ((tm.mse, jm.mse), (tm.psnr, jm.psnr),
                   (tm.smooth_l1_loss, jm.smooth_l1_loss)):
        np.testing.assert_allclose(float(tf(ta, tb)), float(jf(ja, jb)),
                                   rtol=1e-6)
    mask = rng.random(40) < 0.5
    np.testing.assert_allclose(
        float(tm.smooth_l1_loss(ta, tb, ray_mask=torch.as_tensor(mask))),
        float(jm.smooth_l1_loss(ja, jb, ray_mask=jnp.asarray(mask))),
        rtol=1e-6)
    np.testing.assert_allclose(float(tm.ssim(ta, tb)), float(jm.ssim(ja, jb)),
                               rtol=0, atol=1e-5)


def test_port_runs_without_jax():
    """A fresh interpreter imports the port (stages 5 and 6, LPIPS, the
    profiling utilities, the NeRF MLPs, every data loader, the
    checkpoint converter and the data parallelism included),
    takes one training step and renders a tiny batch on the CPU, and has
    imported neither jax nor any module of the JAX package."""
    code = """
import sys
import numpy as np, torch
from quadraturefields_tpu_torch.train.stage1_ngp import Stage1Config, Stage1Trainer
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
import quadraturefields_tpu_torch.baking.stage6
import quadraturefields_tpu_torch.cli.bake
import quadraturefields_tpu_torch.cli.train_fit_sg
import quadraturefields_tpu_torch.data.own_views
import quadraturefields_tpu_torch.render.baked
import quadraturefields_tpu_torch.train.stage5_fit_sg
import quadraturefields_tpu_torch.cli.convert_reference_ckpt
import quadraturefields_tpu_torch.data.dnerf_synthetic
import quadraturefields_tpu_torch.data.ray_utils
import quadraturefields_tpu_torch.data.tandt
import quadraturefields_tpu_torch.models.mlp_nerf
import quadraturefields_tpu_torch.parallel.dp
import quadraturefields_tpu_torch.parallel.multihost
import quadraturefields_tpu_torch.utils.lpips
import quadraturefields_tpu_torch.utils.profiling

class Views:
    HEIGHT = WIDTH = 16
    num_rays = 256
    def __len__(self):
        return 1
    def update_num_rays(self, n):
        self.num_rays = n
    def fetch_eval_view(self, i):
        d = np.tile([[0.0, 0.1, 1.0]], (256, 1)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile([[0.0, 0.0, -3.0]], (256, 1)).astype(np.float32)
        return {"pixels": np.ones((256, 3), np.float32), "rays": Rays(o, d),
                "color_bkgd": np.ones(3, np.float32)}
    def fetch_train_batch(self):
        return self.fetch_eval_view(0)

cfg = Stage1Config(n_levels=2, log2_hashmap_size=10, grid_resolution=32,
                   eval_chunk=256, batch_size_log2=12)
tr = Stage1Trainer(cfg, train_dataset=Views(), test_dataset=Views(),
                   device="cpu")
before = tr.params["table"].clone()
loss, aux = tr.train_one_step()
assert np.isfinite(float(loss)) and tr.step == 1, loss
assert not torch.equal(tr.params["table"], before)
m = tr.evaluate()
assert np.isfinite(m["psnr"]), m
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
