"""The port's stage-1 training against the JAX trainer's: the
regularizers, one full training step (loss and gradients) on the same
weights, batch and stratified jitter for a synthetic and a 360 scene,
then a port-only training run on the fixture scene and the training CLI
on a written fixture dataset."""
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.data.fixture import FixtureScene
from quadraturefields_tpu.data.fixture import (
    write_fixture_dataset as jax_write_fixture,
)
from quadraturefields_tpu.ops.grid import PackedSamples as JPacked
from quadraturefields_tpu.train import stage1_ngp as jst
from quadraturefields_tpu_torch.cli import train_ngp as tcli
from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
from quadraturefields_tpu_torch.ops.grid import PackedSamples as TPacked
from quadraturefields_tpu_torch.train import stage1_ngp as tst
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)


def _packed_result(seed=0, n_rays=60, s=1500):
    """A sorted packed stream of weights, sigmas and sample intervals,
    with sentinel padding, as numpy arrays."""
    rng = np.random.default_rng(seed)
    ray = np.sort(rng.integers(0, n_rays, s - 100))
    ray = np.concatenate([ray, np.full(100, n_rays)]).astype(np.int32)
    ts = np.cumsum(rng.uniform(0, 0.02, s)).astype(np.float32)
    return dict(
        ray=ray, ts=ts, te=ts + 5e-3,
        w=rng.uniform(0, 0.3, s).astype(np.float32),
        sig=rng.exponential(5.0, s).astype(np.float32),
        acc=rng.uniform(0.01, 1.0, n_rays).astype(np.float32),
        o=rng.normal(size=(n_rays, 3)).astype(np.float32),
        d=rng.normal(size=(n_rays, 3)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "reg_type", ["occ", "entropy", "cauchy", "both", "lol", "distortion"])
def test_regularizers_match_jax(reg_type):
    """Each regularizer's value and its gradient in the opacities,
    weights and sigmas within 1e-5 relative of JAX's; 1e-4 for the
    distortion gradient, whose segmented prefix sums (doubling scans in
    the port, associative scans in JAX) associate differently."""
    r = _packed_result()
    jcfg = jst.Stage1Config(reg_type=reg_type)
    tcfg = tst.Stage1Config(reg_type=reg_type)

    def jfn(acc, w, sig):
        samples = JPacked(jnp.asarray(r["ray"]), jnp.asarray(r["ts"]),
                          jnp.asarray(r["te"]), None, None)
        res = SimpleNamespace(weights=w, sigmas=sig, samples=samples)
        return jst._regularizer(jcfg, acc, res, jnp.asarray(r["d"]),
                                jnp.asarray(r["o"]))

    vj, gj = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2)))(
        jnp.asarray(r["acc"]), jnp.asarray(r["w"]), jnp.asarray(r["sig"]))
    ins = [torch.tensor(r[k], requires_grad=True)
           for k in ("acc", "w", "sig")]
    samples = TPacked(torch.tensor(r["ray"]), torch.tensor(r["ts"]),
                      torch.tensor(r["te"]), None, None)
    res = SimpleNamespace(weights=ins[1], sigmas=ins[2], samples=samples)
    vt = tst._regularizer(tcfg, ins[0], res, torch.tensor(r["d"]),
                          torch.tensor(r["o"]))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    gt = torch.autograd.grad(vt, ins, allow_unused=True)
    rtol = 1e-4 if reg_type == "distortion" else 1e-5
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-30))


class _Rays360:
    """A stand-in dataset for the 360 trainers: the loss takes its rays
    directly, so nothing is loaded."""
    HEIGHT = WIDTH = 8
    num_rays = 64

    def __len__(self):
        return 1


def _trainers(scene_type, root, **config):
    """A JAX and a port trainer on the same weights, occupancy and batch;
    `config` overrides Stage1Config fields of both."""
    kw = dict(n_levels=4, log2_hashmap_size=12, batch_size_log2=14,
              grid_resolution=128, init_batch_size=256, scene_type=scene_type,
              **config)
    if scene_type == "synthetic":
        kw.update(scene="fixture", data_root=root)
        datasets = {}
    else:
        kw.update(scene="garden")
        datasets = dict(train_dataset=_Rays360(), test_dataset=_Rays360())
    jtr = jst.Stage1Trainer(jst.Stage1Config(**kw), **datasets)
    jtr.params["table"] = jtr.params["table"] * 1e4
    ttr = tst.Stage1Trainer(tst.Stage1Config(**kw), device="cpu", **datasets)
    ttr.params = tst._as_leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    ttr._make_optimizer()
    if scene_type == "synthetic":
        res = jtr.occ_cfg.resolution
        lin = np.linspace(-1.5, 1.5, res)
        grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
        occs = (FixtureScene().sigma(grid.reshape(-1, 3)) * 5e-3) \
            .astype(np.float32)
        binaries = (occs > 0.01).reshape(res, res, res)
        jtr.occ_state = jtr.occ_state._replace(
            occs=jnp.asarray(occs), binaries=jnp.asarray(binaries))
        ttr.occ_state = occ_state_from_jax(occs, binaries, ttr.cfg.aabb)
        data = jtr.train_dataset.fetch_train_batch()
        o, d = data["rays"].origins, data["rays"].viewdirs
        px, bkgd = data["pixels"], data["color_bkgd"]
    else:
        rng = np.random.default_rng(7)
        n = _Rays360.num_rays
        o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        px = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        bkgd = rng.uniform(0, 1, 3).astype(np.float32)
    return jtr, ttr, (o, d, px, bkgd)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    jax_write_fixture(root, res=32, n_train=2, n_test=1)
    return root


@pytest.mark.parametrize("scene_type", ["synthetic", "360"])
def test_training_step_matches_jax(scene_type, fixture_root):
    """One step's loss within 1e-3 relative of the JAX trainer's, and
    each parameter's gradient with cosine >= 0.999 and norm within 1%,
    on the same weights, batch and stratified jitter (JAX's draw fed to
    the port). Gradients, not parameters after Adam: with eps 1e-15 the
    first update is lr * sign(g), which a bf16 flip of a tiny gradient
    would turn around."""
    jtr, ttr, (o, d, px, bkgd) = _trainers(scene_type, fixture_root)
    key = jax.random.PRNGKey(5)
    (lj, auxj), gj = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        jtr.params, jtr.occ_state, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(px), jnp.asarray(bkgd), key)
    u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    lt, auxt = ttr._loss_fn(ttr.params, ttr.occ_state, torch.tensor(o),
                            torch.tensor(d), torch.tensor(px),
                            torch.tensor(bkgd), torch.tensor(u))
    lt.backward()
    assert int(auxt["num_valid"]) == int(auxj["num_valid"]) > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves(gj)
    tleaves = [p.grad for p in tst._leaves(ttr.params)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0
        assert a @ b / (na * nb) >= 0.999
        assert abs(na / nb - 1.0) <= 0.01


def test_port_trains_the_fixture_scene(tmp_path):
    """The port alone, at tests/test_stage1_end_to_end.py's settings
    with a smaller grid (4 levels, 2^12 rows) and 120 steps: the loss
    halves, the eval PSNR passes 20 dB, the occupancy grid prunes most
    of the box and the dynamic batch has moved. Save and load carry the
    optimizer state and the step."""
    write_fixture_dataset(str(tmp_path / "data"), res=48, n_train=8,
                          n_test=1)
    cfg = tst.Stage1Config(
        scene="fixture", data_root=str(tmp_path / "data"),
        root=str(tmp_path / "runs"), max_steps=120, init_batch_size=512,
        batch_size_log2=14, grid_resolution=32, render_step_size=2e-2,
        n_levels=4, log2_hashmap_size=12, eval_chunk=2304,
        ckpt_every=10**9, log_every=10**9)
    tr = tst.Stage1Trainer(cfg, device="cpu")
    losses = []
    while tr.step <= cfg.max_steps:
        loss, _ = tr.train_one_step()
        losses.append(float(loss))
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20])
    metrics = tr.evaluate()
    assert metrics["psnr"] > 20.0, metrics
    assert float(tr.occ_state.binaries.float().mean()) < 0.5
    assert tr.train_dataset.num_rays != cfg.init_batch_size

    path = str(tmp_path / "ngp.pt")
    tr.save(path)
    other = tst.Stage1Trainer(cfg, device="cpu")
    other.load(path)
    assert other.step == tr.step
    assert torch.equal(other.params["table"], tr.params["table"])
    a = tr.optimizer.state_dict()["state"]
    b = other.optimizer.state_dict()["state"]
    assert torch.equal(a[0]["exp_avg_sq"], b[0]["exp_avg_sq"])
    assert other.optimizer.param_groups[0]["lr"] == \
        tr.optimizer.param_groups[0]["lr"]


def test_cli_trains_on_a_fixture_dataset(tmp_path, monkeypatch):
    """The CLI with the JAX CLI's flags: a few steps, then the final
    evaluation, args.json and log.json; --num_devices > 1 is refused.
    The config the CLI builds gets a 32^3 grid and 256-ray eval chunks
    (no flags set them), so the CPU run stays short."""
    monkeypatch.setattr(tcli, "Stage1Config", functools.partial(
        tst.Stage1Config, grid_resolution=32, eval_chunk=256))
    write_fixture_dataset(str(tmp_path / "data"), res=16, n_train=2,
                          n_test=1)
    argv = ["--scene", "fixture", "--data_root", str(tmp_path / "data"),
            "--root", str(tmp_path / "runs"), "--exp_name", "nerf",
            "--batch_size", "12", "--max_steps", "3", "--n_levels", "2",
            "--log2_hashmap_size", "10", "--reg_type", "both"]
    metrics = tcli.main(argv, device="cpu")
    assert np.isfinite(metrics["psnr"])
    out = tmp_path / "runs" / "results" / "fixture" / "nerf"
    args = json.loads((out / "args.json").read_text())
    assert args["max_steps"] == 3 and args["reg_type"] == "both"
    assert json.loads((out / "log.json").read_text())["step"] == 3
    assert os.path.isdir(tmp_path / "runs" / "logs" / "fixture" / "nerf")
    with pytest.raises(NotImplementedError):
        tcli.main(argv + ["--num_devices", "2"], device="cpu")
