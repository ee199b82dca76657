"""The port's stage-1 training against the JAX trainer's: the
regularizers, one full training step (loss and gradients) on the same
weights, batch and stratified jitter for a synthetic and a 360 scene,
and with the stochastic corner gradient; the eval images that
save_images writes; one stochastic step of stages 2 and 4; then a
port-only training run on the fixture scene and the training CLI on a
written fixture dataset."""
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


def test_stochastic_training_step_matches_eager_jax(fixture_root):
    """One step with grad_mode "stochastic" (the corner pick from the
    hashed sample positions): the loss within 1e-5 relative of the JAX
    trainer's, each gradient with cosine >= 0.999 and norm within 1%, as
    for "exact". JAX runs eagerly (jax.disable_jit): jitted XLA fuses
    the sample positions' arithmetic, and one ulp of a position draws
    another uniform and so another corner (the table gradient's cosine
    then falls to ~0.94); eager JAX computes the port's positions bit
    for bit."""
    jtr, ttr, (o, d, px, bkgd) = _trainers("synthetic", fixture_root,
                                           grad_mode="stochastic")
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        (lj, auxj), gj = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jtr.params, jtr.occ_state, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(px), jnp.asarray(bkgd), key)
    u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    lt, auxt = ttr._loss_fn(ttr.params, ttr.occ_state, torch.tensor(o),
                            torch.tensor(d), torch.tensor(px),
                            torch.tensor(bkgd), torch.tensor(u))
    lt.backward()
    assert int(auxt["num_valid"]) == int(auxj["num_valid"]) > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(gj)
    tleaves = [p.grad for p in tst._leaves(ttr.params)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0
        assert a @ b / (na * nb) >= 0.999
        assert abs(na / nb - 1.0) <= 0.01


def test_save_images_writes_jax_pngs(fixture_root, tmp_path):
    """evaluate(out_dir) with save_images: rgb_test_000.png and
    rgb_error_000.png decode (with the port's reader and with imageio) to
    the pixels JAX's evaluate writes with imageio for the same render
    (JAX's trainer handed the port's view)."""
    import imageio.v2 as imageio

    from quadraturefields_tpu_torch.utils.png import read_png

    jtr, ttr, _ = _trainers("synthetic", fixture_root, save_images=True,
                            eval_chunk=1024)
    data = ttr.test_dataset.fetch_eval_view(0)
    view = ttr.render_view(data)
    assert 0.0 < float(view.min()) < 0.9
    jtr.render_view = lambda data: view.numpy()
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    ttr.evaluate(str(out_t))
    jtr.evaluate(str(out_j))
    for name in ("rgb_test_000.png", "rgb_error_000.png"):
        want = imageio.imread(str(out_j / name))
        assert want.dtype == np.uint8 and want.shape == (32, 32, 3)
        np.testing.assert_array_equal(read_png(str(out_t / name)), want)
        np.testing.assert_array_equal(imageio.imread(str(out_t / name)),
                                      want)
    pixels = np.asarray(data["pixels"], np.float32).reshape(32, 32, 3)
    err = read_png(str(out_t / "rgb_error_000.png"))
    assert err.max() > 0
    np.testing.assert_array_equal(
        err, (np.clip(np.abs(view.numpy().reshape(32, 32, 3) - pixels),
                      0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("stage", [2, 4])
def test_later_stages_step_with_stochastic_corner_gradient(stage,
                                                           monkeypatch):
    """Stage 2 and stage 4 with grad_mode "stochastic" on their corner
    tables: one training step runs, takes the stochastic table gradient
    and moves the trained table."""
    from quadraturefields_tpu_torch.models.ngp import ngp_init
    from quadraturefields_tpu_torch.ops import hashgrid as thg
    from quadraturefields_tpu_torch.train import stage2_field as tst2
    from quadraturefields_tpu_torch.train import stage4_finetune as tst4
    from test_torch_quadrature import SMALL, sphere_mesh
    from test_torch_render_field import occupancy
    from test_torch_stage4 import _Views
    from quadraturefields_tpu_torch.geometry.meshio import Mesh

    calls = []
    real = thg.table_grad_stochastic_plain

    def counting(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(thg, "table_grad_stochastic_plain", counting)
    gen = torch.Generator().manual_seed(0)
    if stage == 2:
        cfg = tst2.Stage2Config(
            n_levels=4, log2_hashmap_size=12, batch_size_log2=13,
            render_step_size=2e-2, num_lobes=0, field_log2_hashmap_size=12,
            field_max_res=64, grid_export_size=16, scene="fixture",
            grad_mode="stochastic")
        ngp = ngp_init(gen, cfg.ngp_config())
        ngp["table"] = ngp["table"] * 1e4
        occs, binaries = occupancy("synthetic", cfg.grid_resolution,
                                   cfg.render_step_size)
        tr = tst2.Stage2Trainer(
            cfg, ngp_params=ngp, train_dataset=_Views(),
            occ_state=occ_state_from_jax(occs, binaries, cfg.aabb),
            device="cpu")
        table = lambda: tr.field_params["table"]  # noqa: E731
    else:
        cfg = tst4.Stage4Config(
            **SMALL, scene="fixture", batch_size_log2=13, max_hits=6,
            render_step_size=2e-2, freeze_rf_steps=0, max_steps=100,
            grad_mode="stochastic")
        ngp = ngp_init(gen, cfg.ngp_config())
        ngp["table"] = ngp["table"] * 1e4
        occs, binaries = occupancy("synthetic", cfg.grid_resolution,
                                   cfg.render_step_size)
        tr = tst4.Stage4Trainer(
            cfg, ngp_params=ngp, mesh=Mesh(*sphere_mesh()),
            occ_state=occ_state_from_jax(occs, binaries, cfg.aabb),
            train_dataset=_Views(), device="cpu")
        table = lambda: tr.params["field"]["table"]  # noqa: E731
    before = table().detach().clone()
    try:
        out = tr.train_one_step()
    finally:
        if stage == 4:
            tr.prefetcher.stop()
    assert np.isfinite(float(out[0])) and tr.step == 1
    assert calls and all(c.grad_mode == "stochastic" for c in calls)
    assert not torch.equal(table().detach(), before)


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


@pytest.mark.slow
def test_stochastic_quality_cost_on_the_cpu(tmp_path):
    """Both packages train the fixture scene for 300 steps with the
    exact and with the stochastic corner gradient (chip_smoke.py phase
    4's and phase 10's trainer defaults, cut to a 48^2 fixture, L8 F2
    2^14 rows, a 32^3 grid and 2^14 samples a step), at seeds 42-44, and
    evaluate; prints each run's PSNR and each package's cost of the
    stochastic mode. chip_smoke.py's phase 10 gate STOCHASTIC_PSNR_MARGIN
    is set from these readings, and every cost must lie within it
    here."""
    from chip_smoke import STOCHASTIC_PSNR_MARGIN

    data = str(tmp_path / "data")
    jax_write_fixture(data, res=48, n_train=8, n_test=2)
    kw = dict(scene="fixture", data_root=data, max_steps=300,
              init_batch_size=512, batch_size_log2=14, grid_resolution=32,
              render_step_size=2e-2, n_levels=8, log2_hashmap_size=14,
              eval_chunk=2304, ckpt_every=10**9, log_every=10**9)
    psnrs = {}
    for name, mod, dev in (("jax", jst, {}), ("port", tst, {"device": "cpu"})):
        for seed in (42, 43, 44):
            for mode in ("exact", "stochastic"):
                tr = mod.Stage1Trainer(mod.Stage1Config(
                    root=str(tmp_path / name / mode), grad_mode=mode,
                    seed=seed, **kw), **dev)
                while tr.step <= kw["max_steps"]:
                    tr.train_one_step()
                psnrs[name, seed, mode] = tr.evaluate()["psnr"]
                print(f"{name} seed {seed} {mode}: eval PSNR "
                      f"{psnrs[name, seed, mode]:.4f} dB")
    for name in ("jax", "port"):
        for seed in (42, 43, 44):
            cost = (psnrs[name, seed, "exact"]
                    - psnrs[name, seed, "stochastic"])
            print(f"{name} seed {seed}: the stochastic mode costs "
                  f"{cost:.4f} dB (margin {STOCHASTIC_PSNR_MARGIN})")
            assert cost <= STOCHASTIC_PSNR_MARGIN, (name, seed, cost)


@pytest.mark.slow
@pytest.mark.parametrize("n_levels,log2_samples", [(8, 14), (16, 16)])
def test_360_quality_on_the_cpu(tmp_path, n_levels, log2_samples):
    """Both packages train the unbounded 360 path (scene_type "360": the
    contracted [-1, 1]^3 aabb, cone stepping from near 0.2 to far 100,
    no coarse level; 10 rays a step until the dynamic batch starts at
    step 100, as the 360 loader starts) on the fixture scene for 300
    steps at chip_smoke.py phase 11's settings cut to a 48^2 fixture,
    2^14 rows and 2^14 or 2^16 samples a step (L8 or the defaults' L16;
    its 128^3 grid kept), and evaluate; prints each package's final
    PSNR, the PSNR of the views' background alone and the loss ratio.
    The phase's gate (the PSNR at least the background's less
    TRAIN_360_PSNR_MARGIN) is set from these readings, and both must
    pass it here."""
    from chip_smoke import TRAIN_360_PSNR_MARGIN, background_psnr
    from quadraturefields_tpu.data import nerf_synthetic as jns
    from quadraturefields_tpu_torch.data import nerf_synthetic as tns

    data = str(tmp_path / "data")
    jax_write_fixture(data, res=48, n_train=8, n_test=2)
    kw = dict(scene="fixture", scene_type="360", data_root=data,
              max_steps=300, batch_size_log2=log2_samples,
              n_levels=n_levels, log2_hashmap_size=14, eval_chunk=2304,
              ckpt_every=10**9, log_every=10**9)
    for name, mod, ns, dev in (("jax", jst, jns, {}),
                               ("port", tst, tns, {"device": "cpu"})):
        views = dict(
            train_dataset=ns.SubjectLoader(subject_id="fixture",
                                           root_fp=data, split="train",
                                           num_rays=10),
            test_dataset=ns.SubjectLoader(subject_id="fixture",
                                          root_fp=data, split="test",
                                          num_rays=None))
        tr = mod.Stage1Trainer(mod.Stage1Config(
            root=str(tmp_path / name), **kw), **views, **dev)
        losses = []
        while tr.step <= kw["max_steps"]:
            losses.append(float(tr.train_one_step()[0]))
        ratio = np.mean(losses[-20:]) / np.mean(losses[:20])
        psnr = tr.evaluate()["psnr"]
        bg = background_psnr(views["test_dataset"])
        n_rays = views["train_dataset"].num_rays
        print(f"{name}: 360 path L{n_levels} 2^{log2_samples} samples, eval "
              f"PSNR {psnr:.4f} dB, the background alone {bg:.4f} dB "
              f"(gain {psnr - bg:.4f}), last-20 / first-20 loss "
              f"{ratio:.4f}, batch {n_rays} rays (margin "
              f"{TRAIN_360_PSNR_MARGIN} dB)")
        assert ratio < 1.0, (name, ratio)
        assert psnr >= bg - TRAIN_360_PSNR_MARGIN, (name, psnr, bg)
