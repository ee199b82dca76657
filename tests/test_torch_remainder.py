"""The port's last JAX-free modules against the JAX package's: the
vanilla and time-warped NeRF MLPs (models/mlp_nerf.py) through the
carried-over weights, the three data modules copied verbatim
(data/dnerf_synthetic.py, data/tandt.py, data/ray_utils.py) on fixture
data, the profiling utilities (utils/profiling.py), the NGP density
field's config and save_grid_npy."""
import dataclasses
import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadraturefields_tpu.data import dnerf_synthetic as jdn
from quadraturefields_tpu.data import ray_utils as jru
from quadraturefields_tpu.data import tandt as jtt
from quadraturefields_tpu.data.fixture import write_fixture_dataset
from quadraturefields_tpu.models import mlp_nerf as jmn
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu_torch.data import dnerf_synthetic as tdn
from quadraturefields_tpu_torch.data import ray_utils as tru
from quadraturefields_tpu_torch.data import tandt as ttt
from quadraturefields_tpu_torch.models import mlp_nerf as tmn
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.utils import checkpoint as tck
from quadraturefields_tpu_torch.utils import profiling as tprof
from quadraturefields_tpu_torch.utils.convert import mlp_nerf_params_from_jax

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


# a small width and the default depths (skip layer, condition MLP)
NERF_CFG = dict(net_width=64, net_width_condition=32)


def _with_biases(tree, rng):
    """The tree with every (zero-initialised) bias drawn from N(0, 0.5),
    so that the ReLUs pass both signs and the biases count."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.5, v.shape).astype(np.float32)
                    if k == "b" else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return tree


def test_vanilla_nerf_matches_jax():
    """vanilla_nerf_init's tree has JAX's shapes; with JAX's weights
    (biases drawn) carried over, query_density and forward agree within
    1e-5."""
    jcfg = jmn.VanillaNeRFConfig(**NERF_CFG)
    tcfg = tmn.VanillaNeRFConfig(**NERF_CFG)
    params = _np(jmn.vanilla_nerf_init(jax.random.PRNGKey(0), jcfg))
    own = tmn.vanilla_nerf_init(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(own) == _shapes(params)
    rng = np.random.default_rng(0)
    params = _with_biases(params, rng)
    params["sigma"]["b"] += 1.0   # densities above 0 somewhere
    tp = mlp_nerf_params_from_jax(params)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jmn.vanilla_nerf_query_density(params, x, jcfg))
    got = tmn.vanilla_nerf_query_density(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    rgb_j, sig_j = jmn.vanilla_nerf_forward(params, x, d, jcfg)
    rgb_t, sig_t = tmn.vanilla_nerf_forward(tp, torch.tensor(x),
                                            torch.tensor(d), tcfg)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=0,
                               atol=1e-5)
    assert float(np.abs(np.asarray(sig_j)).max()) > 0


def test_tnerf_matches_jax():
    """tnerf_init's tree has JAX's shapes (the warp's output layer in
    U(0, 1e-4)); with JAX's weights (biases drawn, the warp's output
    scaled up so that it moves
    the points), the warp, query_density and forward agree within
    1e-5."""
    jcfg = jmn.TNeRFConfig(nerf=jmn.VanillaNeRFConfig(**NERF_CFG))
    tcfg = tmn.TNeRFConfig(nerf=tmn.VanillaNeRFConfig(**NERF_CFG))
    params = _np(jmn.tnerf_init(jax.random.PRNGKey(1), jcfg))
    own = tmn.tnerf_init(torch.Generator().manual_seed(1), tcfg)
    assert _shapes(own) == _shapes(params)
    w_out = own["warp"]["out"]["w"]
    assert 0.0 <= float(w_out.min()) and float(w_out.max()) <= 1e-4
    rng = np.random.default_rng(1)
    params = _with_biases(params, rng)
    params["warp"]["out"]["w"] = params["warp"]["out"]["w"] * 1e3
    tp = mlp_nerf_params_from_jax(params)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (300, 1)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx, tt, td = (torch.tensor(a) for a in (x, t, d))
    warp_j = np.asarray(jmn.tnerf_warp(params, x, t, jcfg))
    warp_t = tmn.tnerf_warp(tp, tx, tt, tcfg).numpy()
    np.testing.assert_allclose(warp_t, warp_j, rtol=0, atol=1e-5)
    assert np.abs(warp_j - x).max() > 1e-3
    np.testing.assert_allclose(
        tmn.tnerf_query_density(tp, tx, tt, tcfg).numpy(),
        np.asarray(jmn.tnerf_query_density(params, x, t, jcfg)),
        rtol=0, atol=1e-5)
    for got, want in zip(tmn.tnerf_forward(tp, tx, tt, td, tcfg),
                         jmn.tnerf_forward(params, x, t, d, jcfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def _assert_batches_equal(a, b):
    """Two loaders' batches (dicts of arrays and Rays) equal byte for
    byte."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "rays":
            for f in ("origins", "viewdirs"):
                x, y = getattr(a[k], f), getattr(b[k], f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def test_dnerf_loader_matches_jax(tmp_path):
    """The fixture with per-frame times (as tests/test_aux_components.py
    builds it): the port's D-NeRF loader gives JAX's training batches,
    timestamps included, and its eval views, byte for byte."""
    root = str(tmp_path)
    write_fixture_dataset(root, res=16, n_train=3, n_test=2)
    for split in ("train", "test"):
        p = os.path.join(root, "fixture", f"transforms_{split}.json")
        with open(p) as f:
            meta = json.load(f)
        for i, fr in enumerate(meta["frames"]):
            fr["time"] = i / max(1, len(meta["frames"]) - 1)
        with open(p, "w") as f:
            json.dump(meta, f)
    for split, kw in (("train", dict(num_rays=64)), ("test", {})):
        j = jdn.SubjectLoader("fixture", root, split, **kw)
        t = tdn.SubjectLoader("fixture", root, split, **kw)
        assert t.timestamps.tobytes() == j.timestamps.tobytes()
        if split == "train":
            for _ in range(3):
                _assert_batches_equal(t.fetch_train_batch(),
                                      j.fetch_train_batch())
        for i in range(len(j)):
            _assert_batches_equal(t.fetch_eval_view(i), j.fetch_eval_view(i))


def _write_tandt(root, rng, n=3, h=12, w=16):
    """A Tanks-and-Temples layout: intrinsics, per-image poses, RGBA
    images (train_ and test_ prefixes) and the scene's bbox."""
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "rgb"))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write("20.0 0 8.0 0\n0 20.0 6.0 0\n0 0 1 0\n0 0 0 1\n")
    for split in ("train", "test"):
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) * 3
            np.savetxt(os.path.join(root, "pose", f"{split}_{i}.txt"), c2w)
            img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            imageio.imwrite(os.path.join(root, "rgb", f"{split}_{i}.png"),
                            img)
    np.savetxt(os.path.join(root, "bbox.txt"),
               [-1.0, -1.2, -0.8, 1.1, 0.9, 1.3, 0.0, 0.0])


def test_tandt_loader_matches_jax(tmp_path):
    """The port's Tanks-and-Temples loader gives JAX's arrays, batches
    and eval views byte for byte, on a written layout of each split."""
    root = str(tmp_path)
    _write_tandt(root, np.random.default_rng(2))
    for split, n_rays in (("train", 50), ("test", None)):
        j = jtt.TanksTempleDataset(root, num_rays=n_rays, split=split,
                                   downsample=2.0)
        t = ttt.TanksTempleDataset(root, num_rays=n_rays, split=split,
                                   downsample=2.0)
        for name in ("camtoworlds", "images", "K", "scene_bbox"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        if split == "train":
            for _ in range(3):
                _assert_batches_equal(t.fetch_train_batch(),
                                      j.fetch_train_batch())
        for i in range(len(j)):
            _assert_batches_equal(t.fetch_eval_view(i), j.fetch_eval_view(i))


def test_ray_utils_match_jax():
    """get_ray_directions, get_rays, ndc_rays and depth2dist give JAX's
    arrays byte for byte (as tests/test_more_components.py drives
    them)."""
    rng = np.random.default_rng(4)
    H, W = 8, 10
    for focal, center in ((10.0, None), ((9.0, 11.0), (4.5, 3.5))):
        a = tru.get_ray_directions(H, W, focal, center)
        b = jru.get_ray_directions(H, W, focal, center)
        assert a.tobytes() == b.tobytes()
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    (o1, d1), (o2, d2) = (m.get_rays(b, c2w) for m in (tru, jru))
    assert o1.tobytes() == o2.tobytes() and d1.tobytes() == d2.tobytes()
    d_fwd = d1.copy()
    d_fwd[:, 2] = -np.abs(d_fwd[:, 2]) - 0.5
    for x, y in zip(tru.ndc_rays(H, W, 10.0, 1.0, o1 - [0, 0, 5.0], d_fwd),
                    jru.ndc_rays(H, W, 10.0, 1.0, o1 - [0, 0, 5.0], d_fwd)):
        assert x.tobytes() == y.tobytes()
    z = np.sort(rng.uniform(0, 4, (5, 7)), axis=1).astype(np.float32)
    cos = rng.uniform(0.5, 1, 5).astype(np.float32)
    assert (tru.depth2dist(z, cos).tobytes()
            == jru.depth2dist(z, cos).tobytes())


def test_profiling_utils(tmp_path):
    """StageTimer and Throughput as JAX's; device_trace writes a trace
    file of the block on the CPU, which names its operators."""
    t = tprof.StageTimer()
    for _ in range(2):
        with t.section("a"):
            pass
    with t.section("b"):
        pass
    assert t.counts == {"a": 2, "b": 1}
    assert "a:" in t.summary() and "2 calls" in t.summary()
    tp = tprof.Throughput()
    tp.add(100)
    assert tp.rate() > 0
    tp.reset()
    assert tp.items == 0
    log_dir = str(tmp_path / "trace")
    with tprof.device_trace(log_dir) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64)).sum()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "aten::mm" in f.read()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_density_field_config_matches_jax():
    """density_field_config (reference NGPDensityField) equals JAX's
    field for field, with and without overrides."""
    for kw in ({}, dict(n_levels=4, max_resolution=64, unbounded=True)):
        want = dataclasses.asdict(jngp.density_field_config(**kw))
        got = dataclasses.asdict(tngp.density_field_config(**kw))
        assert got == want
        assert tngp.density_field_config(**kw).head_output_dim == 0


def test_save_grid_npy(tmp_path):
    """save_grid_npy writes tensors (on any device) and numpy arrays as
    .npy files that numpy reads back unchanged."""
    grid = torch.rand((4, 5, 6)).to(torch.float16)
    tck.save_grid_npy(str(tmp_path / "g.npy"), grid)
    back = np.load(tmp_path / "g.npy")
    assert back.dtype == np.float16
    assert np.array_equal(back, grid.numpy())
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    tck.save_grid_npy(str(tmp_path / "a.npy"), arr)
    assert np.array_equal(np.load(tmp_path / "a.npy"), arr)
