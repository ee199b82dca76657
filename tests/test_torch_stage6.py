"""The port's stage 6 (baking/stage6.py, cli/bake.py) against the JAX
package's, on the same seeded inputs: prune_mesh's triangle weights and
kept faces with the same teacher (JAX's init carried across), mesh and
views (and spiral prune rings); segment_and_atlas's artifacts bit for
bit on one mesh; bake_textures' uint8 maps with the scripts' bf16 MLPs;
evaluate_baked's PSNR, each package on its own bake. Then the port
alone: the CLI chain stage 5 -> stage 6 on the CPU. The slow case runs
both packages' six-stage chain at tests/test_pipeline_full.py's
settings and prints the readings that chip_smoke.py's phase 9 gates."""
import dataclasses
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from quadraturefields_tpu.baking import stage6 as jst6
from quadraturefields_tpu.data import own_views as jviews
from quadraturefields_tpu.geometry.intersect import MeshIntersection as JMI
from quadraturefields_tpu.geometry.meshio import Mesh as JMesh
from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.train import stage5_fit_sg as jst5
from quadraturefields_tpu_torch.baking import stage6 as tst6
from quadraturefields_tpu_torch.data import own_views as tviews
from quadraturefields_tpu_torch.geometry.intersect import MeshIntersection \
    as TMI
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from quadraturefields_tpu_torch.train import stage5_fit_sg as tst5
from quadraturefields_tpu_torch.utils.convert import params_from_jax
from test_torch_quadrature import sphere_mesh
from test_torch_stage5 import run_stage5_cli, stage4_checkpoint

torch.set_num_threads(1)

SMALL = dict(n_levels=4, log2_hashmap_size=12, num_lobes=2)
AABB = np.array([-1.5] * 3 + [1.5] * 3, np.float32)
TEX = 128


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(compute_dtype):
    """JAX's init of Stage5Config's SG model and teacher at SMALL (each
    table scaled by 1e4; the teacher's last base layer by 8, so that its
    density spans ~1e-2 to ~1e3 and the baked alpha codes vary) in both
    packages, and their configs with `compute_dtype` MLPs: ((jax sg,
    jax teacher), (port sg, port teacher), (jax cfgs), (port cfgs))."""
    jc = [dataclasses.replace(c, compute_dtype=compute_dtype) for c in (
        jst5.Stage5Config(**SMALL).sg_config(),
        jst5.Stage5Config(**SMALL).teacher_config())]
    tc = [dataclasses.replace(c, compute_dtype=compute_dtype) for c in (
        tst5.Stage5Config(**SMALL).sg_config(),
        tst5.Stage5Config(**SMALL).teacher_config())]
    keys = jax.random.split(jax.random.PRNGKey(8))
    jp = [jngp.ngp_init(k, c) for k, c in zip(keys, jc)]
    for p in jp:
        p["table"] = p["table"] * 1e4
    last = jp[1]["mlp_base"]["layers"][-1]
    last["w"] = last["w"] * 8.0
    return jp, [params_from_jax(_np(p)) for p in jp], jc, tc


class _Views:
    """n_views square views of res^2 pixels around the origin (the
    loader's eval interface), seeded smooth pixels."""

    def __init__(self, n_views=3, res=24, distance=2.2, seed=0):
        self.HEIGHT = self.WIDTH = res
        rng = np.random.default_rng(seed)
        poses = tviews.create_uniform_camera_poses(distance, n=n_views,
                                                   z=0.6)
        self.views = []
        for c2w in poses:
            loader = tviews.SubjectLoaderOwnViews(resolution=res,
                                                  n_views=1)
            loader.camera_poses = c2w[None]
            rays = loader.rays_for_view(0)
            pix = 0.5 + 0.4 * np.sin(rays.viewdirs * 3.0
                                     + rng.uniform(0, 1, 3))
            self.views.append({"rays": rays,
                               "pixels": pix.astype(np.float32)})

    def __len__(self):
        return len(self.views)

    def fetch_eval_view(self, i):
        return self.views[i]


def _mesh():
    verts, faces = sphere_mesh(30)
    return verts * 1.2, faces


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    """Both packages' prune_mesh on the same f32 teacher, sphere mesh
    (radius 0.6), three views and each package's spiral rings (2 views
    a ring at 16^2), at a threshold of JAX's median weight; each writes
    triangle_weights.npy and mesh_updated.ply."""
    jp, tp, jc, tc = models("float32")
    verts, faces = _mesh()
    views = _Views()
    rings = {mod: mod.spiral_prune_rings(distance=2.5, n_per_ring=2,
                                         resolution=16)
             for mod in (jviews, tviews)}
    for a, b in zip(rings[jviews], rings[tviews]):
        np.testing.assert_array_equal(a.rays_for_view(1).viewdirs,
                                      b.rays_for_view(1).viewdirs)
    kw = dict(render_step_size=5e-3, rays_per_batch=1000)
    jmi = JMI(mesh=JMesh(verts, faces), simplify_mesh=False, scale=1.0,
              num_intersections=8)
    _, w = jst6.prune_mesh(jp[1], jc[1], jmi, views, AABB,
                           extra_views=rings[jviews], **kw)
    thres = float(np.median(w[w > 0]))
    out = {"jax_jit": w}
    for name, st6, mi, p, c, mesh_cls in (
            ("jax", jst6, JMI, jp[1], jc[1], JMesh),
            ("port", tst6, TMI, tp[1], tc[1], TMesh)):
        d = str(tmp_path_factory.mktemp(name))
        m = mi(mesh=mesh_cls(verts, faces), simplify_mesh=False, scale=1.0,
               num_intersections=8)
        with jax.disable_jit(name == "jax"):
            mesh, w = st6.prune_mesh(
                p, c, m, views, AABB, weight_thres=thres, out_dir=d,
                extra_views=rings[jviews if name == "jax" else tviews], **kw)
        out[name] = (mesh, w, d)
    return out, thres


def test_prune_mesh_matches_jax(pruned):
    """The triangle weights within 1e-4 of max of JAX's run eagerly; the
    kept faces equal but for faces whose weight lies within 1e-4 of max
    of the threshold; the pruned meshes and the files equal where the
    kept faces are. JAX's jitted prune lies within 1e-3 of max of both
    (measured 3.2e-4): XLA fuses the hit positions' multiply-add, whose
    ulps the teacher's finest level (resolution 4096) magnifies."""
    out, thres = pruned
    (jm, jw, jd), (tm, tw, td) = out["jax"], out["port"]
    scale = np.abs(jw).max()
    assert np.abs(tw - jw).max() <= 1e-4 * scale
    assert np.abs(tw - out["jax_jit"]).max() <= 1e-3 * scale
    near = np.abs(jw - thres) <= 1e-4 * scale
    assert ((tw > thres) == (jw > thres))[~near].all()
    assert 0.2 < (jw > thres)[jw > 0].mean() < 0.8
    np.testing.assert_array_equal(
        np.load(os.path.join(td, "triangle_weights.npy")), tw)
    if ((tw > thres) == (jw > thres)).all():
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        assert filecmp.cmp(os.path.join(td, "mesh_updated.ply"),
                           os.path.join(jd, "mesh_updated.ply"),
                           shallow=False)


@pytest.fixture(scope="module")
def atlases(tmp_path_factory):
    """Both packages' segment_and_atlas on the same mesh (the sphere,
    its vertices jittered so that the segmentation has work), at 128^2,
    writing their artifacts."""
    verts, faces = _mesh()
    rng = np.random.default_rng(2)
    verts = (verts * (1 + 0.03 * rng.normal(size=(verts.shape[0], 1)))) \
        .astype(np.float32)
    out = {}
    for name, st6, mesh_cls in (("jax", jst6, JMesh),
                                ("port", tst6, TMesh)):
        d = str(tmp_path_factory.mktemp(name))
        out[name] = (st6.segment_and_atlas(mesh_cls(verts, faces), TEX,
                                           out_dir=d), d)
    return out


def test_segment_and_atlas_bit_for_bit(atlases):
    """The atlas mesh, UVs, V image and triangle image equal JAX's, and
    every artifact file (atlas_stats.json, the segs.json, the atlas OBJ,
    V_128.npy) is byte for byte JAX's."""
    (jres, jd), (tres, td) = atlases["jax"], atlases["port"]
    jam, juv, jv, jt = jres
    tam, tuv, tv, tt = tres
    np.testing.assert_array_equal(tam.vertices, jam.vertices)
    np.testing.assert_array_equal(tam.faces, jam.faces)
    for a, b in ((tuv, juv), (tv, jv), (tt, jt)):
        np.testing.assert_array_equal(a, b)
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == names == sorted([
        "atlas_stats.json", "mesh_updated.0.010000.segs.json",
        f"mesh_segmentation_{TEX}.obj", f"V_{TEX}.npy"])
    for name in names:
        assert filecmp.cmp(os.path.join(td, name), os.path.join(jd, name),
                           shallow=False), name
    stats = json.load(open(os.path.join(td, "atlas_stats.json")))
    assert stats["n_charts"] > 1 and stats["raster_utilization"] > 0.3


@pytest.fixture(scope="module")
def baked(atlases, tmp_path_factory):
    """Both packages' bake_textures of the same SG model and teacher
    with the scripts' bf16 MLPs on the port's atlas; each writes its
    PNGs (the port's through utils/png.py)."""
    jp, tp, jc, tc = models("bfloat16")
    (_, _, v_image, tri_image), _ = atlases["port"]
    out = {}
    for name, st6, p, c in (("jax", jst6, jp, jc), ("jax_eager", jst6, jp, jc),
                            ("port", tst6, tp, tc)):
        d = str(tmp_path_factory.mktemp(name))
        with jax.disable_jit(name == "jax_eager"):
            out[name] = st6.bake_textures(
                p[0], c[0], v_image, tri_image, AABB, teacher_params=p[1],
                teacher_cfg=c[1], texture_size=TEX, chunk=4096, out_dir=d)
        out[name + "_dir"] = d
    return out


def _channels(comp):
    """The maps of a FeatureCompression as one [N, N, 1+3+6L] int16."""
    return np.concatenate([comp.alpha[..., None], comp.diffuse,
                           *comp.lambdas, *comp.sg_colors],
                          axis=-1).astype(np.int16)


def test_bake_textures_matches_jax(baked, atlases):
    """With the scripts' bf16 MLPs the port's uint8 maps equal JAX's run
    eagerly, bit for bit. JAX's jitted bake (its pipeline's) lies at
    most one level from both at up to 0.5% of the filled texels'
    channels (measured 0.26%; 4.2% of the texels have one): XLA fuses
    and reassociates the encode's and the MLPs' f32 arithmetic, whose
    ulps move a uint8 code across a level now and then. The port's PNGs
    hold its maps."""
    from quadraturefields_tpu_torch.utils.png import read_png

    t = baked["port"]
    (_, _, _, tri_image), _ = atlases["port"]
    filled = tri_image >= 0
    np.testing.assert_array_equal(_channels(t), _channels(baked["jax_eager"]))
    diff = np.abs(_channels(t) - _channels(baked["jax"]))
    assert not diff[~filled].any()
    moved = diff[filled]
    share = float((moved > 0).mean())
    texels = float((moved > 0).any(axis=-1).mean())
    print(f"bake against jitted JAX: {share:.6f} of {moved.size} filled "
          f"texel channels ({texels:.6f} of the texels) one level apart, "
          f"at most {int(moved.max())}")
    assert moved.max() <= 1 and share <= 5e-3
    assert int(filled.sum()) > 1000
    assert np.unique(t.alpha[filled]).size > 3
    prefix = os.path.join(baked["port_dir"], f"texture_{TEX}")
    np.testing.assert_array_equal(
        read_png(os.path.join(prefix, "alpha.png")), t.alpha)
    np.testing.assert_array_equal(
        read_png(os.path.join(prefix, "color_1.png")), t.sg_colors[1])


def test_evaluate_baked_matches_jax(baked, atlases, tmp_path):
    """Each package's BakedRenderer on its own bake and the atlas:
    evaluate_baked's PSNR within 0.05 dB and its SSIM within 1e-3 of
    JAX's on three views; both write the results file."""
    (am, uv, _, _), _ = atlases["port"]
    views = _Views(seed=3)
    res = {}
    for name, st6, mesh_cls, cfg, kw in (
            ("jax", jst6, JMesh, jst5.Stage5Config(**SMALL).sg_config(), {}),
            ("port", tst6, TMesh, tst5.Stage5Config(**SMALL).sg_config(),
             dict(device="cpu"))):
        r = st6.BakedRenderer(mesh_cls(am.vertices, am.faces), uv,
                              baked[name], cfg, max_hits=8,
                              render_step_size=5e-3, **kw)
        path = str(tmp_path / f"{name}.json")
        res[name] = st6.evaluate_baked(r, views, out_path=path)
        assert json.load(open(path))["n_views"] == 3
    print(f"baked eval: jax {res['jax']}, port {res['port']}")
    assert abs(res["port"]["psnr"] - res["jax"]["psnr"]) <= 0.05
    assert abs(res["port"]["ssim"] - res["jax"]["ssim"]) <= 1e-3
    assert np.isfinite(res["port"]["psnr"]) and res["port"]["fps"] > 0


def test_bake_cli_prune_and_uv_flags_match_jax(tmp_path):
    """The two CLIs' `prune` with --prune_spiral_views (2 views a ring,
    3 rings at distance 2.5) and `uv` with --min_segment_size, on one
    fixture dataset, teacher (JAX's init as models() lifts it, saved
    for each package) and sphere mesh: the triangle weights within 1e-4
    of max of JAX's CLI run eagerly (its jitted prune moves them, as
    test_prune_mesh_matches_jax measures), the kept faces equal but near
    the threshold; from one jittered sphere, every `uv` artifact byte for
    byte JAX's. A larger --min_segment_size leaves fewer segments than
    the adaptive default."""
    from quadraturefields_tpu.cli import bake as jcli6
    from quadraturefields_tpu.utils.checkpoint import (
        save_checkpoint as jax_save,
    )
    from quadraturefields_tpu_torch.cli import bake as tcli6
    from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
    from quadraturefields_tpu_torch.geometry.meshio import load_ply, save_ply
    from quadraturefields_tpu_torch.utils.checkpoint import save_checkpoint

    data = str(tmp_path / "data")
    write_fixture_dataset(data, res=16, n_train=2, n_test=1)
    # the JAX CLI's teacher: the mlp head, cube interpolation
    cfg = jngp.NGPConfig(head="mlp", use_viewdirs=False, num_layers=2,
                         log2_hashmap_size=10)
    p = jngp.ngp_init(jax.random.PRNGKey(8), cfg)
    p["table"] = p["table"] * 1e4
    last = p["mlp_base"]["layers"][-1]
    last["w"] = last["w"] * 8.0
    jax_ckpt = str(tmp_path / "jax_teacher")
    jax_save(jax_ckpt, {"radiance_field": p})
    port_ckpt = str(tmp_path / "teacher.pt")
    save_checkpoint(port_ckpt, {"radiance_field": params_from_jax(_np(p))})
    mesh_path = str(tmp_path / "mesh.ply")
    save_ply(mesh_path, TMesh(*_mesh()))
    common = ["--scene", "fixture", "--data_root", data, "--mesh_path",
              mesh_path, "--log2_hashmap_size", "10", "--max_hits", "8",
              "--prune_spiral_views", "2", "--prune_spiral_distance", "2.5",
              "--texture_size", "128"]
    jroot, troot = str(tmp_path / "jax_runs"), str(tmp_path / "port_runs")
    jout = os.path.join(jroot, "results", "fixture", "baking")
    tout = os.path.join(troot, "results", "fixture", "baking")
    with jax.disable_jit():
        jcli6.main(["prune", "--root", jroot, "--ckpt_path", jax_ckpt,
                    *common])
    tcli6.main(["prune", "--root", troot, "--ckpt_path", port_ckpt,
                "--interp", "cube", *common], device="cpu")
    jw = np.load(os.path.join(jout, "triangle_weights.npy"))
    tw = np.load(os.path.join(tout, "triangle_weights.npy"))
    scale = np.abs(jw).max()
    assert scale > 0
    assert np.abs(tw - jw).max() <= 1e-4 * scale
    thres = 1e-3   # prune_mesh's weight_thres, which the CLIs keep
    near = np.abs(jw - thres) <= 1e-4 * scale
    assert ((tw > thres) == (jw > thres))[~near].all()
    kept = load_ply(os.path.join(tout, "mesh_updated.ply")).faces.shape[0]
    assert 0 < kept < _mesh()[1].shape[0]

    # `uv` in both run directories from one connected mesh (the pruned
    # one falls into small pieces that no merge floor joins): the
    # sphere, jittered as the atlases fixture jitters it
    verts, faces = _mesh()
    rng = np.random.default_rng(2)
    verts = (verts * (1 + 0.03 * rng.normal(size=(verts.shape[0], 1)))) \
        .astype(np.float32)
    for out in (jout, tout):
        save_ply(os.path.join(out, "mesh_updated.ply"), TMesh(verts, faces))
    uv = ["uv", *common, "--min_segment_size", "60"]
    jcli6.main([*uv, "--root", jroot, "--ckpt_path", jax_ckpt])
    tcli6.main([*uv, "--root", troot, "--ckpt_path", port_ckpt, "--interp",
                "cube"], device="cpu")
    names = ["atlas_stats.json", "mesh_updated.0.010000.segs.json",
             "mesh_segmentation_128.obj", "V_128.npy", "atlas_uv.npy",
             "tri_image.npy"]
    for name in names:
        assert filecmp.cmp(os.path.join(tout, name),
                           os.path.join(jout, name), shallow=False), name
    segs = os.path.join(tout, "mesh_updated.0.010000.segs.json")
    floor = set(json.load(open(segs))["segIndices"])
    tcli6.main(["uv", *common, "--root", troot, "--ckpt_path", port_ckpt,
                "--interp", "cube"], device="cpu")
    default = set(json.load(open(segs))["segIndices"])
    assert len(floor) < len(default), (len(floor), len(default))


def test_cli_chain_stage5_to_stage6(tmp_path, monkeypatch):
    """The stage-4 CLI's finetune.pt and mesh.ply and the stage-5 CLI's
    fit_sg.pt feed the bake CLI's `all` (run_nerfsynthetic_baking.sh's
    flags at tiny widths: a 64^2 texture, 2 lobes, log2_T 10, 8 hits a
    ray): it writes the artifact contract, and `eval` alone reads the
    saved atlas and PNGs back to the same result."""
    from quadraturefields_tpu_torch.cli import bake as tcli6

    data, runs, ckpt4, mesh4 = stage4_checkpoint(tmp_path, monkeypatch)
    ckpt5 = run_stage5_cli(data, runs, ckpt4, mesh4, monkeypatch)
    argv = ["--scene", "fixture", "--data_root", data, "--root", runs,
            "--exp_name", "baking", "--ckpt_path", ckpt4,
            "--sg_ckpt_path", ckpt5, "--mesh_path", mesh4,
            "--texture_size", "64", "--compression_type", "sigmoid",
            "--lambda_thres", "7.5", "--num_lobes", "2", "--max_hits", "8",
            "--log2_hashmap_size", "10", "--scale", "1.5"]
    results = tcli6.main(["all", *argv], device="cpu")
    out = os.path.join(runs, "results", "fixture", "baking")
    for name in ("triangle_weights.npy", "mesh_updated.ply",
                 "mesh_updated.0.010000.segs.json",
                 "mesh_segmentation_64.obj", "V_64.npy", "atlas_uv.npy",
                 "tri_image.npy", "atlas_stats.json",
                 "results_baking_textureimage_64.json"):
        assert os.path.exists(os.path.join(out, name)), name
    assert np.load(os.path.join(out, "V_64.npy")).dtype == np.float32
    pngs = sorted(os.listdir(os.path.join(out, "texture_64")))
    assert pngs == sorted(["alpha.png", "diffuse.png", "color_0.png",
                           "color_1.png", "lambda_axis_0.png",
                           "lambda_axis_1.png"])
    assert np.isfinite(results["psnr"]) and results["n_views"] == 1
    again = tcli6.main(["eval", *argv], device="cpu")
    assert again["psnr"] == results["psnr"]


@pytest.mark.slow
def test_six_stage_chain_gates_on_the_cpu(tmp_path):
    """Both packages' six-stage chain at tests/test_pipeline_full.py's
    settings (a 40^2 fixture, 8 train and 2 test views; stage 1: 220
    steps at 2^13 samples; stage 2: 120 steps, field log2_T 14, a 48^3
    export; stage 3 with the pipeline test's thresholds; stage 4: 50
    steps, 20 frozen, a mesh update at step 30; stage 5: 60 steps, 2
    lobes, 8 hits a ray, 2^12 hits; stage 6: the CLI's exhaustive prune
    of every train pixel, a 256^2 atlas, the bake and the baked eval of
    one test view), each from its own stage-1 run. Prints the stage-4
    PSNR, the stage-5 loss's means over its first and last 20 steps, the
    atlas's utilisation and the baked PSNR: chip_smoke.py phase 9 gates
    on them (FIT_SG_LOSS_GATE, RECT_ and RASTER_UTILIZATION_GATE,
    BAKED_PSNR_FLOOR, BAKED_PSNR_MARGIN), and each package must pass
    those gates here."""
    from chip_smoke import (
        BAKED_PSNR_FLOOR,
        BAKED_PSNR_MARGIN,
        FIT_SG_LOSS_GATE,
        RASTER_UTILIZATION_GATE,
        RECT_UTILIZATION_GATE,
    )
    from quadraturefields_tpu.data.fixture import (
        write_fixture_dataset as jax_write_fixture,
    )
    from quadraturefields_tpu.data.nerf_synthetic import (
        SubjectLoader as JLoader,
    )
    from quadraturefields_tpu.geometry import extract as jex
    from quadraturefields_tpu.train import stage1_ngp as jst1
    from quadraturefields_tpu.train import stage2_field as jst2
    from quadraturefields_tpu.train import stage4_finetune as jst4
    from quadraturefields_tpu_torch.data.nerf_synthetic import (
        SubjectLoader as TLoader,
    )
    from quadraturefields_tpu_torch.geometry import extract as tex
    from quadraturefields_tpu_torch.train import stage1_ngp as tst1
    from quadraturefields_tpu_torch.train import stage2_field as tst2
    from quadraturefields_tpu_torch.train import stage4_finetune as tst4

    data = str(tmp_path / "data")
    jax_write_fixture(data, res=40, n_train=8, n_test=2)
    common = dict(scene="fixture", data_root=data, grid_resolution=32,
                  render_step_size=2e-2, num_lobes=0, ckpt_every=10**9,
                  log_every=10**9)
    s1 = dict(common, max_steps=220, init_batch_size=512,
              batch_size_log2=13, eval_chunk=2048)
    s2 = dict(common, max_steps=120, batch_size_log2=13,
              field_log2_hashmap_size=14, field_max_res=64,
              grid_export_size=48)
    s4 = dict(common, max_steps=50, init_batch_size=512, batch_size_log2=12,
              up_sample=1, max_hits=8, freeze_rf_steps=20,
              mesh_update_every=30, scaling=0.02, max_num_rays=1 << 13,
              field_log2_hashmap_size=14, field_max_res=64)
    s5 = dict(common, max_steps=60, init_batch_size=512, batch_size_log2=12,
              num_lobes=2, up_sample=1, max_hits=8, max_num_rays=1 << 13)
    results = {}
    for name, m1, m2, m4, m5, m6, ex, loader, kw in (
        ("jax", jst1, jst2, jst4, jst5, jst6, jex, JLoader, {}),
        ("port", tst1, tst2, tst4, tst5, tst6, tex, TLoader,
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
        mesh = ex.extract_mesh(out, sigma=100.0, include_grad=True,
                               omega=30.0, thres=0.0, combine=True,
                               grad_thres=1e-4, density_thres=5.0,
                               save=False, **kw)
        smp = ex.downsample_mesh(mesh, vx=40.0)
        t4 = m4.Stage4Trainer(m4.Stage4Config(root=root, **s4),
                              ngp_params=t1.params, occ_state=t1.occ_state,
                              mesh=smp, **kw)
        while t4.step <= 50:
            t4.train_one_step()
            if t4.step == 30:
                t4.apply_mesh_update()
        t4.prefetcher.stop()
        test = loader(subject_id="fixture", root_fp=data, split="test",
                      num_rays=None)
        psnr4 = t4.evaluate(test, n_views=1)["psnr"]
        t5 = m5.Stage5Trainer(m5.Stage5Config(root=root, **s5),
                              teacher_params=t4.params["rf"],
                              occ_state=t4.occ_state,
                              mesh=t4.mesh_intersect.mesh, **kw)
        losses = []
        while t5.step <= 60:
            losses.append(float(t5.train_one_step()[0]))
        t5.prefetcher.stop()
        bake = os.path.join(root, "bake")
        os.makedirs(bake)
        train = loader(subject_id="fixture", root_fp=data, split="train",
                       num_rays=2048)
        pruned, _ = m6.prune_mesh(t4.params["rf"], t4.ngp_cfg,
                                  t4.mesh_intersect, train, t4.aabb,
                                  render_step_size=2e-2, out_dir=bake)
        am, uv, v_image, tri_image = m6.segment_and_atlas(pruned, 256,
                                                          out_dir=bake)
        with open(os.path.join(bake, "atlas_stats.json")) as f:
            stats = json.load(f)
        comp = m6.bake_textures(t5.sg_params, t5.sg_cfg, v_image, tri_image,
                                t5.aabb, teacher_params=t4.params["rf"],
                                teacher_cfg=t4.ngp_cfg, texture_size=256,
                                out_dir=bake)
        renderer = m6.BakedRenderer(am, uv, comp, t5.sg_cfg, max_hits=8,
                                    render_step_size=2e-2, **kw)
        baked = m6.evaluate_baked(renderer, test, n_views=1)["psnr"]
        first, last = np.mean(losses[:20]), np.mean(losses[-20:])
        results[name] = (psnr4, first, last, stats, baked)
        print(f"{name}: stage-4 PSNR {psnr4:.3f}; stage-5 loss first 20 "
              f"{first:.6f}, last 20 {last:.6f} (ratio {last / first:.4f});"
              f" pruned {pruned.faces.shape[0]} of "
              f"{t4.mesh_intersect.n_faces} faces; atlas {stats}; baked "
              f"PSNR {baked:.3f}")
    for name, (psnr4, first, last, stats, baked) in results.items():
        assert np.isfinite([first, last]).all(), name
        assert last < FIT_SG_LOSS_GATE * first, name
        assert stats["rect_utilization"] > RECT_UTILIZATION_GATE, name
        assert stats["raster_utilization"] > RASTER_UTILIZATION_GATE, name
        assert baked > BAKED_PSNR_FLOOR, name
        assert baked > psnr4 - BAKED_PSNR_MARGIN, name
