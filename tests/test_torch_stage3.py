"""The port's stage 3 (geometry/native.py, extract.py, mc_tools.py,
cli/marching_cubes.py, cli/downsample_mesh.py) against the JAX
package's: the port builds its own copy of qfgeom.cc into build/qfgeom/,
whose BVH (dense and packed casts, refit), marching tetrahedra and
decimation give JAX's arrays bit for bit; the device filters (the
blur, the aligned upsample) and the surface grid sin(omega * q) within
stated tolerances; extract_mesh and both CLIs on the same exported
grids give the same files, counts and (within a stated distance) the
same meshes; the mc_tools utilities. Then a fresh interpreter with jax
and the JAX package blocked imports every stage-3/4 module of the port
and runs stage 3 and two stage-4 steps."""
import os
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from quadraturefields_tpu.cli import downsample_mesh as jcli_ds
from quadraturefields_tpu.cli import marching_cubes as jcli_mc
from quadraturefields_tpu.geometry import extract as jex
from quadraturefields_tpu.geometry import mc_tools as jmc
from quadraturefields_tpu.geometry import native as jnative
from quadraturefields_tpu.geometry.meshio import Mesh as JMesh
from quadraturefields_tpu.geometry.meshio import load_ply
from quadraturefields_tpu_torch.cli import downsample_mesh as tcli_ds
from quadraturefields_tpu_torch.cli import marching_cubes as tcli_mc
from quadraturefields_tpu_torch.geometry import extract as tex
from quadraturefields_tpu_torch.geometry import mc_tools as tmc
from quadraturefields_tpu_torch.geometry import native as tnative
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from test_torch_quadrature import sphere_mesh

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def field_grids(n=40, seed=0):
    """A stage-2 export at n^3: a noisy tanh shell field around a sphere
    of radius 0.5 (f32), its |grad| (f16), the 128^3 occupancy binaries
    of a ball of radius 0.9 and a density grid (f16) whose level 10
    surface is a sphere."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, n)
    r = np.sqrt(sum(c ** 2 for c in np.meshgrid(lin, lin, lin,
                                               indexing="ij")))
    grids = (np.tanh((r - 0.5) * 8)
             + rng.normal(0, 0.01, r.shape)).astype(np.float32)
    grads = (10 * np.abs(np.gradient(grids)[0])).astype(np.float16)
    lb = np.linspace(-1, 1, 128)
    rb = np.sqrt(sum(c ** 2 for c in np.meshgrid(lb, lb, lb,
                                                indexing="ij")))
    density = (20 * np.exp(-(r / 0.5) ** 4)).astype(np.float16)
    return grids, grads, rb < 0.9, density


def write_export(out, seed=0):
    grids, grads, binaries, density = field_grids(seed=seed)
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "grids_valid.npy"), grids)
    np.save(os.path.join(out, "grads_valid.npy"), grads)
    np.save(os.path.join(out, "binaries.npy"), binaries[None])
    np.save(os.path.join(out, "density_grids_valid.npy"), density)


def test_native_builds_its_own_copy(monkeypatch, tmp_path):
    """The port's qfgeom.cc is a copy of the JAX tree's; it builds into
    build/qfgeom/libqfgeom-<hash>.so and the port loads that library,
    never cpp/libqfgeom.so; without g++ a build raises."""
    src = REPO / "quadraturefields_tpu_torch" / "cpp" / "qfgeom.cc"
    assert src.read_bytes() == (REPO / "cpp" / "qfgeom.cc").read_bytes()
    path = tnative.build()
    assert path.parent == REPO / "build" / "qfgeom"
    assert path.name.startswith("libqfgeom-") and path.suffix == ".so"
    assert Path(tnative._get_lib()._name) == path
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.build()


def test_bvh_marching_tets_and_decimation_equal_jax():
    """Both packages' native layers on the same meshes, rays and grid:
    dense and packed casts (a cap that holds every hit and one that
    truncates), the casts after a vertex refit, marching tetrahedra and
    the vertex-cluster decimation, all bit for bit."""
    rng = np.random.default_rng(1)
    verts, faces = sphere_mesh()
    o = rng.normal(size=(300, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jb, tb = jnative.BVH(verts, faces), tnative.BVH(verts, faces)
    moved = verts * (1.0 + 0.1 * rng.uniform(-1, 1, (len(verts), 1))) \
        .astype(np.float32)
    for step in range(2):
        for a, b in zip(jb.intersect(o, d, 6), tb.intersect(o, d, 6)):
            np.testing.assert_array_equal(b, a)
        for cap in (300 * 6, 97):
            ja = jb.intersect_packed(o, d, 6, cap)
            ta = tb.intersect_packed(o, d, 6, cap)
            for a, b in zip(ja[:3], ta[:3]):
                np.testing.assert_array_equal(b, a)
            assert ta[3] == ja[3] > 97
        jb.update_vertices(moved)
        tb.update_vertices(moved)
    grids, _, _, _ = field_grids()
    jm = jnative.marching_tetrahedra(grids, 0.0)
    tm = tnative.marching_tetrahedra(grids, 0.0)
    assert tm[1].shape[0] > 1000
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jnative.decimate_vertex_clustering(*jm, 1 / 20.0),
                    tnative.decimate_vertex_clustering(*tm, 1 / 20.0)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        tnative.segment_mesh(verts, faces), jnative.segment_mesh(verts, faces))


def _capture_surfaces(omega):
    """(JAX's, the port's) grid passed to marching_tetrahedra first
    (the quadrature surface) by extract_mesh on field_grids()."""
    grids, grads, binaries, density = field_grids()
    seen = {}

    def recorder(key, real):
        def fn(grid, level, *a, **k):
            seen.setdefault(key, np.array(grid))
            return real(grid, level, *a, **k)
        return fn

    kw = dict(grids=grids, grads=grads, binaries=binaries,
              nerf_density=density, save=False, omega=omega)
    with mock.patch.object(jex, "marching_tetrahedra",
                           recorder("jax", jex.marching_tetrahedra)), \
            mock.patch.object(tex, "marching_tetrahedra",
                              recorder("port", tex.marching_tetrahedra)):
        jmesh = jex.extract_mesh("", **kw)
        tmesh = tex.extract_mesh("", device="cpu", **kw)
    return seen["jax"], seen["port"], jmesh, tmesh


def test_filters_and_surface_grid_match_jax():
    """The blur within 1e-6 (XLA's conv and F.conv1d sum five taps in
    their own orders), the aligned upsample bit for bit (JAX's index
    formula, i * (in - 1) computed first), and the surface sin(omega*q)
    before the isosurface within 1e-4 at omega 100 (omega times the
    blur's f32 ulps) and 3e-5 at omega 30; marching tetrahedra on
    JAX's surface gives JAX's mesh bit for bit."""
    grids, _, binaries, _ = field_grids()
    j = np.asarray(jex.gaussian_smooth_3d(jnp.asarray(grids)))
    t = tex.gaussian_smooth_3d(torch.as_tensor(grids)).numpy()
    assert np.abs(t - j).max() <= 1e-6
    for shape in ((40, 40, 40), (97, 64, 200)):
        j = np.asarray(jex.upsample_trilinear_aligned(
            jnp.asarray(binaries, jnp.float32), shape))
        t = tex.upsample_trilinear_aligned(torch.as_tensor(binaries),
                                           shape).numpy()
        np.testing.assert_array_equal(t, j)
    for omega, tol in ((100.0, 1e-4), (30.0, 3e-5)):
        js, ts, _, _ = _capture_surfaces(omega)
        assert np.abs(ts - js).max() <= tol, omega
        for a, b in zip(jex.marching_tetrahedra(js, 0.0),
                        tex.marching_tetrahedra(js, 0.0)):
            np.testing.assert_array_equal(b, a)


def mesh_distance(a, b) -> float:
    """Largest distance from a vertex of either mesh to the nearest
    vertex of the other."""
    return float(max(cKDTree(a.vertices).query(b.vertices)[0].max(),
                     cKDTree(b.vertices).query(a.vertices)[0].max()))


def test_cli_chain_matches_jax(tmp_path):
    """run_nerfsynthetic_mc.sh's arguments through both packages' CLIs
    on copies of the same export (the port's on the CPU): both write
    mesh.ply, mesh_nerf.ply and smp_mesh.ply; mesh_nerf.ply (the density
    surface) is byte-equal; mesh.ply and smp_mesh.ply have vertex and
    face counts within 1% of JAX's and every vertex within 1e-3 of one
    of the other mesh's (the quadrature surface's f32 differences move
    vertices along their edges); smp_mesh has fewer vertices."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    write_export(jdir)
    shutil.copytree(jdir, tdir)
    argv = ["100.0", "True", "100", "0", "0", "True", "0.01", "10.0"]
    jcli_mc.main([jdir] + argv)
    tcli_mc.main([tdir] + argv, device="cpu")
    jcli_ds.main([os.path.join(jdir, "mesh.ply"), "150"])
    tcli_ds.main([os.path.join(tdir, "mesh.ply"), "150"], device="cpu")
    with open(os.path.join(jdir, "mesh_nerf.ply"), "rb") as f, \
            open(os.path.join(tdir, "mesh_nerf.ply"), "rb") as g:
        assert f.read() == g.read()
    for name in ("mesh.ply", "smp_mesh.ply"):
        jm = load_ply(os.path.join(jdir, name))
        tm = load_ply(os.path.join(tdir, name))
        for a, b in ((jm.vertices, tm.vertices), (jm.faces, tm.faces)):
            assert a.shape[0] > 100
            assert abs(b.shape[0] - a.shape[0]) <= 0.01 * a.shape[0], name
        assert mesh_distance(jm, tm) <= 1e-3, name
    assert load_ply(os.path.join(tdir, "smp_mesh.ply")).vertices.shape[0] \
        < load_ply(os.path.join(tdir, "mesh.ply")).vertices.shape[0]


def test_extract_mesh_and_downsample_match_jax():
    """extract_mesh (combine off and on) and downsample_mesh on the same
    grids: counts within 1% and vertices within 1e-3, and the downsample
    of JAX's mesh through the port's decimation equal to JAX's."""
    grids, grads, binaries, density = field_grids(seed=3)
    kw = dict(grids=grids, grads=grads, binaries=binaries,
              nerf_density=density, save=False, omega=30.0,
              grad_thres=1e-4, density_thres=5.0)
    for combine in (False, True):
        jm = jex.extract_mesh("", combine=combine, **kw)
        tm = tex.extract_mesh("", combine=combine, device="cpu", **kw)
        assert abs(tm.faces.shape[0] - jm.faces.shape[0]) \
            <= 0.01 * jm.faces.shape[0]
        assert mesh_distance(jm, tm) <= 1e-3
    a = jex.downsample_mesh(jm, vx=40.0)
    b = tex.downsample_mesh(TMesh(jm.vertices, jm.faces), vx=40.0)
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.faces, a.faces)


def test_mc_tools_match_jax():
    """expand_binaries bit for bit; clean_mesh and the train-view
    visibility pruning (and its complement) equal; the transmittance
    grid of an analytic sphere density within 1e-5."""
    _, _, binaries, _ = field_grids()
    small = binaries[::4, ::4, ::4]
    np.testing.assert_array_equal(tmc.expand_binaries(small, 48, "cpu"),
                                  jmc.expand_binaries(small, 48))
    verts, faces = sphere_mesh()
    faces = np.concatenate([faces, [[0, 0, 1]]]).astype(np.int32)
    a = jmc.clean_mesh(JMesh(verts, faces))
    b = tmc.clean_mesh(TMesh(verts, faces))
    np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_array_equal(b.vertices, a.vertices)

    from quadraturefields_tpu_torch.data.nerf_synthetic import Rays

    rng = np.random.default_rng(2)
    o = np.tile([[0.0, -2.0, 0.0]], (64, 1)).astype(np.float32)
    d = rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32)
    d[:, 1] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    views = [{"rays": Rays(o, d)}]
    for comp in (False, True):
        a = jmc.prune_mesh_train_visibility(JMesh(verts, faces[:-1]), views,
                                            complement=comp)
        b = tmc.prune_mesh_train_visibility(TMesh(verts, faces[:-1]), views,
                                            complement=comp)
        np.testing.assert_array_equal(b.faces, a.faces)
        assert 0 < b.faces.shape[0] < faces.shape[0] - 1

    def density(lib):
        def fn(x):
            r = lib.sqrt((x ** 2).sum(-1, keepdims=True))
            return 50.0 * (r < 0.5)
        return fn

    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    j = jmc.grid_transmittance(density(jnp), aabb, views, grid_size=16,
                               render_step_size=2e-2, chunk=32)
    t = tmc.grid_transmittance(density(torch), aabb, views, grid_size=16,
                               render_step_size=2e-2, chunk=32,
                               device="cpu")
    assert t.shape == (16, 16, 16) and t.max() > 0.9
    assert np.abs(t - j).max() <= 1e-5


def test_stages_3_and_4_run_without_jax():
    """A fresh interpreter, with jax and the JAX package blocked from
    importing, imports every stage-3/4 module of the port, extracts and
    decimates a mesh and trains two stage-4 steps (one frozen, one
    joint) through train_one_step with the prefetcher live."""
    code = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "quadraturefields_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import tempfile
import numpy as np, torch
import quadraturefields_tpu_torch.geometry.mc_tools
import quadraturefields_tpu_torch.cli.marching_cubes
import quadraturefields_tpu_torch.cli.downsample_mesh
import quadraturefields_tpu_torch.cli.train_finetune
from quadraturefields_tpu_torch.data.nerf_synthetic import Rays
from quadraturefields_tpu_torch.geometry.extract import (
    downsample_mesh, extract_mesh)
from quadraturefields_tpu_torch.models.ngp import ngp_init
from quadraturefields_tpu_torch.train.stage4_finetune import (
    Stage4Config, Stage4Trainer)

lin = np.linspace(-1, 1, 24)
r = np.sqrt(sum(c ** 2 for c in np.meshgrid(lin, lin, lin, indexing="ij")))
grid = np.tanh((r - 0.5) * 8).astype(np.float32)
mesh = extract_mesh("", grids=grid, grads=np.ones_like(grid),
                    binaries=np.ones((128,) * 3, bool), combine=False,
                    omega=30.0, save=False, device="cpu")
smp = downsample_mesh(mesh, vx=20.0)
assert smp.faces.shape[0] > 50, smp.faces.shape

class Views:
    num_rays = 128
    def update_num_rays(self, n):
        self.num_rays = n
    def fetch_train_batch(self):
        rng = np.random.default_rng(0)
        d = rng.uniform(-0.2, 0.2, (self.num_rays, 3)).astype(np.float32)
        d[:, 2] = 1.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.tile([[0.0, 0.0, -3.0]], (self.num_rays, 1)).astype(np.float32)
        return {"pixels": np.ones((self.num_rays, 3), np.float32),
                "rays": Rays(o, d), "color_bkgd": np.ones(3, np.float32)}

cfg = Stage4Config(n_levels=2, log2_hashmap_size=10, grid_resolution=32,
                   batch_size_log2=10, field_log2_hashmap_size=10,
                   field_max_res=32, freeze_rf_steps=1, max_hits=6)
ngp = ngp_init(torch.Generator().manual_seed(0), cfg.ngp_config())
tr = Stage4Trainer(cfg, ngp_params=ngp, mesh=smp, train_dataset=Views(),
                   device="cpu")
try:
    for _ in range(2):
        loss, nh, mse = tr.train_one_step()
        assert np.isfinite(float(loss)) and nh > 0, (loss, nh)
finally:
    tr.prefetcher.stop()
assert not any(k.split(".")[0] in ("jax", "jaxlib", "quadraturefields_tpu")
               for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
