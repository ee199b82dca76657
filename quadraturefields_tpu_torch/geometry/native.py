"""ctypes bindings for the host-side C++ geometry library.

A copy of quadraturefields_tpu/geometry/native.py with one change: where
the library is found and built. The source is the port's own copy,
quadraturefields_tpu_torch/cpp/qfgeom.cc; at first use g++ compiles it
(the JAX package's flags) into build/qfgeom/libqfgeom-<hash>.so at the
repo root, named by a hash of the source, the flags and the host's CPU
(model and features: -march=native), so neither an edited source nor
another machine's build is ever loaded. A missing g++ raises. Covers
the reference's native geometry stack (SURVEY §2.3 #9/#10, #13-17):
multi-hit BVH ray casting with vertex refit, isosurface extraction,
vertex-cluster decimation, mesh segmentation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "cpp" / "qfgeom.cc"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "qfgeom")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")

_lib = None
_lock = threading.Lock()


def _host_cpu() -> str:
    """The host CPU's model and feature flags: -march=native builds for
    them, so a library built on another machine must not load here."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f
                     if line.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + " " + platform.processor()


def build() -> Path:
    """Compile cpp/qfgeom.cc into build/qfgeom/, unless a build of the
    same source and flags for this host's CPU exists; returns the
    library's path."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_host_cpu().encode())
    out = BUILD_DIR / f"libqfgeom-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's geometry library is "
                           "built from cpp/qfgeom.cc at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temp name per process and thread, then an atomic rename:
    # concurrent builds never clash
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        lib.qf_bvh_create.restype = ctypes.c_void_p
        lib.qf_bvh_create.argtypes = [
            c_f32p, ctypes.c_int64, c_i32p, ctypes.c_int64,
        ]
        lib.qf_bvh_destroy.argtypes = [ctypes.c_void_p]
        lib.qf_bvh_update_vertices.argtypes = [ctypes.c_void_p, c_f32p]
        lib.qf_bvh_intersect.argtypes = [
            ctypes.c_void_p, c_f32p, c_f32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, c_i32p, c_f32p, c_i32p,
        ]
        lib.qf_bvh_intersect_packed.restype = ctypes.c_int64
        lib.qf_bvh_intersect_packed.argtypes = [
            ctypes.c_void_p, c_f32p, c_f32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            c_i32p, c_i32p, c_f32p,
        ]
        lib.qf_bvh_set_uv.argtypes = [ctypes.c_void_p, c_f32p]
        lib.qf_bvh_intersect_uv.argtypes = [
            ctypes.c_void_p, c_f32p, c_f32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, c_i32p, c_f32p, c_i32p,
            c_f32p,
        ]
        lib.qf_mc_run.restype = ctypes.c_void_p
        lib.qf_mc_run.argtypes = [
            c_f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, c_f32p, c_f32p,
        ]
        lib.qf_mesh_num_verts.restype = ctypes.c_int64
        lib.qf_mesh_num_verts.argtypes = [ctypes.c_void_p]
        lib.qf_mesh_num_faces.restype = ctypes.c_int64
        lib.qf_mesh_num_faces.argtypes = [ctypes.c_void_p]
        lib.qf_mesh_get.argtypes = [ctypes.c_void_p, c_f32p, c_i32p]
        lib.qf_mesh_free.argtypes = [ctypes.c_void_p]
        lib.qf_decimate_cluster.restype = ctypes.c_void_p
        lib.qf_decimate_cluster.argtypes = [
            c_f32p, ctypes.c_int64, c_i32p, ctypes.c_int64, ctypes.c_float,
        ]
        lib.qf_rasterize_uv.argtypes = [
            c_f32p, c_f32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, c_f32p, c_i32p,
        ]
        lib.qf_segment_mesh.argtypes = [
            c_f32p, ctypes.c_int64, c_i32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32, c_i32p,
        ]
        _lib = lib
        return _lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _collect_mesh(lib, handle):
    nv = lib.qf_mesh_num_verts(handle)
    nf = lib.qf_mesh_num_faces(handle)
    verts = np.empty((nv, 3), np.float32)
    faces = np.empty((nf, 3), np.int32)
    lib.qf_mesh_get(handle, _f32p(verts), _i32p(faces))
    lib.qf_mesh_free(handle)
    return verts, faces


class BVH:
    """Multi-hit BVH ray caster with vertex refit.

    Replaces Embree's intersects_id / the in-tree OptiX Intersector
    (reference mesh_utils.py:75-109,216-231). `intersect` returns
    per-ray hits sorted by depth, padded to max_hits with tri_id == -1.
    """

    def __init__(self, vertices, faces, n_threads: int = 0):
        self._lib = _get_lib()
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.n_threads = n_threads
        self._handle = self._lib.qf_bvh_create(
            _f32p(self.vertices),
            self.vertices.shape[0],
            _i32p(self.faces),
            self.faces.shape[0],
        )

    def update_vertices(self, vertices):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        assert self.vertices.shape == (self.vertices.shape[0], 3)
        self._lib.qf_bvh_update_vertices(self._handle, _f32p(self.vertices))

    def intersect(self, origins, viewdirs, max_hits: int = 25):
        origins = np.ascontiguousarray(origins, np.float32)
        viewdirs = np.ascontiguousarray(viewdirs, np.float32)
        n = origins.shape[0]
        tri_ids = np.empty((n, max_hits), np.int32)
        ts = np.empty((n, max_hits), np.float32)
        counts = np.empty((n,), np.int32)
        self._lib.qf_bvh_intersect(
            self._handle, _f32p(origins), _f32p(viewdirs), n, max_hits,
            self.n_threads, _i32p(tri_ids), _f32p(ts), _i32p(counts),
        )
        return tri_ids, ts, counts

    def intersect_packed(self, origins, viewdirs, max_hits: int = 25,
                         cap: int = 1 << 17):
        """Packed multi-hit cast: (slots [cap] i32, tri [cap] i32,
        ts [cap] f32, total int) — valid hits compacted ray-major /
        depth-sorted in C++, 12 B per actual hit instead of dense
        [R, max_hits] rows. slots = ray*max_hits + k, pad R*max_hits;
        tri pad -1. `total` is the TRUE hit count (may exceed cap —
        then the tail rays' hits truncate, matching the device
        pack_hit_rows semantics)."""
        origins = np.ascontiguousarray(origins, np.float32)
        viewdirs = np.ascontiguousarray(viewdirs, np.float32)
        n = origins.shape[0]
        slots = np.empty((cap,), np.int32)
        tri = np.empty((cap,), np.int32)
        ts = np.empty((cap,), np.float32)
        total = self._lib.qf_bvh_intersect_packed(
            self._handle, _f32p(origins), _f32p(viewdirs), n, max_hits,
            cap, self.n_threads, _i32p(slots), _i32p(tri), _f32p(ts),
        )
        return slots, tri, ts, int(total)

    def set_uv(self, uv_face_corners):
        """Attach [n_faces, 3, 2] per-face-corner UVs for intersect_uv."""
        self._uvfc = np.ascontiguousarray(uv_face_corners, np.float32)
        assert self._uvfc.shape == (self.faces.shape[0], 3, 2)
        self._lib.qf_bvh_set_uv(self._handle, _f32p(self._uvfc))

    def intersect_uv(self, origins, viewdirs, max_hits: int = 25):
        """As intersect, plus the hit's barycentric-interpolated UV
        [n, max_hits, 2] (requires set_uv). Moves the baked path's
        face-corner gather + barycentric solve to the host cast, where
        Möller–Trumbore has the barycentrics for free."""
        origins = np.ascontiguousarray(origins, np.float32)
        viewdirs = np.ascontiguousarray(viewdirs, np.float32)
        n = origins.shape[0]
        tri_ids = np.empty((n, max_hits), np.int32)
        ts = np.empty((n, max_hits), np.float32)
        counts = np.empty((n,), np.int32)
        uvs = np.empty((n, max_hits, 2), np.float32)
        self._lib.qf_bvh_intersect_uv(
            self._handle, _f32p(origins), _f32p(viewdirs), n, max_hits,
            self.n_threads, _i32p(tri_ids), _f32p(ts), _i32p(counts),
            _f32p(uvs),
        )
        return tri_ids, ts, counts, uvs

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.qf_bvh_destroy(self._handle)
        except Exception:
            pass


def marching_tetrahedra(grid, level: float, origin=None, spacing=None):
    """Isosurface of grid [nx, ny, nz] at `level` (marching tetrahedra).

    Replaces skimage.measure.marching_cubes (reference
    marching_cubes.py:64-74). origin/spacing place vertices in world
    coords (default: index coords like skimage)."""
    lib = _get_lib()
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    origin = np.asarray(
        origin if origin is not None else [0.0, 0.0, 0.0], np.float32
    )
    spacing = np.asarray(
        spacing if spacing is not None else [1.0, 1.0, 1.0], np.float32
    )
    h = lib.qf_mc_run(
        _f32p(grid), nx, ny, nz, float(level), _f32p(origin), _f32p(spacing)
    )
    return _collect_mesh(lib, h)


def decimate_vertex_clustering(vertices, faces, voxel_size: float):
    """Voxel vertex-clustering decimation (open3d
    simplify_vertex_clustering replacement; reference
    downsample_mesh.py:13-20)."""
    lib = _get_lib()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    h = lib.qf_decimate_cluster(
        _f32p(vertices), vertices.shape[0], _i32p(faces), faces.shape[0],
        float(voxel_size),
    )
    return _collect_mesh(lib, h)


def segment_mesh(vertices, faces, kthr: float = 0.01, min_size: int = 20):
    """Felzenszwalb-style segmentation over face adjacency; returns
    per-face segment labels (ScanNet Segmentator replacement; the
    baking stage consumes these like the *.segs.json 'segIndices',
    reference generate_uv_xatlas_old.py:40-46 — but per-face here,
    mapped to vertices by the caller when needed)."""
    lib = _get_lib()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    seg = np.empty((faces.shape[0],), np.int32)
    lib.qf_segment_mesh(
        _f32p(vertices), vertices.shape[0], _i32p(faces), faces.shape[0],
        float(kthr), int(min_size), _i32p(seg),
    )
    return seg
