"""MeshIntersection: host-side ray-mesh hit provider for stages 4-6.

Replaces the reference's MeshIntersection (mesh_utils.py:180-527 over
Embree/OptiX): load mesh, optional vertex-clustering simplification,
scale to world, BVH build; per batch, multi-hit intersect producing the
dense [n_rays, max_hits] HitRows layout consumed by
render/quadrature.py. Includes an async prefetcher that overlaps the
CPU ray casting of the next batch with the device step (the reference
uses DataLoader worker processes for the same purpose,
train_finetune.py:307-317).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np

from ..parallel.multihost import process_local_slice
from .meshio import Mesh, load_ply
from .native import BVH, decimate_vertex_clustering


class MeshIntersection:
    def __init__(
        self,
        mesh_path: Optional[str] = None,
        mesh: Optional[Mesh] = None,
        simplify_mesh: bool = True,
        scale: float = 1.0,
        voxel_size: float = 512.0,
        num_intersections: int = 25,
        render_step_size: float = 0.005,
        n_threads: int = 0,
    ):
        if mesh is None:
            mesh = load_ply(mesh_path)
        if simplify_mesh:
            v, f = decimate_vertex_clustering(
                mesh.vertices, mesh.faces, 1.0 / voxel_size
            )
            mesh = Mesh(v, f)
        mesh = Mesh(mesh.vertices * scale, mesh.faces)
        self.mesh = mesh
        self.max_hits = num_intersections
        self.render_step_size = render_step_size
        self.bvh = BVH(mesh.vertices, mesh.faces, n_threads=n_threads)

    @property
    def n_faces(self) -> int:
        return self.mesh.faces.shape[0]

    def update_vertices(self, vertices: np.ndarray):
        """Refit the BVH after a deformation step (reference
        train_finetune.py:708-724 rebuilds the intersector)."""
        self.mesh = Mesh(vertices, self.mesh.faces)
        self.bvh.update_vertices(self.mesh.vertices)

    def intersect_rows(self, origins, viewdirs):
        """-> (tri_ids [R,H] int32 -1-pad, ts [R,H] f32, valid [R,H])."""
        tri_ids, ts, counts = self.bvh.intersect(
            origins, viewdirs, max_hits=self.max_hits
        )
        valid = tri_ids >= 0
        return tri_ids, ts, valid

    def intersect_packed(self, origins, viewdirs, cap: int):
        """-> (slots [cap] i32, tri [cap] i32, ts [cap] f32, total):
        valid hits compacted in C++ to the PackedHits stream layout
        (render/quadrature.py) — 12 B per actual hit of host->device
        transport instead of dense [R, max_hits] rows + a
        [R, max_hits, 3, 3] face-vertex gather (which the device now
        performs itself from its resident face-vertex table)."""
        return self.bvh.intersect_packed(
            origins, viewdirs, max_hits=self.max_hits, cap=cap
        )

    def set_atlas_uv(self, uv_per_vertex):
        """Attach atlas UVs so intersect_rows_uv can emit per-hit texel
        coordinates from the cast itself (BVH.set_uv)."""
        uv = np.asarray(uv_per_vertex, np.float32)
        self.bvh.set_uv(uv[self.mesh.faces])

    def intersect_rows_uv(self, origins, viewdirs):
        """-> (tri_ids, ts, valid, uvs [R,H,2]): hits plus their
        barycentric-interpolated atlas UV (requires set_atlas_uv)."""
        tri_ids, ts, counts, uvs = self.bvh.intersect_uv(
            origins, viewdirs, max_hits=self.max_hits
        )
        return tri_ids, ts, tri_ids >= 0, uvs

    def face_vertices_table(self):
        """[F, 3, 3] world vertices per face — uploaded once as the
        device-resident table the renderers gather hit triangles from
        (refreshed on update_vertices by the trainer)."""
        return self.mesh.vertices[self.mesh.faces]


class HitPrefetcher:
    """Overlaps host ray casting with the device step: a worker thread
    draws and casts up to `depth` batches ahead of the one the step
    takes.

    The draws are a function of the step alone, however the thread is
    scheduled: make_batch(n) draws a batch of n rays, batch k is the
    worker's k-th draw, and its size is the k-th request. The first
    `depth` requests are `num_rays`; each next(n) takes the oldest batch
    and requests one more at n (the size the step's caller set last).
    update_vertices moves the mesh between two casts; a batch cast
    before it keeps its rays and is cast again against the new mesh when
    next() takes it. So the ranks of a data-parallel run, each with its
    own prefetcher on the same seed, draw the same global batch at every
    step, mesh updates included.

    `shard` = (world, rank): only the rank's contiguous slice of each
    global batch (multihost.process_local_slice) is cast, and the hits
    index the slice's rays; the batch dict stays whole.

    Two transport modes:
      * dense (packed_cap=None): items are
        (batch, tri_ids [R,H], ts [R,H], valid [R,H]); the trainers
        gather the hit triangles' vertices on the device;
      * packed (packed_cap=int): items are
        (batch, slots [cap], tri [cap], ts [cap], total) — the C++
        BVH compacts valid hits into the PackedHits stream layout, so
        the device upload is 12 B/hit and the face-vertex gather
        happens on device from the resident mesh table.
    """

    def __init__(self, make_batch: Callable[[int], dict],
                 intersector: MeshIntersection, depth: int = 2,
                 packed_cap: Optional[int] = None, num_rays: int = 1024,
                 shard: tuple = (1, 0)):
        self.make_batch = make_batch
        self.intersector = intersector
        self.packed_cap = packed_cap
        self.shard = shard
        self._requests: queue.Queue = queue.Queue()
        self.q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # held by a cast and by a mesh update, so none sees a half-moved
        # mesh; _version counts the updates
        self._mesh_lock = threading.Lock()
        self._version = 0
        for _ in range(depth):
            self._requests.put(num_rays)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _cast(self, batch):
        """The hits of the rank's slice of the batch's rays, and the mesh
        version they were cast against."""
        rays = batch["rays"]
        start, size = process_local_slice(rays.origins.shape[0], *self.shard)
        o = rays.origins[start:start + size]
        d = rays.viewdirs[start:start + size]
        with self._mesh_lock:
            if self.packed_cap is not None:
                hits = self.intersector.intersect_packed(
                    o, d, cap=self.packed_cap)
            else:
                hits = self.intersector.intersect_rows(o, d)
            return hits, self._version

    def _worker(self):
        while not self._stop.is_set():
            try:
                n = self._requests.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                batch = self.make_batch(n)
                self.q.put((batch, *self._cast(batch)))
            except BaseException as e:  # raised again by next()
                self.q.put(e)
                return

    def next(self, num_rays: int):
        """The next batch and its hits, (batch, *hits); requests one more
        batch of `num_rays` rays."""
        self._requests.put(num_rays)
        item = self.q.get()
        if isinstance(item, BaseException):
            raise RuntimeError("the prefetch thread failed") from item
        batch, hits, version = item
        if version != self._version:
            hits, _ = self._cast(batch)
        return (batch, *hits)

    def update_vertices(self, vertices: np.ndarray):
        """The mesh's new vertices and the BVH refit, between two casts;
        the batches already cast are cast again as next() takes them."""
        with self._mesh_lock:
            self.intersector.update_vertices(vertices)
            self._version += 1

    def stop(self):
        self._stop.set()
