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

    def face_vertices(self, tri_ids):
        """[.., 3, 3] world vertices of the given triangles (clamped for
        -1 padding)."""
        tri = np.maximum(tri_ids, 0)
        return self.mesh.vertices[self.mesh.faces[tri]]

    def face_vertices_table(self):
        """[F, 3, 3] world vertices per face — uploaded once as the
        device-resident table the packed-stream renderers gather from
        (refreshed on update_vertices by the trainer)."""
        return self.mesh.vertices[self.mesh.faces]


class HitPrefetcher:
    """Overlaps host ray casting with the device step: a worker thread
    keeps `depth` batches of (batch_dict, hits) ready.

    Two transport modes:
      * dense (packed_cap=None): items are
        (batch, tri_ids [R,H], ts [R,H], valid [R,H], fv [R,H,3,3]) —
        the original layout, kept for the dense parity path and eval;
      * packed (packed_cap=int): items are
        (batch, slots [cap], tri [cap], ts [cap], total) — the C++
        BVH compacts valid hits into the PackedHits stream layout, so
        the device upload is 12 B/hit and the face-vertex gather
        happens on device from the resident mesh table.
    """

    def __init__(self, make_batch: Callable[[], dict],
                 intersector: MeshIntersection, depth: int = 2,
                 packed_cap: Optional[int] = None):
        self.make_batch = make_batch
        self.intersector = intersector
        self.packed_cap = packed_cap
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pause = threading.Lock()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.make_batch()
            rays = batch["rays"]
            with self._pause:
                if self.packed_cap is not None:
                    slots, tri, ts, total = (
                        self.intersector.intersect_packed(
                            rays.origins, rays.viewdirs,
                            cap=self.packed_cap,
                        )
                    )
                    item = (batch, slots, tri, ts, total)
                else:
                    tri_ids, ts, valid = self.intersector.intersect_rows(
                        rays.origins, rays.viewdirs
                    )
                    fv = self.intersector.face_vertices(tri_ids)
                    item = (batch, tri_ids, ts, valid, fv)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self.q.get()

    def drain_and_pause(self):
        """Flush queued batches (e.g. after a mesh vertex update so no
        stale hits are consumed)."""
        with self._pause:
            while not self.q.empty():
                try:
                    self.q.get_nowait()
                except queue.Empty:
                    break

    def stop(self):
        self._stop.set()
        while not self.q.empty():
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
