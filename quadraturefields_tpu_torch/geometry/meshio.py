"""Minimal mesh container + PLY/OBJ IO (trimesh replacement for the
artifact contract: mesh.ply / smp_mesh.ply / mesh_updated.ply and the
stage-6 OBJ-with-UV export; reference marching_cubes.py:81-82,
generate_uv_xatlas_old.py:95-132)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray     # [F, 3] int32

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32)
        self.faces = np.ascontiguousarray(self.faces, np.int32)

    @property
    def face_normals(self):
        a = self.vertices[self.faces[:, 0]]
        b = self.vertices[self.faces[:, 1]]
        c = self.vertices[self.faces[:, 2]]
        n = np.cross(b - a, c - a)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-20)

    @property
    def face_areas(self):
        a = self.vertices[self.faces[:, 0]]
        b = self.vertices[self.faces[:, 1]]
        c = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)

    def remove_unreferenced_vertices(self) -> "Mesh":
        used = np.unique(self.faces.reshape(-1))
        remap = np.full(self.vertices.shape[0], -1, np.int32)
        remap[used] = np.arange(used.shape[0], dtype=np.int32)
        return Mesh(self.vertices[used], remap[self.faces])

    def concat(self, other: "Mesh") -> "Mesh":
        verts = np.concatenate([self.vertices, other.vertices])
        faces = np.concatenate(
            [self.faces, other.faces + self.vertices.shape[0]]
        )
        return Mesh(verts, faces)


def save_ply(path: str, mesh: Mesh) -> None:
    """Binary little-endian PLY."""
    v = np.ascontiguousarray(mesh.vertices, "<f4")
    f = np.ascontiguousarray(mesh.faces, "<i4")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {v.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {f.shape[0]}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    face_rec = np.empty(
        f.shape[0],
        dtype=[("n", "u1"), ("idx", "<i4", (3,))],
    )
    face_rec["n"] = 3
    face_rec["idx"] = f
    with open(path, "wb") as fp:
        fp.write(header.encode())
        fp.write(v.tobytes())
        fp.write(face_rec.tobytes())


def load_ply(path: str) -> Mesh:
    """Reads the binary/ascii PLY subset written by save_ply plus common
    exporters (xyz + optional extra vertex props ignored)."""
    with open(path, "rb") as fp:
        data = fp.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file")
    header = data[:end].decode("ascii", "ignore").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = "binary_little_endian"
    n_vert = n_face = 0
    vert_props = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if parts[1] == "vertex":
                n_vert = int(parts[2])
            elif parts[1] == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and in_vertex and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))

    typemap = {
        "float": "<f4", "float32": "<f4", "double": "<f8",
        "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
    }
    if fmt == "ascii":
        text = body.decode()
        rows = text.split("\n")
        verts = np.array(
            [[float(x) for x in rows[i].split()[:3]] for i in range(n_vert)],
            np.float32,
        )
        faces = np.array(
            [
                [int(x) for x in rows[n_vert + i].split()[1:4]]
                for i in range(n_face)
            ],
            np.int32,
        )
        return Mesh(verts, faces)

    vdtype = np.dtype([(n, typemap[t]) for n, t in vert_props])
    varr = np.frombuffer(body, dtype=vdtype, count=n_vert)
    verts = np.stack(
        [varr["x"], varr["y"], varr["z"]], axis=1
    ).astype(np.float32)
    offset = n_vert * vdtype.itemsize
    fdtype = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    farr = np.frombuffer(body, dtype=fdtype, count=n_face, offset=offset)
    return Mesh(verts, farr["idx"].astype(np.int32))


def save_obj_with_uv(path: str, mesh: Mesh, uv: np.ndarray) -> None:
    """OBJ with per-vertex UV (the stage-6 atlas export contract,
    reference generate_uv_xatlas_old.py:95-132)."""
    lines = []
    for v in mesh.vertices:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for t in uv:
        lines.append(f"vt {t[0]} {t[1]}")
    for f in mesh.faces + 1:
        lines.append(
            f"f {f[0]}/{f[0]} {f[1]}/{f[1]} {f[2]}/{f[2]}"
        )
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def load_obj_with_uv(path: str):
    """Inverse of save_obj_with_uv -> (Mesh, uv [V, 2]). Vertex and UV
    indices coincide in the atlas export (per-chart duplicated
    vertices), so only the v-index of each f triplet is read."""
    verts, uvs, faces = [], [], []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                faces.append(
                    [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                )
    return (
        Mesh(
            np.asarray(verts, np.float32),
            np.asarray(faces, np.int32),
        ),
        np.asarray(uvs, np.float32),
    )
