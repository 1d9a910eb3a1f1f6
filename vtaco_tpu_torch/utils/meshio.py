"""Triangle mesh IO and procedural meshes (port of
vtaco_tpu/utils/meshio.py:16-235): OFF, OBJ and PLY readers and writers,
icosphere, box. ``read_triangle_mesh`` parses OFF and OBJ in the native
reader (native/geom.cpp) unless asked not to; the Python readers are its
reference.
"""

from __future__ import annotations

import os

import numpy as np


def read_off(path):
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    if tokens[0] == "OFF":
        i = 1
    elif tokens[0].startswith("OFF"):  # header glued to first number
        tokens[0] = tokens[0][3:]
        if not tokens[0]:
            i = 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    verts = np.array(tokens[i : i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        poly = [int(x) for x in tokens[i + 1 : i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):  # fan-triangulate
            faces.append((poly[0], poly[j], poly[j + 1]))
    return verts, np.asarray(faces, np.int32)


def write_off(path, verts, faces):
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write("OFF\n%d %d 0\n" % (len(verts), len(faces)))
        for v in verts:
            f.write("%.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in faces:
            f.write("3 %d %d %d\n" % (face[0], face[1], face[2]))


def write_ply(path, points, text=True):
    """ASCII point-cloud PLY, one ``%.6f %.6f %.6f`` line per point
    (``text`` is the reference's argument; the file is always ASCII)."""
    points = np.asarray(points).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment vertices\n")
        f.write("element vertex %d\n" % len(points))
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        np.savetxt(f, points, fmt="%.6f")


def read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in t[1:]]
                for j in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write("v %.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in np.asarray(faces, np.int64):
            f.write("f %d %d %d\n" % (face[0] + 1, face[1] + 1, face[2] + 1))


def read_triangle_mesh(path, native=True):
    """(verts (V, 3) float32, faces (F, 3) int32) of an OFF, OBJ or ASCII
    PLY file, by extension (igl.read_triangle_mesh's counterpart). OFF and
    OBJ go through the native parser with ``native`` (a failed build
    raises), through the Python readers without."""
    ext = os.path.splitext(path)[1].lower()
    if native and ext in (".off", ".obj"):
        from vtaco_tpu_torch import native as native_ext

        return native_ext.geom.read_triangle_mesh(path)
    if ext == ".off":
        return read_off(path)
    if ext == ".obj":
        return read_obj(path)
    if ext == ".ply":
        return read_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def write_triangle_mesh(path, verts, faces):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".off":
        return write_off(path, verts, faces)
    if ext == ".obj":
        return write_obj(path, verts, faces)
    if ext == ".ply":
        return write_ply_mesh(path, verts, faces)
    raise ValueError(f"unsupported mesh format: {path}")


def write_ply_mesh(path, verts, faces):
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("element vertex %d\n" % len(verts))
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("element face %d\n" % len(faces))
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write("%.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in faces:
            f.write("3 %d %d %d\n" % (face[0], face[1], face[2]))


def read_ply(path):
    """ASCII PLY reader: (verts (V, 3) float32, faces (F, 3) int32, fans
    of its polygons); a binary PLY raises ValueError."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            header.append(line.decode().strip())
            if header[-1] == "end_header":
                break
        if any("binary" in h for h in header):
            raise ValueError("binary PLY not supported")
        nv = nf = 0
        for h in header:
            t = h.split()
            if t[:2] == ["element", "vertex"]:
                nv = int(t[2])
            elif t[:2] == ["element", "face"]:
                nf = int(t[2])
        verts = [[float(x) for x in f.readline().split()[:3]] for _ in range(nv)]
        faces = []
        for _ in range(nf):
            t = [int(x) for x in f.readline().split()]
            for j in range(2, t[0]):
                faces.append((t[1], t[j], t[j + 1]))
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


# --- simple procedural meshes (used by the synthetic dataset + tests) -----


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Unit icosahedron subdivided n times, projected to the sphere."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f3 in faces:
            a, b, c = int(f3[0]), int(f3[1]), int(f3[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def box(extents=(1.0, 1.0, 1.0)):
    ex, ey, ez = [e / 2 for e in extents]
    verts = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (z-)
            [4, 5, 6], [4, 6, 7],  # top (z+)
            [0, 1, 5], [0, 5, 4],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [1, 2, 6], [1, 6, 5],  # x+
            [3, 0, 4], [3, 4, 7],  # x-
        ],
        np.int32,
    )
    return verts, faces
