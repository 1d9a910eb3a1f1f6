"""Marching cubes (port of vtaco_tpu/generate/marching_cubes.py:27-115).

``marching_cubes`` runs the native extractor (native/mc.cpp), as the JAX
package does by default: one thread below 128³ points, x-slabs on
min(cpu_count, 8) threads from 128³ up, its vertices in the scan's order.
That order decides which vertices the generator's 2048-vertex metric
sample draws, so the port's chamfer and EMD equal the JAX package's on
the same grid. A failed build raises. ``_marching_cubes_numpy`` is the
plain reference the tests hold the extractor against: the same mesh, its
vertices sorted by edge key.

Vertices lie on cube edges at the linear-interpolation crossing; each
global edge produces one shared vertex, so closed isosurfaces give
watertight meshes. ``gradient='ascent'`` flips the triangles to the
reference's winding (occupancy increases inward).
"""

from __future__ import annotations

import numpy as np

from vtaco_tpu_torch import native
from vtaco_tpu_torch.generate.mc_tables import (
    CORNER_OFFSETS,
    EDGE_CORNERS,
    TRI_TABLE,
)
from vtaco_tpu_torch.utils import profiling


def marching_cubes(volume, level=None, gradient="ascent"):
    """Extract the `level` isosurface of a (nx, ny, nz) scalar field.

    ``level`` defaults to (min+max)/2. Returns verts (V, 3) float32 in
    voxel coordinates and faces (F, 3) int32. Spans: ``mc.level`` (the
    contiguous float32 volume and its level), ``mc.native``."""
    with profiling.span("mc.level"):
        volume = np.ascontiguousarray(volume, np.float32)
        if level is None:
            level = (float(volume.min()) + float(volume.max())) / 2.0
    with profiling.span("mc.native"):
        verts, faces = native.mc.marching_cubes(volume, level)
    if gradient == "ascent":
        faces = faces[:, ::-1]
    return verts, faces


def _marching_cubes_numpy(volume, level):
    nx, ny, nz = volume.shape
    occ = volume > level

    # cube index per cell from its 8 corners
    cube_idx = np.zeros((nx - 1, ny - 1, nz - 1), np.int32)
    for ci, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        cube_idx |= occ[ox: nx - 1 + ox, oy: ny - 1 + oy, oz: nz - 1 + oz] << ci

    active = np.nonzero((cube_idx != 0) & (cube_idx != 255))
    if active[0].size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cidx = cube_idx[active]              # (A,)
    cell = np.stack(active, axis=1)      # (A, 3) cell origin

    # a grid edge is (origin voxel, axis): cube edge k of cell (x, y, z)
    # starts at cell + the offset of its lower corner
    corner_a = EDGE_CORNERS[:, 0]
    corner_b = EDGE_CORNERS[:, 1]
    off_a = CORNER_OFFSETS[corner_a]         # (12, 3)
    off_b = CORNER_OFFSETS[corner_b]
    axis = np.argmax(np.abs(off_b - off_a), axis=1)          # (12,)
    origin_off = np.minimum(off_a, off_b)                    # (12, 3)

    tris = TRI_TABLE[cidx]                                    # (A, 16)
    ntri = np.sum(tris >= 0, axis=1) // 3
    tri_edges = tris[:, :15].reshape(-1, 5, 3)                # (A, 5, 3)
    keep = np.arange(5)[None, :] < ntri[:, None]              # (A, 5)
    flat_cells = np.repeat(cell, ntri * 3, axis=0)            # (T*3, 3)
    flat_edges = tri_edges[keep].reshape(-1)                  # (T*3,)

    edge_origin = flat_cells + origin_off[flat_edges]
    edge_axis = axis[flat_edges]
    key = ((edge_origin[:, 0].astype(np.int64) * ny + edge_origin[:, 1]) * nz
           + edge_origin[:, 2]) * 3 + edge_axis

    uniq, inverse = np.unique(key, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)

    # one interpolated vertex per unique edge
    uaxis = (uniq % 3).astype(np.int32)
    ucell = uniq // 3
    uz = (ucell % nz).astype(np.int32)
    uy = ((ucell // nz) % ny).astype(np.int32)
    ux = (ucell // (nz * ny)).astype(np.int32)
    p0 = np.stack([ux, uy, uz], axis=1)
    step = np.eye(3, dtype=np.int32)[uaxis]
    p1 = p0 + step
    v0 = volume[p0[:, 0], p0[:, 1], p0[:, 2]]
    v1 = volume[p1[:, 0], p1[:, 1], p1[:, 2]]
    denom = v1 - v0
    t = np.where(np.abs(denom) > 1e-12,
                 (level - v0) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)
    verts = p0.astype(np.float32) + t[:, None] * step.astype(np.float32)

    # drop degenerate triangles (repeated vertex ids)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]
