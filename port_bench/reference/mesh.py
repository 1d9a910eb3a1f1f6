# Frozen copy of the plain marching cubes of vtaco_tpu_torch/generate/
# marching_cubes.py (_marching_cubes_numpy), kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""Plain marching cubes: vertices on cube edges at the linear-interpolation
crossing of ``level``, one shared vertex per grid edge, sorted by edge key;
faces with degenerate triangles dropped."""

from __future__ import annotations

import numpy as np

from port_bench.reference.mc_tables import (
    CORNER_OFFSETS,
    EDGE_CORNERS,
    TRI_TABLE,
)


def marching_cubes_plain(volume, level):
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
