"""Voxel grid utilities (port of vtaco_tpu/utils/voxels.py; the
reference's src/utils/voxels.py): a VoxelGrid with mesh voxelization (a
winding-number interior test, here the native host winding numbers, in
place of the reference's trimesh ray and fill methods), cube-mesh export,
point containment, and the corner occupancy predicates the MISE extractor
uses.
"""

from __future__ import annotations

import numpy as np


class VoxelGrid:
    def __init__(self, data, loc=(0.0, 0.0, 0.0), scale=1.0):
        if not data.shape[0] == data.shape[1] == data.shape[2]:
            raise ValueError(f"VoxelGrid needs a cubic grid; got {data.shape}")
        self.data = np.asarray(data, bool)
        self.loc = np.asarray(loc)
        self.scale = scale

    @classmethod
    def from_mesh(cls, verts, faces, resolution, loc=None, scale=None):
        """Voxelize a triangle mesh by winding number at voxel centers
        (robust interior test; src/utils/voxels.py:17-42 used trimesh rays).
        """
        from vtaco_tpu_torch.ops.winding import winding_number_host

        verts = np.asarray(verts, np.float32)
        if loc is None or scale is None:
            bb_min = verts.min(0)
            bb_max = verts.max(0)
            if loc is None:
                loc = (bb_min + bb_max) / 2
            if scale is None:
                scale = float((bb_max - bb_min).max() / 0.9)
        loc = np.asarray(loc)

        r = resolution
        centers = (np.stack(np.meshgrid(
            *[np.arange(r)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5) / r
        centers = (centers - 0.5) * scale + loc
        w = winding_number_host(verts, np.asarray(faces, np.int32),
                                centers.astype(np.float32))
        occ = (w > 0.5).reshape(r, r, r)
        return cls(occ, loc, scale)

    @property
    def resolution(self):
        return self.data.shape[0]

    def down_sample(self, factor=2):
        if self.resolution % factor != 0:
            raise ValueError("Resolution must be divisible by factor.")
        r = self.resolution // factor
        d = self.data.reshape(r, factor, r, factor, r, factor)
        data = d.any((1, 3, 5))
        return VoxelGrid(data, self.loc, self.scale)

    def contains(self, points):
        """Boolean occupancy lookup for world-space points.
        src/utils/voxels.py:175-199."""
        points = (np.asarray(points) - self.loc) / self.scale + 0.5
        r = self.resolution
        idx = np.floor(points * r).astype(np.int64)
        inside = ((idx >= 0) & (idx < r)).all(-1)
        idx = np.clip(idx, 0, r - 1)
        occ = self.data[idx[..., 0], idx[..., 1], idx[..., 2]]
        return occ & inside

    def to_mesh(self):
        """Boundary-face cube mesh of the occupied voxels
        (src/utils/voxels.py:50-169)."""
        occ = np.pad(self.data, 1, mode="constant")
        verts_map = {}
        verts = []
        faces = []

        def vid(p):
            if p not in verts_map:
                verts_map[p] = len(verts)
                verts.append(p)
            return verts_map[p]

        r = self.resolution
        occ_core = occ[1:-1, 1:-1, 1:-1]
        nz = np.argwhere(occ_core)
        neighbor_offsets = [
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)
        ]
        face_corners = {
            (1, 0, 0): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
            (-1, 0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
            (0, 1, 0): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
            (0, -1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
            (0, 0, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
            (0, 0, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
        }
        for x, y, z in nz:
            for off in neighbor_offsets:
                if not occ[1 + x + off[0], 1 + y + off[1], 1 + z + off[2]]:
                    ids = [
                        vid((x + c[0], y + c[1], z + c[2]))
                        for c in face_corners[off]
                    ]
                    faces.append((ids[0], ids[1], ids[2]))
                    faces.append((ids[0], ids[2], ids[3]))
        verts = np.asarray(verts, np.float32)
        verts = (verts / r - 0.5) * self.scale + self.loc
        return verts, np.asarray(faces, np.int64)


def check_voxel_occupied(occupancy_grid):
    """All 8 corners occupied. src/utils/voxels.py:222-236."""
    o = np.asarray(occupancy_grid, bool)
    return (
        o[..., :-1, :-1, :-1] & o[..., :-1, :-1, 1:]
        & o[..., :-1, 1:, :-1] & o[..., :-1, 1:, 1:]
        & o[..., 1:, :-1, :-1] & o[..., 1:, :-1, 1:]
        & o[..., 1:, 1:, :-1] & o[..., 1:, 1:, 1:]
    )


def check_voxel_unoccupied(occupancy_grid):
    """All 8 corners empty. src/utils/voxels.py:238-252."""
    return check_voxel_occupied(~np.asarray(occupancy_grid, bool))


def check_voxel_boundary(occupancy_grid):
    """Mixed corners (surface voxel). src/utils/voxels.py:254-270."""
    occupied = check_voxel_occupied(occupancy_grid)
    unoccupied = check_voxel_occupied(~np.asarray(occupancy_grid, bool))
    return ~occupied & ~unoccupied
