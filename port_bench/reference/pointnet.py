# Frozen copy of vtaco_tpu_torch/models/pointnet.py, trimmed to what the benchmark runs and
# kept as its plain reference: it imports nothing of the port and is never
# edited to follow it.
"""PointNet encoders with local pooling (port of
vtaco_tpu/models/pointnet.py:38-284): ``LocalPoolPointnet`` (registry key
``pointnet_local_pool``), its crop form ``PatchLocalPoolPointnet``
(``pointnet_crop_local_pool``), and ``IndexEncoder`` (``encoder: idx``: a
learned latent per dataset sample, whose one weight loads as the
reference's bare nn.Embedding, ``encoder.weight``).

Per-point ResNet-FC stack with local max-pool feature exchange over every
feature field, then a scatter-mean of the point features into each field:
a (B, R, R, R, C) grid in (z, y, x) order smoothed by UNet3D, and (B, R, R,
C) planes whose rows index the plane's second coordinate (flat index
x + R*y) smoothed by UNet2D. Fields are channel-last as in the JAX
package, in the reference's order (grid, xz, xy, yz). With ``out_mano``
the encoder returns the hand-parameter head instead: the fields' global
mean, concatenated in that order, through ``fc_mano``.

The crop form takes its cell indices precomputed by the crop data field
(the crop volume's, not the unit box's): a dict {"points": (B, N, 3),
"index": {field: (B, N)}}, where points outside the crop volume carry
the overflow cell reso^k. Every pool runs over reso^k + 1 cells and the
fields drop the overflow cell before the U-Net. With ``local_coord`` the
first layer sees each point's position within its voxel of
``unit_size`` (ops/local_coords.py).
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.init import Linear
from port_bench.reference.layers import ResnetBlockFC
from port_bench.reference.unet2d import UNet2D
from port_bench.reference.unet3d import build_unet3d
from port_bench.reference import scatter
from port_bench.reference.geometry import (
    coordinate2index,
    normalize_3d_coordinate,
    normalize_coordinate,
)

PLANE_ORDER = ("grid", "xz", "xy", "yz")


class LocalPoolPointnet(nn.Module):
    def __init__(self, c_dim=128, dim=3, hidden_dim=128, scatter_type="max",
                 unet=False, unet_kwargs=None, unet3d=False, unet3d_kwargs=None,
                 plane_resolution=None, grid_resolution=None, plane_type="xz",
                 padding=0.1, n_blocks=5, out_mano=False, out_dim=None, **_ignored):
        super().__init__()
        planes = [plane_type] if isinstance(plane_type, str) else list(plane_type)
        self.planes = tuple(p for p in PLANE_ORDER if p in planes)
        self.c_dim = c_dim
        self.grid_resolution = grid_resolution
        self.plane_resolution = plane_resolution
        self.padding = padding
        self.scatter_type = scatter_type
        self.fc_pos = Linear(dim, 2 * hidden_dim)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(2 * hidden_dim, hidden_dim) for _ in range(n_blocks))
        self.fc_c = Linear(hidden_dim, c_dim)
        self.unet = None
        if unet:
            kw = dict(unet_kwargs or {})
            kw.pop("in_channels", None)
            if "start_flits" in kw:   # the reference configs' typo
                kw["start_filts"] = kw.pop("start_flits")
            self.unet = UNet2D(c_dim, in_channels=c_dim, **kw)
        self.unet3d = None
        if unet3d:
            kw = dict(unet3d_kwargs or {})
            kw["in_channels"] = c_dim
            self.unet3d = build_unet3d(kw)
        self.fc_mano = Linear(len(self.planes) * c_dim, out_dim) if out_mano else None

    # extra pooled cells past the field's own: the crop form's overflow cell
    overflow = 0

    def _cells(self, key):
        return self.grid_resolution ** 3 if key == "grid" else self.plane_resolution ** 2

    def _point_indices(self, p):
        """Cell index of every input point in each field."""
        index = {}
        for key in self.planes:
            if key == "grid":
                nor = normalize_3d_coordinate(p, padding=self.padding)
                index[key] = coordinate2index(nor, self.grid_resolution, "3d")
            else:
                nor = normalize_coordinate(p, padding=self.padding, plane=key)
                index[key] = coordinate2index(nor, self.plane_resolution, "2d")
        return index

    def pool_local(self, index, c):
        """Pool point features into their cells of each field and sum the
        pooled features gathered back to the points."""
        pool = (scatter.scatter_max if self.scatter_type == "max"
                else scatter.scatter_mean)
        c_out = 0
        for key in self.planes:
            cells = pool(c, index[key], self._cells(key) + self.overflow)
            c_out = c_out + scatter.gather_cells(cells, index[key])
        return c_out

    def _field(self, key, c, index):
        """Point features c scatter-meaned into field ``key`` (its overflow
        cell dropped): (B, R, R, R, C) in (z, y, x) order smoothed by
        UNet3D, or a (B, R, R, C) plane (rows: the second coordinate)
        smoothed by UNet2D."""
        n = self._cells(key)
        cells = scatter.scatter_mean(c, index, n + self.overflow)[:, :n]
        B = cells.shape[0]
        if key == "grid":
            R = self.grid_resolution
            fea = cells.reshape(B, R, R, R, self.c_dim)
            if self.unet3d is not None:
                fea = self.unet3d(fea.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
            return fea
        R = self.plane_resolution
        fea = cells.reshape(B, R, R, self.c_dim)
        if self.unet is not None:
            fea = self.unet(fea.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return fea

    def _point_features(self, x, index):
        """(B, N, c_dim) point features from the first layer's input x (B,
        N, dim) and the points' cell indices."""
        net = self.blocks[0](self.fc_pos(x))
        for block in self.blocks[1:]:
            net = block(torch.cat([net, self.pool_local(index, net)], dim=2))
        return self.fc_c(net)

    def _fields(self, x, index):
        """The feature fields from the first layer's input x (B, N, dim) and
        the points' cell indices."""
        c = self._point_features(x, index)
        return {key: self._field(key, c, index[key]) for key in self.planes}

    def generate_plane_features(self, p, c, plane):
        """Point features c (B, N, C) scatter-meaned by the points p into
        the (B, R, R, C) ``plane`` (rows: its second coordinate), smoothed
        by UNet2D."""
        nor = normalize_coordinate(p, padding=self.padding, plane=plane)
        return self._field(plane, c, coordinate2index(nor, self.plane_resolution, "2d"))

    def generate_grid_features(self, p, c):
        """Point features c (B, N, C) scatter-meaned by the points p into
        the (B, R, R, R, C) grid in (z, y, x) order, smoothed by UNet3D."""
        nor = normalize_3d_coordinate(p, padding=self.padding)
        return self._field("grid", c, coordinate2index(nor, self.grid_resolution, "3d"))

    def forward(self, p):
        if p.dim() != 3:
            raise NotImplementedError(
                f"a point encoder on a {p.dim()}-d input (data.input_type: voxels "
                "with a hand encoder or a tactile-to-depth model): the JAX "
                "package's LocalPoolPointnet fails there, at "
                "vtaco_tpu/ops/scatter.py:54 from vtaco_tpu/models/pointnet.py:169 "
                "(F8 (c), ROADMAP.md §3)")
        fea = self._fields(p, self._point_indices(p))
        if self.fc_mano is None:
            return fea
        pooled = [torch.mean(fea[k], dim=tuple(range(1, fea[k].dim() - 1)))
                  for k in self.planes]
        return {"mano_param": self.fc_mano(torch.cat(pooled, dim=-1))}


