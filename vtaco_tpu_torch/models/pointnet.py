"""PointNet encoder with local pooling (port of
vtaco_tpu/models/pointnet.py:61-192, registry key ``pointnet_local_pool``).

Per-point ResNet-FC stack with local max-pool feature exchange over every
feature field, then a scatter-mean of the point features into each field:
a (B, R, R, R, C) grid in (z, y, x) order smoothed by UNet3D, and (B, R, R,
C) planes whose rows index the plane's second coordinate (flat index
x + R*y) smoothed by UNet2D. Fields are channel-last as in the JAX
package, in the reference's order (grid, xz, xy, yz). With ``out_mano``
the encoder returns the hand-parameter head instead: the fields' global
mean, concatenated in that order, through ``fc_mano``.
"""

from __future__ import annotations

import torch
from torch import nn

from vtaco_tpu_torch.models.layers import ResnetBlockFC
from vtaco_tpu_torch.models.unet2d import UNet2D
from vtaco_tpu_torch.models.unet3d import build_unet3d
from vtaco_tpu_torch.ops import scatter
from vtaco_tpu_torch.ops.geometry import (
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
        self.fc_pos = nn.Linear(dim, 2 * hidden_dim)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(2 * hidden_dim, hidden_dim) for _ in range(n_blocks))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
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
        self.fc_mano = nn.Linear(len(self.planes) * c_dim, out_dim) if out_mano else None

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
            c_out = c_out + scatter.gather_cells(pool(c, index[key], self._cells(key)),
                                                 index[key])
        return c_out

    def generate_grid_features(self, index, c):
        """Scatter-mean into (B, R, R, R, C) (z, y, x order), then UNet3D."""
        R = self.grid_resolution
        fea = scatter.scatter_mean(c, index, R ** 3).reshape(
            c.shape[0], R, R, R, self.c_dim)
        if self.unet3d is not None:
            fea = self.unet3d(fea.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return fea

    def generate_plane_features(self, index, c):
        """Scatter-mean into (B, R, R, C) (rows: the second coordinate),
        then UNet2D."""
        R = self.plane_resolution
        fea = scatter.scatter_mean(c, index, R * R).reshape(c.shape[0], R, R, self.c_dim)
        if self.unet is not None:
            fea = self.unet(fea.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return fea

    def forward(self, p):
        index = self._point_indices(p)
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            net = block(torch.cat([net, self.pool_local(index, net)], dim=2))
        c = self.fc_c(net)
        fea = {key: (self.generate_grid_features(index[key], c) if key == "grid"
                     else self.generate_plane_features(index[key], c))
               for key in self.planes}
        if self.fc_mano is None:
            return fea
        pooled = [torch.mean(fea[k], dim=tuple(range(1, fea[k].dim() - 1)))
                  for k in self.planes]
        return {"mano_param": self.fc_mano(torch.cat(pooled, dim=-1))}
