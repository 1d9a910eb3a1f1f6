"""PointNet encoder with local pooling, grid path (port of
vtaco_tpu/models/pointnet.py:61-192, registry key ``pointnet_local_pool``).

Per-point ResNet-FC stack with local max-pool feature exchange, then a
scatter-mean into a (B, R, R, R, C) feature grid in (z, y, x) order,
smoothed by UNet3D. The grid is returned channel-last as in the JAX
package. The tri-plane path and the MANO head belong to the hand encoder
and are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from vtaco_tpu_torch.models.layers import ResnetBlockFC
from vtaco_tpu_torch.models.unet3d import build_unet3d
from vtaco_tpu_torch.ops import scatter
from vtaco_tpu_torch.ops.geometry import coordinate2index, normalize_3d_coordinate


class LocalPoolPointnet(nn.Module):
    def __init__(self, c_dim=128, dim=3, hidden_dim=128, scatter_type="max",
                 unet3d=False, unet3d_kwargs=None, grid_resolution=None,
                 plane_type="grid", padding=0.1, n_blocks=5, out_mano=False,
                 unet=False, **_ignored):
        super().__init__()
        planes = [plane_type] if isinstance(plane_type, str) else list(plane_type)
        if planes != ["grid"] or unet or out_mano:
            raise NotImplementedError(
                "LocalPoolPointnet: only the grid feature field is ported; "
                "planes, the 2D U-Net and the MANO head come with the hand "
                "encoder (ROADMAP.md)")
        self.c_dim = c_dim
        self.grid_resolution = grid_resolution
        self.padding = padding
        self.scatter_type = scatter_type
        self.fc_pos = nn.Linear(dim, 2 * hidden_dim)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(2 * hidden_dim, hidden_dim) for _ in range(n_blocks))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        self.unet3d = None
        if unet3d:
            kw = dict(unet3d_kwargs or {})
            kw["in_channels"] = c_dim
            self.unet3d = build_unet3d(kw)

    def _index(self, p):
        nor = normalize_3d_coordinate(p, padding=self.padding)
        return coordinate2index(nor, self.grid_resolution, "3d")

    def pool_local(self, index, c):
        """Pool point features into their cells and gather them back."""
        pool = (scatter.scatter_max if self.scatter_type == "max"
                else scatter.scatter_mean)
        fea = pool(c, index, self.grid_resolution ** 3)
        return scatter.gather_cells(fea, index)

    def generate_grid_features(self, index, c):
        """Scatter-mean into (B, R, R, R, C) (z, y, x order), then UNet3D."""
        R = self.grid_resolution
        fea = scatter.scatter_mean(c, index, R ** 3).reshape(
            c.shape[0], R, R, R, self.c_dim)
        if self.unet3d is not None:
            fea = self.unet3d(fea.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return fea

    def forward(self, p):
        index = self._index(p)
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            net = block(torch.cat([net, self.pool_local(index, net)], dim=2))
        c = self.fc_c(net)
        return {"grid": self.generate_grid_features(index, c)}
