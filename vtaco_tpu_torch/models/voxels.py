"""Voxel-grid encoders (port of vtaco_tpu/models/voxels.py:27-105):
``LocalVoxelEncoder`` (registry key ``voxel_simple_local``) lifts a
(B, D, H, W) occupancy grid to per-voxel features with ``conv_in`` and
scatter-means them into a feature grid (then UNet3D) or into planes (each
then its own UNet2D), like the point encoder's fields; ``VoxelEncoder``
is the global conv encoder to one (B, c_dim) vector.

Layout trap: the JAX package runs NDHWC and flattens voxels, and the conv
features with them, as d·H·W + h·W + w with the voxel centres from
``meshgrid(linspace(-0.5, 0.5, ·), indexing="ij")``. The port's convs are
(B, C, D, H, W), so each feature map is moved channel-last before it is
flattened, and VoxelEncoder's ``fc`` reads its input in (D, H, W, C)
order. The centres from torch.linspace may differ from jnp.linspace's in
the last bit; only the cells they fall in reach the features.

The U-Nets take the names flax gives them (``UNet3D_0``, ``UNet2D_i``
for the i-th plane present, in the order xz, xy, yz).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vtaco_tpu_torch.models.init import Conv3d, Linear
from vtaco_tpu_torch.models.unet2d import UNet2D
from vtaco_tpu_torch.models.unet3d import build_unet3d
from vtaco_tpu_torch.ops import scatter
from vtaco_tpu_torch.ops.geometry import (
    coordinate2index,
    normalize_3d_coordinate,
    normalize_coordinate,
)

PLANES = ("xz", "xy", "yz")


def _channel_last_rows(x):
    """(B, C, D, H, W) → (B, D·H·W, C) in the JAX flattening."""
    return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1, x.shape[1])


class LocalVoxelEncoder(nn.Module):
    def __init__(self, c_dim=128, unet=False, unet_kwargs=None, unet3d=False,
                 unet3d_kwargs=None, plane_resolution=512, grid_resolution=None,
                 plane_type="xz", kernel_size=3, padding=0.1):
        super().__init__()
        planes = [plane_type] if isinstance(plane_type, str) else list(plane_type)
        self.c_dim = c_dim
        self.padding = padding
        self.grid_resolution = grid_resolution
        self.plane_resolution = plane_resolution
        # a grid field, or else the planes: the JAX encoder builds one kind
        self.planes = ("grid",) if "grid" in planes else tuple(
            k for k in PLANES if k in planes)
        self.conv_in = Conv3d(1, c_dim, kernel_size,
                                 padding=0 if kernel_size == 1 else 1)
        self.unets = {}
        if self.planes == ("grid",):
            if unet3d:
                kw = dict(unet3d_kwargs or {})
                kw["in_channels"] = c_dim
                self.add_module("UNet3D_0", build_unet3d(kw))
                self.unets["grid"] = "UNet3D_0"
        elif unet:
            kw = dict(unet_kwargs or {})
            kw.pop("in_channels", None)
            for i, key in enumerate(self.planes):
                self.add_module(f"UNet2D_{i}", UNet2D(c_dim, in_channels=c_dim, **kw))
                self.unets[key] = f"UNet2D_{i}"

    def forward(self, x):
        B, D, H, W = x.shape
        axes = [torch.linspace(-0.5, 0.5, n, device=x.device) for n in (D, H, W)]
        p = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        p = p.reshape(1, D * H * W, 3).expand(B, -1, -1)
        c = _channel_last_rows(F.relu(self.conv_in(x[:, None])))
        fea = {}
        for key in self.planes:
            if key == "grid":
                R = self.grid_resolution
                idx = coordinate2index(normalize_3d_coordinate(p, padding=self.padding),
                                       R, "3d")
                f = scatter.scatter_mean(c, idx, R ** 3).reshape(B, R, R, R, self.c_dim)
                if key in self.unets:
                    unet = getattr(self, self.unets[key])
                    f = unet(f.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
            else:
                R = self.plane_resolution
                idx = coordinate2index(
                    normalize_coordinate(p, padding=self.padding, plane=key), R, "2d")
                f = scatter.scatter_mean(c, idx, R * R).reshape(B, R, R, self.c_dim)
                if key in self.unets:
                    unet = getattr(self, self.unets[key])
                    f = unet(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            fea[key] = f
        return fea


class VoxelEncoder(nn.Module):
    """conv_in, four stride-2 3x3x3 convs (64 to 512 channels), then
    ``fc`` on the flattened features: (B, D, H, W) → (B, c_dim). ``fc``'s
    width follows the grid (4096 for 32³)."""

    def __init__(self, c_dim=128, grid_size=32):
        super().__init__()
        self.conv_in = Conv3d(1, 32, 3, padding=1)
        chans = (32, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv_{i}", Conv3d(chans[i], chans[i + 1], 3, 2, 1))
        side = grid_size
        for _ in range(4):
            side = (side - 1) // 2 + 1
        self.fc = Linear(512 * side ** 3, c_dim)

    def forward(self, x):
        net = self.conv_in(x[:, None])
        for i in range(4):
            net = getattr(self, f"conv_{i}")(F.relu(net))
        hidden = _channel_last_rows(net).reshape(x.shape[0], -1)
        return self.fc(F.relu(hidden))
