"""Occupancy decoder (port of LocalDecoder, vtaco_tpu/models/decoder.py:
33-112, registry key ``simple_local``).

Interpolates local grid features at the query points and runs the
conditioned ResNet-FC stack to one logit. ``forward_img`` fuses a
per-point tactile feature through ``fc_p_img([p, c_img])``. The
``forward_*_feats`` heads take pre-interpolated features; they are what
the channels-first trunk (ops/fast_trunk.py) is held against.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vtaco_tpu_torch.models.layers import ResnetBlockFC
from vtaco_tpu_torch.ops.geometry import normalize_3d_coordinate
from vtaco_tpu_torch.ops.interp import interp_grid


class LocalDecoder(nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5,
                 leaky=False, sample_mode="bilinear", padding=0.1, **_ignored):
        super().__init__()
        if c_dim == 0:
            raise NotImplementedError("LocalDecoder with c_dim 0 is not ported")
        self.c_dim = c_dim
        self.n_blocks = n_blocks
        self.leaky = leaky
        self.sample_mode = sample_mode
        self.padding = padding
        self.fc_c = nn.ModuleList(nn.Linear(c_dim, hidden_size)
                                  for _ in range(n_blocks))
        self.fc_p = nn.Linear(dim, hidden_size)
        self.fc_p_img = nn.Linear(dim + c_dim, hidden_size)
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden_size)
                                    for _ in range(n_blocks))
        self.fc_out = nn.Linear(hidden_size, 1)

    def _act(self, x):
        return F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)

    def sample_features(self, p, c_plane):
        """Grid features sampled at p (B, N, 3) → (B, N, C)."""
        if set(c_plane) != {"grid"}:
            raise NotImplementedError("LocalDecoder: only the grid field is ported")
        uvw = normalize_3d_coordinate(p, padding=self.padding)
        return interp_grid(c_plane["grid"], uvw, mode=self.sample_mode)

    def _trunk(self, net, c):
        for i in range(self.n_blocks):
            net = self.blocks[i](net + self.fc_c[i](c))
        return self.fc_out(self._act(net)).squeeze(-1)

    def forward(self, p, c_plane):
        return self._trunk(self.fc_p(p), self.sample_features(p, c_plane))

    def forward_img(self, p, c_plane, c_img):
        net = self.fc_p_img(torch.cat([p, c_img], dim=2))
        return self._trunk(net, self.sample_features(p, c_plane))

    def forward_feats(self, p, c):
        return self._trunk(self.fc_p(p), c)

    def forward_img_feats(self, p, c, c_img):
        return self._trunk(self.fc_p_img(torch.cat([p, c_img], dim=-1)), c)
