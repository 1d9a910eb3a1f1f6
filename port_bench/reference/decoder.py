# Frozen copy of vtaco_tpu_torch/models/decoder.py, trimmed to what the benchmark runs and
# kept as its plain reference: it imports nothing of the port and is never
# edited to follow it.
"""The occupancy decoder LocalDecoder (registry key ``simple_local``):
every feature field sampled at the query points (the grid trilinearly,
each plane bilinearly, summed in the order grid, xz, xy, yz), then the
conditioned ResNet-FC stack to one logit; ``forward_img`` fuses a
per-point tactile feature through ``fc_p_img([p, c_img])``. The port's
other decoders are not copied: no cell of the benchmark runs them.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from port_bench.reference.init import Linear
from port_bench.reference.layers import ResnetBlockFC
from port_bench.reference.geometry import normalize_3d_coordinate, normalize_coordinate
from port_bench.reference.interp import interp_grid, interp_plane

PLANES = ("xz", "xy", "yz")


class _Trunk:
    """The conditioned ResNet-FC trunk both decoders share (their
    ``fc_c``, ``blocks``, ``fc_out`` and ``leaky``). A mixin, not a base
    class, so that ``Generator3D._fast_capable``'s isinstance test on
    LocalDecoder does not match PatchLocalDecoder."""

    def _act(self, x):
        return F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)

    def _trunk(self, net, c):
        """(the trunk's last hidden state, its logit); ``c`` is not read
        without ``fc_c`` (c_dim 0)."""
        for i in range(self.n_blocks):
            if self.fc_c is not None:
                net = net + self.fc_c[i](c)
            net = self.blocks[i](net)
        return net, self.fc_out(self._act(net)).squeeze(-1)


def _fc_c(c_dim, hidden_size, n_blocks):
    """The trunk's feature projections, or None for c_dim 0."""
    if c_dim == 0:
        return None
    return nn.ModuleList(Linear(c_dim, hidden_size) for _ in range(n_blocks))


class LocalDecoder(_Trunk, nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5,
                 leaky=False, sample_mode="bilinear", padding=0.1,
                 with_contact=False, **_ignored):
        super().__init__()
        self.c_dim = c_dim
        self.n_blocks = n_blocks
        self.leaky = leaky
        self.sample_mode = sample_mode
        self.padding = padding
        self.fc_c = _fc_c(c_dim, hidden_size, n_blocks)
        self.fc_p = Linear(dim, hidden_size)
        self.fc_p_img = Linear(dim + c_dim, hidden_size)
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden_size)
                                    for _ in range(n_blocks))
        self.fc_out = Linear(hidden_size, 1)
        self.fc_out_contact = Linear(hidden_size, 1) if with_contact else None

    def sample_features(self, p, c_plane):
        """The sum of every field's features sampled at p (B, N, 3) →
        (B, N, C); None with c_dim 0."""
        if self.c_dim == 0:
            return None
        if not isinstance(c_plane, dict):
            raise NotImplementedError(
                "a field decoder on a feature vector (encoder: idx): the JAX "
                "package's LocalDecoder.sample_features finds no field in it and "
                "fails at vtaco_tpu/models/decoder.py:77 (F8 (a), ROADMAP.md §3)")
        c = 0
        if "grid" in c_plane:
            uvw = normalize_3d_coordinate(p, padding=self.padding)
            c = c + interp_grid(c_plane["grid"], uvw, mode=self.sample_mode)
        for key in PLANES:
            if key in c_plane:
                uv = normalize_coordinate(p, padding=self.padding, plane=key)
                c = c + interp_plane(c_plane[key], uv, mode=self.sample_mode)
        return c

    def forward(self, p, c_plane):
        return self._trunk(self.fc_p(p), self.sample_features(p, c_plane))[1]

    def forward_img(self, p, c_plane, c_img):
        net = self.fc_p_img(torch.cat([p, c_img], dim=2))
        return self._trunk(net, self.sample_features(p, c_plane))[1]

    def forward_feats(self, p, c):
        return self._trunk(self.fc_p(p), c)[1]

    def forward_img_feats(self, p, c, c_img):
        return self._trunk(self.fc_p_img(torch.cat([p, c_img], dim=-1)), c)[1]
