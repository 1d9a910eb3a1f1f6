"""Occupancy decoders (port of vtaco_tpu/models/decoder.py: LocalDecoder
:33-112, registry key ``simple_local``; AttentionDecoder :115-181,
``attention_local``; PatchLocalDecoder :183-232, ``simple_local_crop``;
LocalPointDecoder :235-285, ``simple_local_point``).

LocalDecoder samples every feature field at the query points (the grid
trilinearly, each plane bilinearly, summed in the order grid, xz, xy,
yz) and runs the conditioned ResNet-FC stack to one logit.
``forward_img`` fuses a per-point tactile feature through
``fc_p_img([p, c_img])``; with ``with_contact`` a second head
``fc_out_contact`` on the same trunk gives contact logits
(``forward_contact``). The ``forward_*_feats`` heads take
pre-interpolated features; they are what the channels-first trunk
(ops/fast_trunk.py) is held against.

PatchLocalDecoder decodes crop queries: {"p": (B, N, 3), "p_n": {field:
the points' coords in the crop's input volume}}, sampled with no further
normalization; with ``local_coord`` the trunk sees each point's position
within its voxel of ``unit_size``.

AttentionDecoder samples the fields as LocalDecoder does; its
``forward_img`` feeds the plain ``fc_p(p)`` to the trunk and fuses the
tactile rows into the sampled features through TransformerFusion
(``c = fuser(c_img, None, c, None)``, models/fusion.py), always with
dropout off and no positional embedding, as the JAX package calls it. The
fusion normalizes over the whole chunk of query points, so its output
depends on the chunk.

LocalPointDecoder conditions on the encoder's per-point features of the
input cloud (``c = (points, features)``, PointNet++'s output) instead of
fields: each query takes the features weighted by a Gaussian
(``sample_mode`` 'gaussian') or inverse-distance kernel over every input
point, normalized over them, with the reference's ``10e-6`` added to the
distances. It has no tactile and no contact head (F8 (b), ROADMAP.md §3).

Only LocalDecoder reaches the fast routes and K1-K4: the trunk mixin
keeps the others out of its class tree.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vtaco_tpu_torch.models.fusion import TransformerFusion
from vtaco_tpu_torch.models.layers import ResnetBlockFC
from vtaco_tpu_torch.ops.geometry import normalize_3d_coordinate, normalize_coordinate
from vtaco_tpu_torch.ops.interp import interp_grid, interp_plane
from vtaco_tpu_torch.ops.local_coords import map2local

PLANES = ("xz", "xy", "yz")


class _Trunk:
    """The conditioned ResNet-FC trunk both decoders share (their
    ``fc_c``, ``blocks``, ``fc_out`` and ``leaky``). A mixin, not a base
    class, so that ``Generator3D._fast_capable``'s isinstance test on
    LocalDecoder does not match PatchLocalDecoder."""

    def _act(self, x):
        return F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)

    def _trunk(self, net, c):
        """(the trunk's last hidden state, its logit)."""
        for i in range(self.n_blocks):
            net = self.blocks[i](net + self.fc_c[i](c))
        return net, self.fc_out(self._act(net)).squeeze(-1)


class LocalDecoder(_Trunk, nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5,
                 leaky=False, sample_mode="bilinear", padding=0.1,
                 with_contact=False, **_ignored):
        super().__init__()
        if c_dim == 0:
            raise NotImplementedError("LocalDecoder with c_dim 0 is not ported "
                                      "(ROADMAP.md, item 11)")
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
        self.fc_out_contact = nn.Linear(hidden_size, 1) if with_contact else None

    def sample_features(self, p, c_plane):
        """The sum of every field's features sampled at p (B, N, 3) →
        (B, N, C)."""
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

    def forward_contact(self, p, c_plane):
        """(occupancy logits, contact logits) from one trunk."""
        net, out = self._trunk(self.fc_p(p), self.sample_features(p, c_plane))
        return out, self.fc_out_contact(self._act(net)).squeeze(-1)


class PatchLocalDecoder(_Trunk, nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5, leaky=False,
                 sample_mode="bilinear", local_coord=False, pos_encoding="linear",
                 unit_size=0.1, padding=0.1, **_ignored):
        super().__init__()
        if c_dim == 0:
            raise NotImplementedError("PatchLocalDecoder with c_dim 0 is not ported "
                                      "(ROADMAP.md, item 11)")
        self.n_blocks = n_blocks
        self.leaky = leaky
        self.sample_mode = sample_mode
        self.local_coord = local_coord
        self.pos_encoding = pos_encoding
        self.unit_size = unit_size
        self.fc_c = nn.ModuleList(nn.Linear(c_dim, hidden_size) for _ in range(n_blocks))
        width = dim * 20 if local_coord and pos_encoding == "sin_cos" else dim
        self.fc_p = nn.Linear(width, hidden_size)
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden_size) for _ in range(n_blocks))
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p, c_plane):
        p_n, pts = p["p_n"], p["p"]
        c = 0
        if "grid" in c_plane:
            c = c + interp_grid(c_plane["grid"], p_n["grid"], mode=self.sample_mode)
        for key in PLANES:
            if key in c_plane:
                c = c + interp_plane(c_plane[key], p_n[key], mode=self.sample_mode)
        if self.local_coord:
            pts = map2local(pts, self.unit_size, self.pos_encoding)
        return self._trunk(self.fc_p(pts), c)[1]


class AttentionDecoder(_Trunk, nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5, leaky=False,
                 sample_mode="bilinear", padding=0.1, with_contact=False):
        super().__init__()
        if c_dim == 0:
            raise NotImplementedError("AttentionDecoder with c_dim 0 is not ported "
                                      "(ROADMAP.md, item 11)")
        self.n_blocks = n_blocks
        self.leaky = leaky
        self.sample_mode = sample_mode
        self.padding = padding
        self.fc_c = nn.ModuleList(nn.Linear(c_dim, hidden_size)
                                  for _ in range(n_blocks))
        self.fc_p = nn.Linear(dim, hidden_size)
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden_size)
                                    for _ in range(n_blocks))
        self.fc_out = nn.Linear(hidden_size, 1)
        self.fc_out_contact = nn.Linear(hidden_size, 1) if with_contact else None
        self.fuser = TransformerFusion(d_model=c_dim, num_layers=1, key_feature_dim=64,
                                       with_pos_embed=False)

    sample_features = LocalDecoder.sample_features
    forward = LocalDecoder.forward
    forward_contact = LocalDecoder.forward_contact

    def forward_img(self, p, c_plane, c_img):
        c = self.fuser(c_img, None, self.sample_features(p, c_plane), None)
        return self._trunk(self.fc_p(p), c)[1]


class LocalPointDecoder(_Trunk, nn.Module):
    def __init__(self, dim=3, c_dim=128, hidden_size=256, n_blocks=5, leaky=False,
                 sample_mode="gaussian", gaussian_val=0.1):
        super().__init__()
        if c_dim == 0:
            raise NotImplementedError("LocalPointDecoder with c_dim 0 is not ported "
                                      "(ROADMAP.md, item 11)")
        self.n_blocks = n_blocks
        self.leaky = leaky
        self.sample_mode = sample_mode
        self.gaussian_val = gaussian_val
        self.fc_c = nn.ModuleList(nn.Linear(c_dim, hidden_size) for _ in range(n_blocks))
        self.fc_p = nn.Linear(dim, hidden_size)
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden_size) for _ in range(n_blocks))
        self.fc_out = nn.Linear(hidden_size, 1)

    def sample_point_feature(self, q, p, fea):
        """Kernel-weighted features (B, M, C) of the input points p (B, M, 3)
        at the queries q (B, N, 3) → (B, N, C). The distances are the norms
        of the (B, N, M, 3) differences, as in the JAX package (cdist's
        direct form gives the same values far slower on the card; PERF.md
        §6)."""
        dist = torch.linalg.norm(p[:, None, :, :] - q[:, :, None, :], dim=3) + 10e-6
        if self.sample_mode == "gaussian":
            weight = torch.exp(-(dist ** 2) / (self.gaussian_val ** 2))
        else:
            weight = 1.0 / dist
        weight = weight / torch.sum(weight, dim=2, keepdim=True)
        return weight @ fea

    def forward(self, p, c):
        pp, fea = c
        return self._trunk(self.fc_p(p), self.sample_point_feature(p, pp, fea))[1]

    def forward_img(self, *args):
        raise NotImplementedError(
            "simple_local_point with model.with_img: the JAX package's "
            "LocalPointDecoder has no forward_img and fails at "
            "vtaco_tpu/models/conv_onet.py:106 (F8 (b), ROADMAP.md §3)")

    def forward_contact(self, *args):
        raise NotImplementedError(
            "simple_local_point with model.with_contact: the JAX package's "
            "LocalPointDecoder has no forward_contact and fails at "
            "vtaco_tpu/models/conv_onet.py:111 (F8 (b), ROADMAP.md §3)")
