"""PointNet++ encoder (port of vtaco_tpu/models/pointnetpp.py:25-165,
registry key ``pointnet_plus_plus``): three set-abstraction levels and
three feature-propagation levels, returning ``(xyz, per-point c_dim
features)`` for the point decoder (models/decoder.py LocalPointDecoder).

The JAX package's choices are kept, and so are its tie rules:
  * Farthest-point sampling starts from point 0 and takes, at each of
    its ``npoint`` serial steps, the first index of the largest
    remaining distance (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does).
  * The ball query marks every point beyond the radius with the sentinel
    N, sorts the ids, keeps the first ``nsample`` and pads with the first
    in-ball id.
  * The feature propagation interpolates from the 3 nearest points by
    inverse squared distance. ``lax.top_k`` puts the lower index first
    among equal distances; ``torch.topk`` leaves that order unspecified,
    so the neighbours come from a stable ascending sort instead.
  * The pointwise MLPs are Linear layers with BatchNorm over the
    channel-last axis (``batch_norm_last``).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vtaco_tpu_torch.models.init import Linear
from vtaco_tpu_torch.models.layers import BatchNorm1d, batch_norm_last


def square_distance(src, dst):
    """(B, N, C) x (B, M, C) → (B, N, M) squared distances."""
    d = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    d = d + torch.sum(src ** 2, -1)[:, :, None]
    return d + torch.sum(dst ** 2, -1)[:, None, :]


def index_points(points, idx):
    """Gather (B, N, C) at (B, ...) indices → (B, ..., C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(tuple(idx.shape) + (C,))


def farthest_point_sample(xyz, npoint: int):
    """Greedy FPS from point 0: (B, N, 3) → (B, npoint) int64 ids."""
    B, N, _ = xyz.shape
    distance = torch.full((B, N), 1e10, device=xyz.device,
                          dtype=torch.promote_types(xyz.dtype, torch.float32))
    farthest = torch.zeros(B, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    centroids = []
    for _ in range(npoint):
        centroids.append(farthest)
        centroid = xyz[rows, farthest][:, None, :]
        distance = torch.minimum(distance, torch.sum((xyz - centroid) ** 2, -1))
        farthest = torch.argmax(distance, dim=-1)
    return torch.stack(centroids, dim=1)


def query_ball_point(radius, nsample, xyz, new_xyz):
    """Ids of at most ``nsample`` points within ``radius`` of each centre,
    padded with the first in-ball id: (B, S, nsample) int64."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)
    ids = torch.arange(N, device=xyz.device).expand(B, S, N)
    ids = torch.where(sqrdists > radius ** 2, N, ids)
    group_idx = torch.sort(ids, dim=-1).values[:, :, :nsample]
    return torch.where(group_idx == N, group_idx[:, :, :1], group_idx)


class _PointMLP(nn.Module):
    """``mlp{i}`` Linear layers, each followed by ``bn{i}`` and a ReLU."""

    def __init__(self, in_ch, mlp):
        super().__init__()
        self.depth = len(mlp)
        for i, ch in enumerate(mlp):
            self.add_module(f"mlp{i}", Linear(in_ch, ch))
            self.add_module(f"bn{i}", BatchNorm1d(ch))
            in_ch = ch

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"mlp{i}")(x)
            x = F.relu(batch_norm_last(getattr(self, f"bn{i}"), x))
        return x


class SetAbstraction(_PointMLP):
    """FPS, ball grouping, the shared MLP and a max pool over each group
    (``group_all``: one group of every point around the origin)."""

    def __init__(self, npoint, radius, nsample, in_ch, mlp, group_all=False):
        super().__init__(in_ch, mlp)
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all

    def forward(self, xyz, points):
        B = xyz.shape[0]
        if self.group_all:
            new_xyz = xyz.new_zeros((B, 1, 3))
            grouped = xyz[:, None]
            if points is not None:
                grouped = torch.cat([grouped, points[:, None]], dim=-1)
        else:
            new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([grouped, index_points(points, idx)], dim=-1)
        return new_xyz, torch.amax(super().forward(grouped), dim=2)


class FeaturePropagation(_PointMLP):
    """Inverse-distance interpolation from the 3 nearest coarse points,
    concatenated after the fine level's own features, then the MLP."""

    def forward(self, xyz1, xyz2, points1, points2):
        B, N, _ = xyz1.shape
        S = xyz2.shape[1]
        if S == 1:
            interpolated = points2.expand(B, N, points2.shape[-1])
        else:
            d, idx = torch.sort(square_distance(xyz1, xyz2), dim=-1, stable=True)
            k = min(3, S)
            recip = 1.0 / (torch.clamp(d[:, :, :k], min=0.0) + 1e-8)
            weight = recip / torch.sum(recip, dim=2, keepdim=True)
            interpolated = torch.sum(index_points(points2, idx[:, :, :k])
                                     * weight[..., None], dim=2)
        x = interpolated if points1 is None else torch.cat([points1, interpolated], -1)
        return super().forward(x)


class PointNetPlusPlus(nn.Module):
    """(B, N, dim) points → (the points, (B, N, c_dim) features)."""

    def __init__(self, dim=3, c_dim=128):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, 3 + dim, (64, 64, 128))
        self.sa2 = SetAbstraction(128, 0.4, 64, 3 + 128, (128, 128, 256))
        self.sa3 = SetAbstraction(None, None, None, 3 + 256, (256, 512, 1024),
                                  group_all=True)
        self.fp3 = FeaturePropagation(256 + 1024, (256, 256))
        self.fp2 = FeaturePropagation(128 + 256, (256, 128))
        self.fp1 = FeaturePropagation(128, (128, 128, c_dim))

    def forward(self, xyz):
        l0_xyz = xyz[..., :3]
        l1_xyz, l1_points = self.sa1(l0_xyz, xyz)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points)
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points)
        return xyz, self.fp1(l0_xyz, l1_xyz, None, l1_points)
