"""Metrics (port of vtaco_tpu/ops/metrics.py: compute_iou :17-37,
chamfer_distance :39-58 and earth_mover_distance :97-104)."""

from __future__ import annotations

import numpy as np
import torch


def compute_iou(occ1, occ2, threshold=0.5, legacy_mean_threshold=True):
    """IoU per batch row of two occupancy sets (B, ...) → (B,).

    ``legacy_mean_threshold=True`` keeps the reference's quirk: both sides
    are binarized at mean(occ2) over the whole batch and ``threshold`` is
    ignored. False binarizes both at ``threshold``."""
    occ1 = occ1.reshape(occ1.shape[0], -1) if occ1.dim() >= 2 else occ1
    occ2 = occ2.reshape(occ2.shape[0], -1) if occ2.dim() >= 2 else occ2
    thr = torch.mean(occ2) if legacy_mean_threshold else threshold
    b1, b2 = occ1 >= thr, occ2 >= thr
    union = torch.sum(b1 | b2, dim=-1).float()
    inter = torch.sum(b1 & b2, dim=-1).float()
    return inter / union


def chamfer_distance(points1, points2):
    """Symmetric squared chamfer distance, (B, T, 3) tensors → (B,).

    Keeps the reference's quirk: when points2 has fewer than 2048 points,
    points1 is truncated to the same count."""
    if points2.shape[1] < 2048:
        points1 = points1[:, : points2.shape[1], :]
    d = torch.sum((points1[:, :, None, :] - points2[:, None, :, :]) ** 2, dim=-1)
    return torch.min(d, dim=1).values.mean(dim=1) + torch.min(d, dim=2).values.mean(dim=1)


def earth_mover_distance(points1, points2):
    """Hungarian-assignment EMD on the host (scipy)."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial import distance

    d = distance.cdist(np.asarray(points1), np.asarray(points2))
    assignment = linear_sum_assignment(d)
    return d[assignment].sum() / len(d)
