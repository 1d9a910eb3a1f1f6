"""Metrics (port of vtaco_tpu/ops/metrics.py: compute_iou :17-37,
chamfer_distance :39-58, the host KD-tree chamfer :61-94,
earth_mover_distance :97-108 with its reference name EarthMoverDistance,
and hand_joint_error :111-116).

The KD-tree chamfer runs on the host in the native KD-tree
(native/geom.cpp, the JAX package's replacement for the reference's
pykdtree); a failed build raises."""

from __future__ import annotations

import numpy as np
import torch

from vtaco_tpu_torch import native


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


def chamfer_distance(points1, points2, use_kdtree=False, give_id=False):
    """Symmetric squared chamfer distance, (B, T, 3) tensors → (B,).

    Keeps the reference's quirk: when points2 has fewer than 2048 points,
    points1 is truncated to the same count. ``use_kdtree`` computes it on
    the host instead (chamfer_distance_kdtree, no truncation), with
    ``give_id`` as there."""
    if use_kdtree:
        return chamfer_distance_kdtree(points1, points2, give_id=give_id)
    if points2.shape[1] < 2048:
        points1 = points1[:, : points2.shape[1], :]
    d = torch.sum((points1[:, :, None, :] - points2[:, None, :, :]) ** 2, dim=-1)
    return torch.min(d, dim=1).values.mean(dim=1) + torch.min(d, dim=2).values.mean(dim=1)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nearest_host(points, queries):
    """(M,) squared distances and indices of each query's nearest point in
    the native KD-tree (the JAX package's _nearest_host, without its scipy
    fallback)."""
    return native.geom.nearest(points, queries)


def chamfer_distance_kdtree(points1, points2, give_id=False):
    """Host KD-tree chamfer of (B, T1, 3) and (B, T2, 3) points (tensors or
    arrays) → (B,) float64 numpy: the mean squared distance from points1
    to points2 plus the reverse. ``give_id`` returns (chamfer1, chamfer2,
    (B, T1) indices into points2, (B, T2) indices into points1)."""
    p1, p2 = _host(points1), _host(points2)
    B = p1.shape[0]
    c1, c2 = np.zeros(B), np.zeros(B)
    idx12, idx21 = [], []
    for b in range(B):
        d12, i12 = _nearest_host(p2[b], p1[b])
        d21, i21 = _nearest_host(p1[b], p2[b])
        c1[b], c2[b] = np.mean(d12), np.mean(d21)
        idx12.append(i12)
        idx21.append(i21)
    if give_id:
        return c1, c2, np.stack(idx12), np.stack(idx21)
    return c1 + c2


def earth_mover_distance(points1, points2):
    """Hungarian-assignment EMD on the host (scipy)."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial import distance

    d = distance.cdist(np.asarray(points1), np.asarray(points2))
    assignment = linear_sum_assignment(d)
    return d[assignment].sum() / len(d)


# the reference's name (src/common.py:45), as in the JAX package
EarthMoverDistance = earth_mover_distance


def hand_joint_error(joints_gt, joints_pred):
    """The mean per-joint L2 error (a float) of two (1, J, 3) or (J, 3)
    joint sets, tensors on any device or arrays, on the host in their
    dtype."""
    j_gt, j_pred = _host(joints_gt).squeeze(), _host(joints_pred).squeeze()
    return float(np.mean(np.linalg.norm(j_gt - j_pred, axis=1)))
