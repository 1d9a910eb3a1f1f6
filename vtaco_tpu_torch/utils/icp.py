"""Iterative closest point alignment (port of vtaco_tpu/utils/icp.py; the
reference's src/utils/icp.py:5-121): the SVD best-fit rigid transform and
nearest-neighbour correspondences (scipy's cKDTree), iterated to a
tolerance. Host numpy."""

from __future__ import annotations

import numpy as np


def best_fit_transform(A, B):
    """Least-squares rigid transform mapping A onto B: (T (m+1, m+1)
    homogeneous, R, t)."""
    if A.shape != B.shape:
        raise ValueError(f"best_fit_transform needs equal shapes; got {A.shape}, {B.shape}")
    m = A.shape[1]
    centroid_A = np.mean(A, axis=0)
    centroid_B = np.mean(B, axis=0)
    H = (A - centroid_A).T @ (B - centroid_B)
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:   # a reflection: flip the last axis
        Vt[m - 1, :] *= -1
        R = Vt.T @ U.T
    t = centroid_B.T - R @ centroid_A.T
    T = np.identity(m + 1)
    T[:m, :m] = R
    T[:m, m] = t
    return T, R, t


def nearest_neighbor(src, dst):
    """Each src point's nearest dst point: (distances, indices)."""
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(dst).query(src)
    return dist.ravel(), idx.ravel()


def icp(A, B, init_pose=None, max_iterations=20, tolerance=0.001):
    """Align A to B: (T, the last iteration's distances, its index)."""
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"icp needs points of one dimension; got {A.shape}, {B.shape}")
    m = A.shape[1]
    src = np.ones((m + 1, A.shape[0]))
    dst = np.ones((m + 1, B.shape[0]))
    src[:m, :] = A.T
    dst[:m, :] = B.T
    if init_pose is not None:
        src = init_pose @ src

    prev_error = 0.0
    for i in range(max_iterations):
        distances, indices = nearest_neighbor(src[:m, :].T, dst[:m, :].T)
        T, _, _ = best_fit_transform(src[:m, :].T, dst[:m, indices].T)
        src = T @ src
        mean_error = np.mean(distances)
        if np.abs(prev_error - mean_error) < tolerance:
            break
        prev_error = mean_error

    T, _, _ = best_fit_transform(A, src[:m, :].T)
    return T, distances, i
