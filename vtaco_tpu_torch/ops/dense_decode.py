"""Dense-grid decode inputs: gather-free separable interpolation
(port of vtaco_tpu/ops/dense_decode.py:25-143).

The mesh-extraction queries form a regular nx³ grid, so trilinear
sampling of the (R, R, R, C) feature grid factorizes into three 1D
align-corners interpolations, each a matmul with a fixed (nx, R) matrix.
These are plain large products, left to ``torch.einsum`` as the JAX
package leaves them to XLA. Outputs are channels-first (C, N) with N
flattened z-slowest, the layout the decoder trunk streams.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_interp_matrix(nx: int, R: int, box_size: float, padding: float,
                        three_d: bool) -> np.ndarray:
    """(nx, R) align-corners linear interpolation matrix for one axis.

    Row i interpolates at the dense-grid coordinate
    ``box_size * (-0.5 + i/(nx-1))`` after the normalization of
    ops.geometry (outlier-only remap) and border clamping."""
    coords = box_size * (-0.5 + np.arange(nx) / (nx - 1))
    eps = 10e-4 if three_d else 10e-6
    u = coords / (1 + padding + eps) + 0.5
    u = np.where(u >= 1.0, 1 - eps, np.maximum(u, 0.0))
    x = np.clip(u * (R - 1), 0.0, R - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, R - 1)
    x1 = np.minimum(x0 + 1, R - 1)
    w = (x - x0).astype(np.float32)
    W = np.zeros((nx, R), np.float32)
    W[np.arange(nx), x0] += 1 - w
    np.add.at(W, (np.arange(nx), x1), w)
    return W


def dense_feature_volume_cn(c_planes: dict, nx: int, box_size: float,
                            padding: float, dtype=torch.float32):
    """(C, nx³) features of the ``grid`` field at the dense query grid, N
    flattened (z slowest, y, x fastest). The grid is (1, Z, Y, X, C) or
    (Z, Y, X, C), channel-last as the encoder returns it."""
    extra = set(c_planes) - {"grid"}
    if extra:
        raise NotImplementedError(
            f"plane feature fields {sorted(extra)} are not ported yet "
            "(the hand-encoder slice; see ROADMAP.md)")
    g = c_planes["grid"]
    if g.ndim == 5:
        g = g[0]
    g = g.to(dtype)
    R = g.shape[0]
    W = torch.as_tensor(_axis_interp_matrix(nx, R, box_size, padding, True),
                        dtype=dtype, device=g.device)
    g = g.permute(3, 0, 1, 2)                           # (C, Z, Y, X)
    g = torch.einsum("iz,czyx->ciyx", W, g)
    g = torch.einsum("jy,ciyx->cijx", W, g)
    g = torch.einsum("kx,cijx->cijk", W, g)
    return g.reshape(g.shape[0], -1)


def dense_query_grid_cn(nx: int, box_size: float, device="cuda"):
    """(3, nx³) query coordinates (x, y, z rows), N flattened z-slowest to
    match dense_feature_volume_cn."""
    coords = box_size * (
        -0.5 + torch.arange(nx, dtype=torch.float32, device=device) / (nx - 1))
    gz = coords[:, None, None].expand(nx, nx, nx)
    gy = coords[None, :, None].expand(nx, nx, nx)
    gx = coords[None, None, :].expand(nx, nx, nx)
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)])
