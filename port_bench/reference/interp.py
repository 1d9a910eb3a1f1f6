# Frozen copy of vtaco_tpu_torch/ops/interp.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""Feature sampling with border padding and align_corners (port of
vtaco_tpu/ops/interp.py).

Keeps the JAX package's channel-last public layout: planes (B, H, W, C)
sampled at [0, 1]-normalized (B, N, 2) coords (u → W, v → H), grids (B, D,
H, W, C) with D↔z, H↔y, W↔x at (B, N, 3) coords in (x, y, z) order. With
align_corners the pixel coordinate is ``u * (S - 1)``, clamped to the
border. Crop models sample coordinates outside [0, 1] (points outside the
input volume), which the clamp takes to the border.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pix(u, size):
    """[0, 1] coord → pixel coord (align_corners), clamped to the border."""
    return torch.clamp(u * (size - 1), 0.0, size - 1)


def interp_plane(fea, uv, mode: str = "bilinear"):
    """Sample (B, H, W, C) plane features at (B, N, 2) coords → (B, N, C),
    with the JAX package's arithmetic: the four corners gathered and
    weighted (bilinear), or the rounded corner (nearest; ties to even)."""
    B, H, W, C = fea.shape
    x = _pix(uv[..., 0], W)
    y = _pix(uv[..., 1], H)
    flat = fea.reshape(B, H * W, C)

    def g(yy, xx):
        idx = (yy * W + xx)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    if mode == "nearest":
        xi = torch.clamp(torch.round(x).long(), 0, W - 1)
        yi = torch.clamp(torch.round(y).long(), 0, H - 1)
        return g(yi, xi)
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    w00 = ((1 - wy) * (1 - wx))[..., None]
    w01 = ((1 - wy) * wx)[..., None]
    w10 = (wy * (1 - wx))[..., None]
    w11 = (wy * wx)[..., None]
    return g(y0, x0) * w00 + g(y0, x1) * w01 + g(y1, x0) * w10 + g(y1, x1) * w11


def interp_grid(fea, uvw, mode: str = "bilinear"):
    """Sample (B, D, H, W, C) grid features at (B, N, 3) coords → (B, N, C)
    through ``F.grid_sample``, which takes [-1, 1] coordinates."""
    vol = fea.permute(0, 4, 1, 2, 3)                    # (B, C, D, H, W)
    grid = (2.0 * uvw - 1.0)[:, :, None, None, :]       # (B, N, 1, 1, 3)
    out = F.grid_sample(vol, grid, mode=mode, padding_mode="border",
                        align_corners=True)             # (B, C, N, 1, 1)
    return out[:, :, :, 0, 0].transpose(1, 2)
