"""Trilinear grid sampling with border padding and align_corners
(port of vtaco_tpu/ops/interp.py:67-109).

Keeps the JAX package's channel-last public layout: grids (B, D, H, W, C)
with D↔z, H↔y, W↔x, sampled at [0, 1]-normalized (B, N, 3) coordinates in
(x, y, z) order. ``F.grid_sample`` takes [-1, 1] coordinates; with
align_corners the composition is ``pix = u * (S - 1)``, as in JAX.
"""

from __future__ import annotations

import torch.nn.functional as F


def interp_grid(fea, uvw, mode: str = "bilinear"):
    """Sample (B, D, H, W, C) grid features at (B, N, 3) coords → (B, N, C)."""
    vol = fea.permute(0, 4, 1, 2, 3)                    # (B, C, D, H, W)
    grid = (2.0 * uvw - 1.0)[:, :, None, None, :]       # (B, N, 1, 1, 3)
    out = F.grid_sample(vol, grid, mode=mode, padding_mode="border",
                        align_corners=True)             # (B, C, N, 1, 1)
    return out[:, :, :, 0, 0].transpose(1, 2)
