"""Tactile contact selection and depth back-projection (port of
vtaco_tpu/train/contact.py:30-57)."""

from __future__ import annotations

import torch

DEPTH_REST = 0.0215  # gel at rest: the value depth_origin stores
CAM_FOV = 60.0       # sensor camera field of view, degrees


def random_topk_select(mask, k, generator=None, idx=None):
    """Pick up to k uniformly random True positions of a 1-D bool mask.

    Returns (idx (k,), valid (k,)), valid False for slots beyond the number
    of True entries. The draws come from ``generator`` (a torch.Generator
    on the mask's device). ``idx`` gives the k positions explicitly
    instead, since torch cannot replay the JAX package's jax.random draws:
    the result is then (idx, mask[idx])."""
    if idx is not None:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=mask.device)
        return idx, mask[idx]
    r = torch.rand(mask.shape, generator=generator, device=mask.device)
    key = torch.where(mask, 1.0 + r, r)
    val, idx = torch.topk(key, k)
    # >=: a draw of exactly 0.0 puts a selected entry at key 1.0, while
    # unselected keys are strictly below 1.0
    return idx, val >= 1.0


def backproject_depth(depth_hw, f, width, height):
    """Depth map (H, W) → camera-frame cloud (H*W, 3) in (z, -x, -y) axes."""
    xmap = torch.arange(width, dtype=depth_hw.dtype, device=depth_hw.device)
    ymap = torch.arange(height, dtype=depth_hw.dtype, device=depth_hw.device)
    yg, xg = torch.meshgrid(ymap, xmap, indexing="ij")
    cx, cy = width / 2.0, height / 2.0
    pz = depth_hw
    px = (xg - cx) * pz / f
    py = (yg - cy) * pz / f
    return torch.stack([pz, -px, -py], dim=-1).reshape(-1, 3)
