# Frozen copy of vtaco_tpu_torch/train/contact.py, trimmed to what the benchmark runs and
# kept as its plain reference: it imports nothing of the port and is never
# edited to follow it.
"""Tactile contact selection, depth back-projection, the contact sample
of the t2d loss paths, and the fingertip sample and features of the img
path (VTacOH) (port of vtaco_tpu/train/contact.py:30-263).

Shapes are fixed: each touching finger contributes at most
``per_finger`` contact pixels (or query points near its fingertip),
picked uniformly at random by a top-k over random keys, and every slot
that holds no contact takes a random query point, so a sample always has
``num_sample`` points.

Under a data-parallel mesh each rank holds some rows of the batch; the
draw functions take that rank's ``rows`` (parallel.mesh.Rows), draw for
the whole global batch from the generator every rank seeds alike, and
keep the rank's rows, so that every rank draws what one device would.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from port_bench.reference.geometry import R_from_PYR, const, inv, norm_pc_1

DEPTH_REST = 0.0215  # gel at rest: the value depth_origin stores
CAM_FOV = 60.0       # sensor camera field of view, degrees
TIP_RADIUS = 0.05    # fingertip neighbourhood of the img path and VTacOH's gates
TIP_JOINTS = (4, 8, 12, 16, 20)   # MANO's fingertip joints, thumb first


def _draw(fn, shape, rows):
    """fn(shape), drawn for the whole global batch when ``rows`` is set
    and cut to the rank's rows."""
    if rows is None:
        return fn(tuple(shape))
    return rows.draw(fn((rows.total,) + tuple(shape[1:])))


def random_topk_select(mask, k, generator=None, idx=None, rows=None):
    """Pick up to k uniformly random True positions along the last axis of
    a bool mask (..., M).

    Returns (idx (..., k), valid (..., k)), valid False for slots beyond the
    number of True entries. The draws come from ``generator`` (a
    torch.Generator on the mask's device). ``idx`` gives the k positions
    explicitly instead, since torch cannot replay the JAX package's
    jax.random draws: the result is then (idx, mask[idx])."""
    if idx is not None:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=mask.device)
        return idx, torch.gather(mask, -1, idx)
    r = _draw(lambda sh: torch.rand(sh, generator=generator, device=mask.device),
              mask.shape, rows)
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


class ContactSample(NamedTuple):
    points: torch.Tensor   # (B, num_sample, 3) decode sample
    valid: torch.Tensor    # (B, num_sample) True where the slot holds a contact
    finger: torch.Tensor   # (B, num_sample) finger id of the slot (-1: none)


def scatter_finger_features(c_img, sample: ContactSample, init: str = "zeros"):
    """Per-point tactile features (B, num_sample, C) from the slots' finger
    ids: a contact slot takes its finger's feature of c_img (B, 5, C), any
    other slot zeros (init 'zeros', the img path) or ones (init 'ones', the
    t2d_img path)."""
    base = torch.zeros_like if init == "zeros" else torch.ones_like
    f_safe = torch.clamp(sample.finger, 0, 4)
    gathered = torch.gather(c_img, 1, f_safe[..., None].expand(-1, -1, c_img.shape[-1]))
    return torch.where(sample.valid[..., None], gathered, base(gathered))


def tips_in_object_frame(mano_joints, wrist_pos, wrist_rot_euler, pc_ply):
    """(B, 5, 3) fingertips in the normalized object frame: the canonical
    MANO joints (B, 21, 3) less the fixed offset (0.11, 0.005, 0), un-rotated
    by the canonical wrist rotation R(-π/2, π/2, 0) and then by the wrist's
    Euler angles (B, 3) (both through the inverse of R_from_PYR), moved by
    the wrist position (B, 3), then normalized by each sample's scan
    ``pc_ply`` (B, P, 3) (norm_pc_1)."""
    dt, dev = mano_joints.dtype, mano_joints.device
    offset = const((0.11, 0.005, 0.0), dt, dev)
    canon = const((-math.pi / 2, math.pi / 2, 0.0), dt, dev)
    R_canon_inv = inv(R_from_PYR(canon))
    R_wrist_inv = inv(torch.stack(
        [R_from_PYR(w) for w in wrist_rot_euler.to(dt)]))                # (B, 3, 3)
    tips = mano_joints.index_select(1, const(TIP_JOINTS, torch.int64, dev)) - offset  # (B, 5, 3)
    tips = R_wrist_inv @ (R_canon_inv @ tips.transpose(1, 2))            # (B, 3, 5)
    tips = tips.transpose(1, 2) + wrist_pos[:, None, :]
    return torch.stack([norm_pc_1(t, ply) for t, ply in zip(tips, pc_ply)])


def _nearest_tip(query_points, tips):
    """(B, N) True where a point lies within TIP_RADIUS of its nearest
    fingertip, and (B, N) that tip's index, by the direct (unexpanded)
    distance, as the JAX package measures it here."""
    d = torch.linalg.norm(query_points[:, :, None, :] - tips[:, None, :, :], dim=-1)
    return torch.amin(d, dim=-1) < TIP_RADIUS, torch.argmin(d, dim=-1)


def tips_mask(query_points, tips, touch_success):
    """(B, 5, N) True where a query point's nearest fingertip is that
    finger's, within TIP_RADIUS, and the finger touches."""
    near, assign = _nearest_tip(query_points, tips)
    fingers = torch.arange(tips.shape[1], device=tips.device)
    return (near[:, None] & (assign[:, None] == fingers[None, :, None])
            & touch_success[:, :, None])


def tips_draws(mask, num_sample, per_finger, generator=None, rows=None):
    """The random draws of fingertip_gated_sample: {"contact_idx": (B, 5,
    k) query points per finger (k = min(per_finger, num_sample // 5)),
    "rand_idx": (B, num_sample) query points}, from ``generator`` on the
    mask's device."""
    per_finger = min(per_finger, num_sample // 5)
    idx, _ = random_topk_select(mask, per_finger, generator, rows=rows)
    rand_idx = _draw(lambda sh: torch.randint(0, mask.shape[-1], sh, generator=generator,
                                              device=mask.device),
                     (mask.shape[0], num_sample), rows)
    return {"contact_idx": idx, "rand_idx": rand_idx}


def fingertip_gated_sample(query_points, occ, tips, touch_success, num_sample,
                           per_finger, generator=None, draws=None, rows=None):
    """The img path's decode sample, biased to the fingertips.

    For each touching finger, at most ``per_finger`` (capped at
    num_sample // 5) query points whose nearest fingertip is that finger's,
    within TIP_RADIUS, take the sample's first slots, finger by finger;
    every other slot, and every slot without such a point, takes a random
    query point.

    Args:
      query_points: (B, N, 3); occ: (B, N) their occupancy labels.
      tips:          (B, 5, 3) fingertips (tips_in_object_frame).
      touch_success: (B, 5) bool.
      generator:     torch.Generator on the tensors' device for the draws.
      draws:         the draws given explicitly instead (tips_draws'
                     dict), since torch cannot replay jax.random.
      rows:          this rank's rows of a data-parallel batch.
    Returns:
      (ContactSample, (B, num_sample) labels of the sampled points).
    """
    B, dev = query_points.shape[0], query_points.device
    per_finger = min(per_finger, num_sample // 5)
    n_slots = 5 * per_finger
    mask = tips_mask(query_points, tips, touch_success)
    if draws is None:
        draws = tips_draws(mask, num_sample, per_finger, generator, rows)
    idx = torch.as_tensor(draws["contact_idx"], dtype=torch.int64, device=dev)
    valid = torch.gather(mask, 2, idx).reshape(B, n_slots)
    rand_idx = torch.as_tensor(draws["rand_idx"], dtype=torch.int64, device=dev)
    sel = torch.cat([torch.where(valid, idx.reshape(B, n_slots), rand_idx[:, :n_slots]),
                     rand_idx[:, n_slots:]], dim=1)
    points = torch.gather(query_points, 1, sel[..., None].expand(-1, -1, 3))
    finger_ids = torch.arange(5, device=dev).repeat_interleave(per_finger)
    finger = torch.full((B, num_sample), -1, dtype=torch.int64, device=dev)
    finger[:, :n_slots] = torch.where(valid, finger_ids, -1)
    valid_all = torch.zeros((B, num_sample), dtype=torch.bool, device=dev)
    valid_all[:, :n_slots] = valid
    return ContactSample(points, valid_all, finger), torch.gather(occ, 1, sel)


