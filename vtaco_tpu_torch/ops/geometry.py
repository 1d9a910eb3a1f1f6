"""Coordinate and camera geometry (port of vtaco_tpu/ops/geometry.py).

Same contracts as the JAX functions, on torch tensors: the outlier-only
remap of the normalizations, the ``x + R*(y + R*z)`` flat cell index, and
the reference's bespoke camera extrinsics.
"""

from __future__ import annotations

import torch


def normalize_3d_coordinate(p, padding: float = 0.1):
    """Normalize 3D points to [0, 1) for the grid feature volume.

    Values >= 1 map to 1 - 1e-3 and values < 0 to 0; values in
    [1 - 1e-3, 1) pass through untouched (not a clip)."""
    p_nor = p / (1 + padding + 10e-4) + 0.5
    eps = torch.full_like(p_nor, 1 - 10e-4)
    return torch.where(p_nor >= 1.0, eps, torch.clamp(p_nor, min=0.0))


def coordinate2index(x, reso: int, coord_type: str = "3d"):
    """Flat cell index of normalized coordinates: ``floor(x * reso)`` per
    axis, then ``x + reso*y (+ reso²*z)`` (x fastest). Returns int64
    (..., N)."""
    xi = (x * reso).to(torch.int64)
    if coord_type == "2d":
        return xi[..., 0] + reso * xi[..., 1]
    if coord_type == "3d":
        return xi[..., 0] + reso * (xi[..., 1] + reso * xi[..., 2])
    raise ValueError(coord_type)


def _stack3x3(rows):
    return torch.stack([torch.stack(r) for r in rows])


def R_from_PYR(wrist_rot):
    """``R_pitch @ R_yaw @ R_roll`` from (roll, pitch, yaw), with the
    reference's axis conventions (roll about z, pitch about x and yaw about
    y, both with transposed signs)."""
    roll, pitch, yaw = wrist_rot[0], wrist_rot[1], wrist_rot[2]
    z = torch.zeros((), dtype=wrist_rot.dtype, device=wrist_rot.device)
    o = torch.ones((), dtype=wrist_rot.dtype, device=wrist_rot.device)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    R_roll = _stack3x3([[cr, -sr, z], [sr, cr, z], [z, z, o]])
    R_pitch = _stack3x3([[o, z, z], [z, cp, sp], [z, -sp, cp]])
    R_yaw = _stack3x3([[cy, z, -sy], [z, o, z], [sy, z, cy]])
    return R_pitch @ R_yaw @ R_roll


def norm_pc_1(pc, pc_obj):
    """Center by the object cloud's centroid and scale by twice its max
    radius."""
    centroid = torch.mean(pc_obj, dim=0)
    pc = pc - centroid
    pc_obj = pc_obj - centroid
    m = torch.max(torch.sqrt(torch.sum(pc_obj ** 2, dim=1)))
    return pc / (2 * m)


def pc_cam_to_world(pc, rot, trans):
    """Camera → world: ``extrinsic[:3,:3] = rot_z @ rot_x @ rot_y`` (each a
    non-standard axis matrix), inverted, then ``R_inv @ p + T`` with the
    uninverted translation T."""
    dx, dy, dz = rot[0], rot[1], rot[2]
    z = torch.zeros((), dtype=rot.dtype, device=rot.device)
    o = torch.ones((), dtype=rot.dtype, device=rot.device)
    cx, sx = torch.cos(dx), torch.sin(dx)
    cy, sy = torch.cos(dy), torch.sin(dy)
    cz, sz = torch.cos(dz), torch.sin(dz)
    rot_x = _stack3x3([[cx, z, sx], [z, o, z], [-sx, z, cx]])
    rot_y = _stack3x3([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    rot_z = _stack3x3([[z, z, o], [cz, sz, z], [-sz, cz, z]])
    R = rot_z @ rot_x @ rot_y
    R_inv = torch.linalg.inv(R)
    return (R_inv @ pc.T).T + trans
