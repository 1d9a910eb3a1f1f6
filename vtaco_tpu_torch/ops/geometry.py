"""Coordinate and camera geometry (port of vtaco_tpu/ops/geometry.py).

Same contracts as the JAX functions, on torch tensors: the outlier-only
remap of the normalizations, the ``x + R*(y + R*z)`` flat cell index, the
reference's bespoke camera extrinsics, and the axis-angle rotations of the
MANO layer. The crop helpers at the end (``normalize_coord``,
``coord2index``, ``update_reso``, ``decide_total_volume_range``) are host
numpy, as the JAX package's are: the crop data fields and the crop
volumes call them before anything reaches the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# plane axis pairs of the tri-plane feature fields
PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype, device):
    """A constant tensor, made once per (values, dtype, device): building
    it from a host list on every call would copy it to the card and wait
    for the copy, a host sync inside the train step. Made outside
    inference mode, so that autograd may use it later. Callers must not
    modify it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def inv(a):
    """torch.linalg.inv without its error check, whose read of the
    factorization's status waits for the card; the inverse is the same.
    The matrices inverted here are rotations."""
    return torch.linalg.inv_ex(a).inverse


def normalize_coordinate(p, padding: float = 0.1, plane: str = "xz"):
    """Project points onto a canonical plane and normalize to [0, 1):
    divide by 1 + padding + 1e-5, shift by 0.5, then map values >= 1 to
    1 - 1e-5 and values < 0 to 0 (values in [1 - 1e-5, 1) pass). The
    divisor is a same-device tensor: CUDA divides by a host scalar as a
    multiply by its reciprocal, which would move points across cells."""
    a, b = PLANE_AXES[plane]
    xy = torch.stack([p[..., a], p[..., b]], dim=-1)
    xy = xy / torch.full((), 1 + padding + 10e-6, dtype=xy.dtype, device=xy.device) + 0.5
    eps = torch.full_like(xy, 1 - 10e-6)
    return torch.where(xy >= 1.0, eps, torch.clamp(xy, min=0.0))


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


def make_3d_grid(bb_min, bb_max, shape):
    """Dense host query grid (N, 3) float32 over the box, the last
    coordinate fastest (numpy, as the JAX package's)."""
    pxs = np.linspace(bb_min[0], bb_max[0], shape[0], dtype=np.float32)
    pys = np.linspace(bb_min[1], bb_max[1], shape[1], dtype=np.float32)
    pzs = np.linspace(bb_min[2], bb_max[2], shape[2], dtype=np.float32)
    gx, gy, gz = np.meshgrid(pxs, pys, pzs, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)


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


def quat2mat(quat):
    """Quaternion (w, x, y, z) → rotation matrix, normalizing first."""
    norm = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = norm[..., 0], norm[..., 1], norm[..., 2], norm[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(axisang):
    """Axis-angle (N, 3) → rotation matrices (N, 3, 3) through quaternions,
    with the +1e-8 inside the norm of manopth's rodrigues_layer."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    return quat2mat(torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1))


def axisang_to_euler_xyz(rotvec):
    """Axis-angle (3,) → intrinsic XYZ Euler angles (a, b, c) with
    R = Rx(a) @ Ry(b) @ Rz(c): scipy's ``from_rotvec(v).as_euler('XYZ')``
    away from gimbal lock, through batch_rodrigues as the JAX function
    computes it."""
    R = batch_rodrigues(rotvec.reshape(1, 3))[0]
    b = torch.arcsin(torch.clamp(R[0, 2], -1.0, 1.0))
    a = torch.atan2(-R[1, 2], R[2, 2])
    c = torch.atan2(-R[0, 1], R[0, 0])
    return torch.stack([a, b, c])


# ---------------------------------------------------------------------------
# crop volumes (pointcloud_crop), host numpy: copies of the JAX package's
# helpers (vtaco_tpu/ops/geometry.py:207-265), quirks included


def normalize_coord(p, vol_range, plane="xz"):
    """(N, 3) points → coords in [0, 1] of the crop volume ``vol_range``
    ([lower (3,), upper (3,)]), projected to ``plane`` (N, 2), or (N, 3)
    for 'grid'. Points outside the volume fall outside [0, 1]."""
    p = np.asarray(p, np.float32).copy()
    lo, hi = np.asarray(vol_range[0]), np.asarray(vol_range[1])
    p = (p - lo) / (hi - lo)
    if plane in PLANE_AXES:
        return p[:, list(PLANE_AXES[plane])]
    return p


def coord2index(p, vol_range, reso=None, plane="xz"):
    """(1, N) int64 flat cell index ``x + reso*y (+ reso²*z)`` of points in
    a crop volume. Only an index above reso^k is clamped to the overflow
    cell reso^k: a point on the upper face of the volume lands in the next
    row, and one below the volume keeps its negative or wrapped index, as
    in the reference."""
    x = np.floor(normalize_coord(p, vol_range, plane=plane) * reso).astype(np.int64)
    if x.shape[1] == 2:
        index = x[:, 0] + reso * x[:, 1]
        index[index > reso ** 2] = reso ** 2
    else:
        index = x[:, 0] + reso * (x[:, 1] + reso * x[:, 2])
        index[index > reso ** 3] = reso ** 3
    return index[None]


def update_reso(reso, depth):
    """``reso`` rounded up to a multiple of 2^(depth-1), so that a U-Net
    of ``depth`` levels halves it evenly."""
    base = 2 ** (int(depth) - 1)
    if not float(reso / base).is_integer():
        for i in range(base):
            if float((reso + i) / base).is_integer():
                reso = reso + i
                break
    return reso


def crop_levels(enc_kw):
    """(receptive field, U-Net depth) that size a crop encoder's volumes
    (its ``encoder_kwargs``): 2^(UNet3D levels + 2), and the plane U-Net's
    depth where it has one, else the UNet3D's levels."""
    recep_field = 2 ** (enc_kw["unet3d_kwargs"]["num_levels"] + 2)
    depth = (enc_kw["unet_kwargs"]["depth"] if enc_kw.get("unet")
             else enc_kw["unet3d_kwargs"]["num_levels"])
    return recep_field, depth


def decide_total_volume_range(query_vol_metric, recep_field, unit_size, unet_depth):
    """The whole-scene crop volumes: ([lower, upper] of the input volume,
    [lower, upper] of the query volume, the input resolution), centred at
    the origin. The resolution is ``query_vol_metric / unit_size +
    recep_field - 1`` truncated and rounded up by update_reso (1 above
    10,000)."""
    reso = query_vol_metric / unit_size + recep_field - 1
    reso = update_reso(int(reso), unet_depth)
    input_vol_metric = reso * unit_size
    p_c = np.array([0.0, 0.0, 0.0], np.float32)
    lb_i, ub_i = p_c - input_vol_metric / 2, p_c + input_vol_metric / 2
    lb_q, ub_q = p_c - query_vol_metric / 2, p_c + query_vol_metric / 2
    if reso > 10000:
        reso = 1
    return [lb_i, ub_i], [lb_q, ub_q], reso
