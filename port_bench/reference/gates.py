"""The tactile gates of one grasp and the plain dense decode, in plain
PyTorch: what ``Generator3D._build_gates``, ``_prep_contact_gates``,
``_gate_chunk`` and the legacy dense decode compute, written again from
their definitions (the contact choice keeps the port's draw: up to K
touching pixels per finger by the top-k of uniform keys from a
``torch.Generator`` on the card seeded with the request's seed).

``gate_rows`` also returns which points are settled: those whose squared
distance (in float64) to every gate lies farther than ``NEAR`` from the
radius squared, and, for fingertips, whose two nearest tips do not tie
within ``NEAR``. Elsewhere a float32 gate decision may round either way,
so a comparison of logits leaves those points out.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.contact import (
    CAM_FOV,
    DEPTH_REST,
    backproject_depth,
    random_topk_select,
    tips_in_object_frame,
)
from port_bench.reference.geometry import norm_pc_1, pc_cam_to_world

CONTACT_RADIUS = 0.015
TIP_RADIUS = 0.05
NEAR = 1e-6
ROT_OFF = (-math.pi / 2, 0.0, math.pi / 2)


def contact_gates(depths, touch, pc_ply, cam_pos, cam_rot, H, W, seed, K=128):
    """((5, K, 3) normalized contact points, (5, K) validity) from the
    ground-truth depths (5, H*W), touch flags (5,), sensor poses (5, 3)
    and the scan (P, 3)."""
    d_origin = torch.full((H * W,), DEPTH_REST, device=depths.device)
    f = H / (2 * math.tan(math.radians(CAM_FOV / 2)))
    gen = torch.Generator(device=depths.device)
    gen.manual_seed(seed)
    rot_off = torch.tensor(ROT_OFF, dtype=cam_rot.dtype, device=cam_rot.device)
    pts, valid = [], []
    for k in range(5):
        mask = (torch.abs(depths[k] - d_origin) > 0.0001) & touch[k]
        idx, ok = random_topk_select(mask, K, gen)
        cloud = backproject_depth(depths[k].reshape(H, W), f, W, H)
        world = pc_cam_to_world(cloud[idx], cam_rot[k] + rot_off, cam_pos[k])
        pts.append(norm_pc_1(world, pc_ply))
        valid.append(ok)
    return torch.stack(pts), torch.stack(valid)


def grasp_gates(model, g, seed, device, contact):
    """(gating, gate_pts, gate_feat, gate_valid) of a B = 1 grasp ``g``
    (host arrays in the loader's layout): contact gates where the
    configuration has a tactile-to-depth model (``contact``), fingertip
    gates where it has none."""
    def get(key):
        return torch.as_tensor(g[key], dtype=torch.float32, device=device)

    imgs = get("inputs.img")
    c_img = model.encode_img_inputs(imgs)[0]                    # (5, C)
    touch = get("inputs.touch_success")[0] > 0.5
    if contact:
        H, W = imgs.shape[2], imgs.shape[3]
        pts, valid = contact_gates(get("inputs.depth")[0], touch, get("inputs.pc_ply")[0],
                                   get("points.cam_pos")[0], get("points.cam_rot")[0],
                                   H, W, seed)
        return "contact", pts, c_img, valid
    joints = model.encode_hand_inputs(get("inputs"))["mano_joints"]
    tips = tips_in_object_frame(joints, get("points.mano")[:, :3], get("points.wrist"),
                                get("inputs.pc_ply"))[0]
    return "tips", tips, c_img, touch


def gate_rows(pts, gating, gate_pts, gate_feat, gate_valid):
    """((n, C) tactile rows of (n, 3) points, (n,) settled): 'tips', the
    nearest touching fingertip's feature within TIP_RADIUS; 'contact', the
    feature of the last finger with a valid contact within
    CONTACT_RADIUS; zeros elsewhere."""
    if gating == "tips":
        d = torch.linalg.norm(pts[:, None, :] - gate_pts[None], dim=-1)
        dmin, assign = torch.min(d, dim=1)
        on = gate_valid[assign] & (dmin < TIP_RADIUS)
        rows = torch.where(on[:, None], gate_feat[assign], 0.0)
        d2 = ((pts.double()[:, None] - gate_pts.double()[None]) ** 2).sum(-1)
        two = torch.sort(d2, dim=1).values[:, :2]
        unsettled = (torch.abs(d2 - TIP_RADIUS ** 2) < NEAR).any(1) \
            | (two[:, 1] - two[:, 0] < NEAR)
        return rows, ~unsettled
    d = torch.linalg.norm(pts[:, None, None, :] - gate_pts[None], dim=-1)   # (n, 5, K)
    within = torch.any((d < CONTACT_RADIUS) & gate_valid[None], dim=-1)      # (n, 5)
    last = 4 - torch.argmax(torch.flip(within, [1]).to(torch.uint8), dim=1)
    rows = torch.where(torch.any(within, dim=1)[:, None], gate_feat[last], 0.0)
    d2 = ((pts.double()[:, None, None] - gate_pts.double()[None]) ** 2).sum(-1)
    unsettled = ((torch.abs(d2 - CONTACT_RADIUS ** 2) < NEAR) & gate_valid[None]).any((1, 2))
    return rows, ~unsettled


def dense_points(nx, box, device):
    """(nx³, 3) grid points, x slowest: box · (i / (nx - 1) - 0.5) per axis."""
    ax = box * (torch.arange(nx, dtype=torch.float64, device=device) / (nx - 1) - 0.5)
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], 1).float()


def dense_logits(model, c, gates, nx, box, block=1 << 16):
    """((nx³,) logits, (nx³,) settled) of the grid, x slowest, in blocks of
    points through the plain decoder."""
    gating, gate_pts, gate_feat, gate_valid = gates
    dev = next(model.parameters()).device
    pts = dense_points(nx, box, dev)
    out = torch.empty(len(pts), device=dev)
    settled = torch.ones(len(pts), dtype=torch.bool, device=dev)
    for i in range(0, len(pts), block):
        p = pts[i:i + block]
        if gating == "none":
            out[i:i + block] = model.decode(p[None], c)[0]
            continue
        rows, ok = gate_rows(p, gating, gate_pts, gate_feat, gate_valid)
        out[i:i + block] = model.decode_img(p[None], c, rows[None])[0]
        settled[i:i + block] = ok
    return out, settled
