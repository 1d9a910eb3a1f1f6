# Frozen copy of vtaco_tpu_torch/models/mano.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""Differentiable MANO hand layer (port of vtaco_tpu/models/mano.py:39-191
and the asset loading of models/mano_assets.py:77).

Pose coefficients → per-joint rotations (axis-angle through quaternions;
the root's from the 6D representation with ``root_rot_mode`` 'rotmat', as
the JAX package reads it) → shape and pose blendshapes → forward kinematics over the 16-joint
kintree → linear blend skinning: 778 vertices and 21 joints (16 MANO
joints and 5 fingertip vertices, reordered wrist/thumb/index/middle/
ring/pinky); with ``return_transf`` also each joint's (B, 16, 4, 4)
world transform, recentred or moved by ``trans`` as the vertices are. The
layer has no parameters: its constants are buffers that
are not saved with the state_dict, read from the converted asset
``vtaco_tpu/assets/mano_right.npz`` as a data file.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from port_bench.reference.geometry import batch_rodrigues, const, rot6d_to_rotmat

DEFAULT_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "vtaco_tpu", "assets", "mano_right.npz")

JOINT_REORDER = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19,
                 7, 8, 9, 20]
TIPS_RIGHT = [745, 317, 444, 556, 673]
TIPS_LEFT = [745, 317, 445, 556, 673]


def load_mano_assets(npz_path=None) -> dict:
    """The converted MANO arrays (shapedirs, posedirs, v_template,
    J_regressor, weights, betas, faces, hands_components, hands_mean,
    kintree_parents)."""
    with np.load(npz_path or DEFAULT_NPZ) as z:
        return {k: z[k] for k in z.files}


class ManoLayer(nn.Module):
    def __init__(self, center_idx=None, flat_hand_mean=True, ncomps=6,
                 side="right", mano_root=None, use_pca=True,
                 root_rot_mode="axisang", joint_rot_mode="axisang",
                 robust_rot=False, return_transf=False, return_full_pose=False,
                 assets_npz=None):
        super().__init__()
        if use_pca and joint_rot_mode != "axisang":
            raise TypeError("use_pca requires joint_rot_mode='axisang'")
        # the joints' rotations are axis-angle whatever joint_rot_mode says,
        # as in the JAX package; the root's are 6D under 'rotmat'
        if root_rot_mode not in ("axisang", "rotmat"):
            raise KeyError(f"root_rot_mode {root_rot_mode}")
        self.rot = 3 if root_rot_mode == "axisang" else 6
        self.return_transf = return_transf
        self.center_idx = center_idx
        self.use_pca = use_pca
        self.ncomps = ncomps if use_pca else 45
        self.side = side
        self.return_full_pose = return_full_pose
        a = load_mano_assets(assets_npz)
        hands_mean = np.zeros_like(a["hands_mean"]) if flat_hand_mean else a["hands_mean"]
        consts = dict(shapedirs=a["shapedirs"], posedirs=a["posedirs"],
                      v_template=a["v_template"], J_regressor=a["J_regressor"],
                      weights=a["weights"], betas=a["betas"], hands_mean=hands_mean,
                      selected_comps=a["hands_components"][: self.ncomps])
        for k, v in consts.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32)),
                                 persistent=False)
        self.register_buffer("faces", torch.as_tensor(np.asarray(a["faces"], np.int64)),
                             persistent=False)
        self.kintree_parents = [int(p) for p in a["kintree_parents"]]

    @property
    def th_faces(self):
        """The reference's name of the ``faces`` buffer."""
        return self.faces

    def forward(self, pose_coeffs, betas=None, trans=None):
        """(B, rot + ncomps) → (verts (B, 778, 3), joints (B, 21, 3)[,
        transforms (B, 16, 4, 4)][, full pose (B, rot + 45)]), rot 3 for an
        axis-angle root and 6 for a 6D one. The layer computes in its constants' dtype: a
        bfloat16 input (the hand encoder's coefficients under mixed
        precision) is cast to float32 here, where the JAX package promotes
        it at the layer's first product."""
        pose_coeffs = pose_coeffs.to(self.shapedirs.dtype)
        B = pose_coeffs.shape[0]
        hand_pose = pose_coeffs[:, self.rot:self.rot + self.ncomps]
        if self.use_pca:
            hand_pose = hand_pose @ self.selected_comps
        full_pose = torch.cat([pose_coeffs[:, :self.rot], self.hands_mean + hand_pose],
                              dim=1)
        if self.rot == 3:
            rots = batch_rodrigues(full_pose.reshape(B * 16, 3)).reshape(B, 16, 3, 3)
        else:
            joints = batch_rodrigues(full_pose[:, 6:].reshape(B * 15, 3)).reshape(B, 15, 3, 3)
            rots = torch.cat([rot6d_to_rotmat(full_pose[:, :6])[:, None], joints], dim=1)
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_map = (rots[:, 1:] - eye).reshape(B, 15 * 9)

        if betas is None:
            v_shaped = (torch.einsum("vis,s->vi", self.shapedirs, self.betas)
                        + self.v_template)[None]
            j_rest = torch.einsum("jv,bvi->bji", self.J_regressor, v_shaped)
            v_shaped = v_shaped.expand(B, 778, 3)
            j_rest = j_rest.expand(B, 16, 3)
        else:
            v_shaped = torch.einsum("vis,bs->bvi", self.shapedirs, betas) + self.v_template
            j_rest = torch.einsum("jv,bvi->bji", self.J_regressor, v_shaped)
        v_posed = v_shaped + torch.einsum("vip,bp->bvi", self.posedirs, pose_map)

        # forward kinematics over the kintree
        bottom = const((0.0, 0.0, 0.0, 1.0), rots.dtype, rots.device).expand(B, 1, 4)
        transforms = []
        for j in range(16):
            parent = self.kintree_parents[j]
            rel_t = j_rest[:, 0] if j == 0 else j_rest[:, j] - j_rest[:, parent]
            t_local = torch.cat([torch.cat([rots[:, j], rel_t[:, :, None]], dim=2),
                                 bottom], dim=1)
            transforms.append(t_local if j == 0 else transforms[parent] @ t_local)
        G = torch.stack(transforms, dim=1)                       # (B, 16, 4, 4)

        # remove the rest pose's joint translation
        Rj = torch.einsum("bkij,bkj->bki", G[:, :, :3, :3], j_rest)
        A = torch.cat([G[:, :, :, :3],
                       torch.cat([G[:, :, :3, 3:] - Rj[..., None], G[:, :, 3:, 3:]],
                                 dim=2)], dim=3)

        # linear blend skinning
        T = torch.einsum("bkij,vk->bvij", A, self.weights)       # (B, 778, 4, 4)
        v_h = torch.cat([v_posed, v_posed.new_ones((B, 778, 1))], dim=-1)
        verts = torch.einsum("bvij,bvj->bvi", T, v_h)[..., :3]

        # index tensors made once per device: a host list would be copied
        # to the card, and waited for, on every call
        dev = verts.device
        tips = verts.index_select(1, const(tuple(TIPS_RIGHT if self.side == "right"
                                                 else TIPS_LEFT), torch.int64, dev))
        jtr = torch.cat([G[:, :, :3, 3], tips], dim=1).index_select(
            1, const(tuple(JOINT_REORDER), torch.int64, dev))

        center = None
        if trans is None:
            if self.center_idx is not None:
                center = jtr[:, self.center_idx:self.center_idx + 1]
                jtr = jtr - center
                verts = verts - center
        else:
            jtr = jtr + trans[:, None]
            verts = verts + trans[:, None]
        out = [verts, jtr]
        if self.return_transf:
            g_t = G[:, :, :3, 3:]
            if center is not None:
                g_t = g_t - center[:, :, :, None]
            if trans is not None:
                g_t = g_t + trans[:, None, :, None]
            out.append(torch.cat([torch.cat([G[:, :, :3, :3], g_t], dim=3),
                                  G[:, :, 3:]], dim=2))
        if self.return_full_pose:
            out.append(full_pose)
        return tuple(out)
