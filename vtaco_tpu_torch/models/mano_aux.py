"""MANO auxiliary geometry (port of vtaco_tpu/models/mano_aux.py:27-162):
hand anchors, per-joint axes and midpoint mesh subdivision, the manopth
helper surface. Nothing in the training or serving pipelines calls them.

The device math takes and returns torch tensors; the anchor files are
read on the host, and the subdivision's topology (the edge enumeration)
is built on the host once per topology and cached, so the device runs
only fixed-shape gathers.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch

# child joint of each of the 15 articulated MANO joints, in the 21-joint order
_JOINTS_MAPPING = (5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3)
_UP_AXIS_BASE = ((0.0, 1.0, 0.0),) * 12 + ((1.0, 1.0, 1.0),) * 3


def load_anchors(anchor_root):
    """The hand-anchor files under ``anchor_root``: (face_vert_idx (A, 3)
    int64, anchor_weight (A, 2), merged_vertex_assignment (V,) int64,
    anchor_mapping dict)."""
    face_vert_idx = np.loadtxt(os.path.join(anchor_root, "face_vertex_idx.txt"),
                               dtype=np.int64)
    anchor_weight = np.loadtxt(os.path.join(anchor_root, "anchor_weight.txt"))
    merged = np.loadtxt(os.path.join(anchor_root, "merged_vertex_assignment.txt"),
                        dtype=np.int64)
    with open(os.path.join(anchor_root, "anchor_mapping_path.pkl"), "rb") as f:
        anchor_mapping = pickle.load(f)
    return face_vert_idx, anchor_weight, merged, anchor_mapping


def recover_anchors(vertices, face_vert_idx, anchor_weight):
    """Anchors from hand vertices (B, V, 3): each face's first vertex plus
    its two weighted edge vectors → (B, A, 3)."""
    idx = torch.as_tensor(np.asarray(face_vert_idx), dtype=torch.long,
                          device=vertices.device)
    w = torch.as_tensor(np.asarray(anchor_weight), dtype=vertices.dtype,
                        device=vertices.device)
    tri = vertices[:, idx, :]                                   # (B, A, 3, 3)
    v1 = tri[:, :, 1, :] - tri[:, :, 0, :]
    v2 = tri[:, :, 2, :] - tri[:, :, 0, :]
    return tri[:, :, 0, :] + w[None, :, 0:1] * v1 + w[None, :, 1:2] * v2


def hand_axes(hand_joints, transf):
    """Per-joint (back, up, left) unit axes in each joint's local frame:
    hand_joints (B, 21, 3), transf (B, 16, 4, 4) rigid transforms, root
    first → three (B, 15, 3) tensors."""
    jm = torch.as_tensor(_JOINTS_MAPPING, device=hand_joints.device)
    b = hand_joints[:, jm] - hand_joints[:, jm + 1]
    rot_t = transf[:, 1:, :3, :3].transpose(2, 3)
    b = torch.einsum("bjxy,bjy->bjx", rot_t, b)
    up = torch.as_tensor(_UP_AXIS_BASE, dtype=b.dtype, device=b.device).expand_as(b)
    left = torch.cross(b, up, dim=-1)
    u = torch.cross(left, b, dim=-1)

    def unit(x):
        return x / torch.linalg.norm(x, dim=2, keepdim=True)

    return unit(b), unit(u), unit(left)


@functools.lru_cache(maxsize=256)
def _subdivide_topology_cached(faces_bytes, n_faces, vn):
    faces = np.frombuffer(faces_bytes, np.int64).reshape(n_faces, 3)
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    # each face's edges (a, b), (b, c), (c, a), endpoints sorted
    e = np.stack([np.sort(np.stack([a, b], 1), 1), np.sort(np.stack([b, c], 1), 1),
                  np.sort(np.stack([c, a], 1), 1)], axis=1).reshape(-1, 2)
    # edge ids in order of first visit
    uniq, first, inverse = np.unique(e, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    edge_id = rank[inverse.reshape(-1)].reshape(n_faces, 3)
    edge_idx = uniq[order].astype(np.int64)
    x, y, z = (edge_id + vn).T
    new_faces = np.stack([np.stack([x, y, z], 1), np.stack([a, x, z], 1),
                          np.stack([b, y, x], 1), np.stack([c, z, y], 1)],
                         axis=1).reshape(-1, 3)
    return edge_idx, new_faces


def subdivide_topology(faces, vn):
    """The 1→4 midpoint subdivision of (F, 3) faces over vn vertices:
    (edge_idx (E, 2), the endpoints of each new vertex, new_faces (4F, 3)),
    on the host and cached per topology."""
    faces = np.ascontiguousarray(np.asarray(faces, np.int64))
    return _subdivide_topology_cached(faces.tobytes(), faces.shape[0], vn)


def upsample_mesh(vertices, faces):
    """One midpoint subdivision of vertices (B, V, 3) over faces (F, 3)
    shared by the batch → (vertices (B, V + E, 3), new faces (4F, 3)
    numpy)."""
    edge_idx, new_faces = subdivide_topology(faces, vertices.shape[1])
    ids = torch.as_tensor(edge_idx, device=vertices.device)
    mids = vertices[:, ids, :].mean(dim=2)
    return torch.cat([vertices, mids], dim=1), new_faces
