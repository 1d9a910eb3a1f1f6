"""Winding numbers: occupancy labels computed on the device inside the
train and eval steps (port of vtaco_tpu/ops/winding.py:50-213), and
``winding_number_host``, the host form in the native extension.

The generalized winding number is the triangle solid-angle sum (van
Oosterom & Strackee) over 4π. Every point-dependent quantity of the
formula is affine in the dot products of the query point with four
per-face vectors (A, B, C and N = B×C + C×A + A×B), so the (P, F)
interaction is one (P, 3) by (3, 4F) product and elementwise math. That
product is formed here as three broadcast multiply-adds in float32, so
it never runs in TF32, whatever torch's matmul flags say: the expanded
forms (|a|² = |A|² − 2p·A + |p|², det = det0 − p·N) cancel for points
near the surface, whose labels matter most. Both operands are centered
on the query points' mean first, which removes the cancellation's
dependence on the distance from the origin.

Meshes are padded to fixed shapes with (0, 0, 0) faces, whose solid
angle is zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtaco_tpu_torch import native


def _dot(a, b):
    return (a * b).sum(-1)


def _solid_angles(tri, points):
    """(B, F, 3, 3) triangles, (B, P, 3) points → (B, P, F) signed solid
    angles."""
    A, B, C = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]     # (B, F, 3)
    BxC = torch.linalg.cross(B, C)
    N = BxC + torch.linalg.cross(C, A) + torch.linalg.cross(A, B)
    det0, dAB, dBC, dCA = _dot(A, BxC), _dot(A, B), _dot(B, C), _dot(C, A)
    nA2, nB2, nC2 = _dot(A, A), _dot(B, B), _dot(C, C)
    W = torch.stack([A, B, C, N], dim=2).flatten(1, 2)          # (B, 4F, 3)
    x, y, z = (points[..., i, None] for i in range(3))           # (B, P, 1)
    pd = (x * W[:, None, :, 0] + y * W[:, None, :, 1] + z * W[:, None, :, 2])
    pd = pd.unflatten(2, (-1, 4))                                # (B, P, F, 4)
    pA, pB, pC, pN = pd.unbind(-1)
    pp = _dot(points, points)[..., None]                         # (B, P, 1)
    la = torch.sqrt(torch.clamp(nA2[:, None] - 2.0 * pA + pp, min=0.0))
    lb = torch.sqrt(torch.clamp(nB2[:, None] - 2.0 * pB + pp, min=0.0))
    lc = torch.sqrt(torch.clamp(nC2[:, None] - 2.0 * pC + pp, min=0.0))
    det = det0[:, None] - pN
    denom = (la * lb * lc
             + (dAB[:, None] - pA - pB + pp) * lc
             + (dBC[:, None] - pB - pC + pp) * la
             + (dCA[:, None] - pC - pA + pp) * lb)
    return 2.0 * torch.atan2(det, denom)


def winding_number_batch(verts, faces, points, face_chunk: int = 4096):
    """(B, V, 3) vertices, (B, F, 3) int faces, (B, P, 3) points → (B, P)
    winding numbers (≈1 inside a watertight mesh, ≈0 outside), summed over
    chunks of at most ``face_chunk`` faces."""
    center = points.mean(dim=1, keepdim=True)
    points = points - center
    verts = verts - center
    tri = torch.gather(verts, 1, faces.reshape(faces.shape[0], -1, 1).expand(-1, -1, 3)
                       .long()).reshape(faces.shape + (3,))     # (B, F, 3, 3)
    acc = points.new_zeros(points.shape[:2])
    for s in range(0, tri.shape[1], face_chunk):
        acc = acc + _solid_angles(tri[:, s:s + face_chunk], points).sum(-1)
    return acc / (4.0 * math.pi)


def winding_number(verts, faces, points, face_chunk: int = 4096):
    """(V, 3), (F, 3), (P, 3) → (P,)."""
    return winding_number_batch(verts[None], faces[None], points[None], face_chunk)[0]


def winding_number_host(verts, faces, points):
    """Winding numbers of (P, 3) host points, (P,) float32, on the host in
    the native extension (native/geom.cpp): the same solid-angle formula,
    accumulated in float64, for label precompute and host-side checks."""
    return native.geom.winding_number(verts, faces, points)


def pad_mesh(verts: np.ndarray, faces: np.ndarray, v_max: int, f_max: int):
    """Pad a mesh to (v_max, 3) vertices and (f_max, 3) faces with zero
    rows; (0, 0, 0) faces add a zero solid angle. Raises if the mesh is
    larger."""
    V, F = len(verts), len(faces)
    if V > v_max or F > f_max:
        raise ValueError(f"mesh ({V} verts, {F} faces) exceeds pad budget "
                         f"({v_max}, {f_max})")
    pv = np.zeros((v_max, 3), np.float32)
    pv[:V] = verts
    pf = np.zeros((f_max, 3), np.int32)
    pf[:F] = faces
    return pv, pf


class MeshBank:
    """Every ground-truth object mesh padded to one size and stacked on
    ``device``; a sample's mesh is gathered by integer id."""

    def __init__(self, meshes: dict, v_max=None, f_max=None, device="cuda"):
        """meshes: {name: (verts, faces)} host arrays."""
        self.names = sorted(meshes.keys())
        self.index = {n: i for i, n in enumerate(self.names)}
        v_max = v_max or max(len(meshes[n][0]) for n in self.names)
        f_max = f_max or max(len(meshes[n][1]) for n in self.names)
        vs, fs = zip(*(pad_mesh(np.asarray(meshes[n][0], np.float32),
                                np.asarray(meshes[n][1], np.int32), v_max, f_max)
                       for n in self.names))
        self.verts = torch.as_tensor(np.stack(vs), device=device)   # (M, v_max, 3)
        self.faces = torch.as_tensor(np.stack(fs), device=device)   # (M, f_max, 3)

    def ids_for(self, names):
        return np.asarray([self.index[n] for n in names], np.int64)

    def gather(self, mesh_ids):
        """(B,) ids → ((B, v_max, 3), (B, f_max, 3)) on the bank's device."""
        ids = torch.as_tensor(mesh_ids, device=self.verts.device)
        return self.verts[ids], self.faces[ids]
