# Frozen copy of vtaco_tpu_torch/data/synthetic.py (its generate(), with
# the three helpers of vtaco_tpu_torch/utils/meshio.py it calls), kept so
# that a later change to the port's generator cannot move the training
# cell's inputs. The hand comes from the reference's MANO layer.
"""The synthetic VTacO-shaped split of the training cells: objects
(icospheres and boxes, exact occupancy labels), MANO hands, tactile
images and depth maps, written in the on-disk layout the port's loader
reads (``<root>/<category>/<model>/{points.npz, pointcloud.npz}``,
``<split>.lst``, ``mesh_obj/<obj>.off``, ``depth_origin.txt``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from port_bench.reference.mano import ManoLayer


def write_off(path, verts, faces):
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write("OFF\n%d %d 0\n" % (len(verts), len(faces)))
        for v in verts:
            f.write("%.6f %.6f %.6f\n" % (v[0], v[1], v[2]))
        for face in faces:
            f.write("3 %d %d %d\n" % (face[0], face[1], face[2]))


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Unit icosahedron subdivided n times, projected to the sphere."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f3 in faces:
            a, b, c = int(f3[0]), int(f3[1]), int(f3[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def box(extents=(1.0, 1.0, 1.0)):
    ex, ey, ez = [e / 2 for e in extents]
    verts = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (z-)
            [4, 5, 6], [4, 6, 7],  # top (z+)
            [0, 1, 5], [0, 5, 4],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [1, 2, 6], [1, 6, 5],  # x+
            [3, 0, 4], [3, 4, 7],  # x-
        ],
        np.int32,
    )
    return verts, faces


DEPTH_NEAR = 0.019
DEPTH_FAR = 0.022
DEPTH_REST = 0.0215  # gel at rest: the value stored in depth_origin


def _surface_points(verts, faces, n, rng):
    """Uniform area-weighted surface samples."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    fi = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return (v0[fi] + u * (v1[fi] - v0[fi]) + v * (v2[fi] - v0[fi])).astype(np.float32)


def _make_object(kind, scale, rng):
    if kind == "sphere":
        verts, faces = icosphere(2, radius=scale)
        occ_fn = lambda p: (np.linalg.norm(p, axis=-1) <= scale).astype(np.float32)
    else:
        ext = (scale * 1.6, scale * 1.2, scale * 2.0)
        verts, faces = box(ext)
        half = np.array(ext) / 2
        occ_fn = lambda p: (np.abs(p) <= half).all(-1).astype(np.float32)
    return verts, faces, occ_fn


def generate(out_dir, n_models=4, n_query=10000, n_surface=20000,
             img_h=320, img_w=240, category="000000", seed=0,
             splits=(("train", 0.5), ("val", 0.25), ("test", 0.25))):
    rng = np.random.default_rng(seed)
    data_root = os.path.join(out_dir, "VTacO_YCB")
    mesh_root = os.path.join(out_dir, "VTacO_mesh")
    mesh_dir = os.path.join(mesh_root, "mesh_obj")
    os.makedirs(os.path.join(data_root, category), exist_ok=True)
    os.makedirs(mesh_dir, exist_ok=True)

    depth_origin = np.full(img_h * img_w, DEPTH_REST, np.float64)
    np.savetxt(os.path.join(mesh_root, "depth_origin.txt"), depth_origin)

    mano_layer = ManoLayer(
        center_idx=9, flat_hand_mean=False, ncomps=45, use_pca=False, side="right"
    )

    model_names = []
    for i in range(n_models):
        kind = "sphere" if i % 2 == 0 else "box"
        scale = float(rng.uniform(0.15, 0.3))
        obj_name = f"syn{kind}{i:02d}"
        model_name = f"{obj_name}_0000"
        mdir = os.path.join(data_root, category, model_name)
        os.makedirs(mdir, exist_ok=True)

        verts, faces, occ_fn = _make_object(kind, scale, rng)
        write_off(os.path.join(mesh_dir, obj_name + ".off"), verts, faces)

        # normalized-frame query points + exact occupancy
        points = rng.uniform(-0.55, 0.55, (n_query, 3)).astype(np.float32)
        occupancies = occ_fn(points)
        surface = _surface_points(verts, faces, n_surface, rng)
        points_obj = _surface_points(verts, faces, 2048, rng)
        # near-surface shell just OUTSIDE the object: shrinking the query
        # toward the origin must flip it to occupied (scaling the query
        # OUTWARD tested the subset direction and labeled nothing). A 10%
        # shell keeps the labels present even at small n_query (~2-4% of
        # uniform queries for these object scales).
        contact = (occ_fn(points / 1.1) - occupancies > 0).astype(np.float32)

        # hand supervision: canonical-frame MANO geometry for a random pose
        pose45 = (rng.standard_normal(45) * 0.2).astype(np.float32)
        wrist_pos = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        wrist_rotvec = (rng.standard_normal(3) * 0.3).astype(np.float32)
        mano_param = np.concatenate([wrist_pos, wrist_rotvec, pose45])
        with torch.no_grad():
            hand = mano_layer(torch.as_tensor(
                np.concatenate([np.zeros(3, np.float32), pose45])[None]))
        pc_hand = hand[0][0].numpy()
        wrist_rot = (rng.standard_normal(3) * 0.5).astype(np.float32)

        cam_pos = rng.uniform(-0.2, 0.2, (5, 3)).astype(np.float32)
        cam_rot_deg = rng.uniform(-180, 180, (5, 3)).astype(np.float32)

        np.savez(
            os.path.join(mdir, "points.npz"),
            points=points,
            occupancies=occupancies,
            points_obj=points_obj,
            contact=contact,
            pc_hand=pc_hand,
            mano=mano_param,
            wrist_rot=wrist_rot,
            cam_pos=cam_pos,
            cam_rot=cam_rot_deg,
        )

        # world-frame scan: normalized * 2m + centroid (norm_pc_1 inverse)
        m_scale = float(rng.uniform(0.5, 2.0))
        centroid = rng.uniform(-1, 1, 3).astype(np.float32)
        pc_ply = surface[rng.integers(0, n_surface, 5000)] * (2 * m_scale) + centroid

        touch_success = rng.random(5) > 0.4
        touch_success[0] = True  # at least one touching finger
        imgs = rng.uniform(0, 255, (5, img_h, img_w, 3)).astype(np.float32)
        depth = np.full((5, img_h * img_w), DEPTH_REST, np.float32)
        for f_idx in range(5):
            if touch_success[f_idx]:
                # a contact blob pressed into the gel
                yy, xx = np.mgrid[0:img_h, 0:img_w]
                cy, cx = rng.integers(img_h // 4, 3 * img_h // 4), rng.integers(
                    img_w // 4, 3 * img_w // 4
                )
                r2 = (yy - cy) ** 2 + (xx - cx) ** 2
                blob = np.exp(-r2 / (2 * (min(img_h, img_w) / 6) ** 2))
                d = DEPTH_REST - 0.002 * blob
                depth[f_idx] = d.reshape(-1)

        np.savez(
            os.path.join(mdir, "pointcloud.npz"),
            points=surface,
            normals=surface / np.maximum(
                np.linalg.norm(surface, axis=1, keepdims=True), 1e-6
            ),
            pc_ply=pc_ply.astype(np.float32),
            img=imgs,
            depth=depth,
            touch_success=touch_success,
        )
        model_names.append(model_name)

    # split lists
    n = len(model_names)
    idx = 0
    for split, frac in splits:
        k = max(1, int(round(frac * n)))
        chunk = model_names[idx : idx + k] or model_names[-1:]
        idx += k
        with open(os.path.join(data_root, category, split + ".lst"), "w") as f:
            f.write("\n".join(chunk) + "\n")

    return data_root, mesh_root
