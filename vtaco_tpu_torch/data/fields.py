"""npz data fields with the reference's on-disk contract (port of
vtaco_tpu/data/fields.py:25-147: Field, IndexField, PointsField,
PointCloudField).

Each field's ``load(model_path, idx, category)`` returns a dict whose
``None`` key is the field's main array; the dataset flattens the other
keys into ``'<field>.<key>'`` batch entries. Tactile images are returned
channel-last (5, H, W, 3). ``legacy_image_scale=True`` keeps the
reference's double division by 255 (images end in [0, 1/255]), which its
trained weights expect.
"""

from __future__ import annotations

import os

import numpy as np


class Field:
    def load(self, model_path, idx, category):
        raise NotImplementedError


class IndexField(Field):
    """The dataset index."""

    def load(self, model_path, idx, category):
        return idx


def _load(model_path, file_name, multi_files):
    """The field's npz file as a dict of arrays."""
    path = os.path.join(model_path, file_name)
    if multi_files is not None:
        num = np.random.randint(multi_files)
        path = os.path.join(path, "%s_%02d.npz" % (file_name, num))
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


class PointsField(Field):
    """Query points with occupancy and the hand and camera supervision:
    points, occupancies (optionally packed bits), points_obj (ground-truth
    surface points, shuffled, the first 2048), contact, pc_hand, mano
    (51-d), wrist_rot, cam_pos, cam_rot (degrees → radians)."""

    def __init__(self, file_name, transform=None, unpackbits=False, multi_files=None):
        self.file_name = file_name
        self.transform = transform
        self.unpackbits = unpackbits
        self.multi_files = multi_files

    def load(self, model_path, idx, category):
        name = model_path.split("/")[-1][:-5]
        d = _load(model_path, self.file_name, self.multi_files)

        points = d["points"]
        if points.dtype == np.float16:  # break symmetry
            points = points.astype(np.float32)
            points += 1e-4 * np.random.randn(*points.shape)
        occ = d["occupancies"]
        if self.unpackbits:
            occ = np.unpackbits(occ)[: points.shape[0]]
        points_obj = d["points_obj"].astype(np.float32)
        np.random.shuffle(points_obj)

        data = {
            None: points.astype(np.float32),
            "name": name,
            "occ": occ.astype(np.float32),
            "points_obj": points_obj[:2048],
            "contact": d["contact"].astype(np.float32),
            "pc_hand": d["pc_hand"].astype(np.float32),
            "mano": d["mano"].astype(np.float32),
            "wrist": d["wrist_rot"].astype(np.float32),
            "cam_pos": d["cam_pos"].astype(np.float32),
            "cam_rot": d["cam_rot"].astype(np.float32) / 180 * np.pi,
        }
        if self.transform is not None:
            data = self.transform(data)
        return data


class PointCloudField(Field):
    """Input point cloud with the tactile images and depths: points,
    normals, pc_ply (the object scan), img (5 RGB images with Gaussian
    noise of ``noise_std``), depth (5 × H*W), touch_success (5 flags)."""

    def __init__(self, file_name, transform=None, multi_files=None,
                 legacy_image_scale=True, noise_std=7.0):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files
        self.legacy_image_scale = legacy_image_scale
        self.noise_std = noise_std

    def load(self, model_path, idx, category):
        d = _load(model_path, self.file_name, self.multi_files)

        images = np.asarray(d["img"], np.float32)
        if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
            images = images.transpose(0, 2, 3, 1)  # (5, 3, H, W) → (5, H, W, 3)
        noise = np.random.normal(0, self.noise_std, images.shape)
        images = np.clip(images + noise, 0, 255) / 255
        if self.legacy_image_scale:
            images = images / 255

        data = {
            None: d["points"].astype(np.float32),
            "normals": d["normals"].astype(np.float32),
            "pc_ply": d["pc_ply"].astype(np.float32),
            "touch_success": np.asarray(d["touch_success"]),
            "img": images.astype(np.float32),
            "depth": d["depth"].astype(np.float32),
        }
        if self.transform is not None:
            data = self.transform(data)
        return data
