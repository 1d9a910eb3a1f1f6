"""npz data fields with the reference's on-disk contract (port of
vtaco_tpu/data/fields.py:25-270: Field, IndexField, PointsField,
PointCloudField, PartialPointCloudField, the crop fields
PatchPointsField and PatchPointCloudField, and VoxelsField :280-296).

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

from vtaco_tpu_torch.ops.geometry import coord2index, normalize_coord


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


class PartialPointCloudField(Field):
    """A partial cloud: the points within a random length (between
    ``part_ratio`` and all of the extent) from the low end of a random
    axis, with their normals."""

    def __init__(self, file_name, transform=None, multi_files=None, part_ratio=0.7):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files
        self.part_ratio = part_ratio

    def load(self, model_path, idx, category):
        d = _load(model_path, self.file_name, self.multi_files)
        points = d["points"].astype(np.float32)
        normals = d["normals"].astype(np.float32)
        side = np.random.randint(3)
        xb = [points[:, side].min(), points[:, side].max()]
        length = np.random.uniform(self.part_ratio * (xb[1] - xb[0]), xb[1] - xb[0])
        ind = (points[:, side] - xb[0]) <= length
        data = {None: points[ind], "normals": normals[ind]}
        if self.transform is not None:
            data = self.transform(data)
        return data


class PatchPointsField(Field):
    """Crop query points: the points inside the crop's query volume with
    their occupancies (and zero contact labels, for the subsampling), and
    ``normalized``: {plane: the points' coords in the crop's input volume}.
    ``vol`` is the dataset's crop volume dict (Shapes3dDataset.get_vol_info)."""

    def __init__(self, file_name, transform=None, unpackbits=False, multi_files=None):
        self.file_name = file_name
        self.transform = transform
        self.unpackbits = unpackbits
        self.multi_files = multi_files

    def load(self, model_path, idx, vol):
        d = _load(model_path, self.file_name, self.multi_files)
        points = d["points"]
        if points.dtype == np.float16:
            points = points.astype(np.float32)
            points += 1e-4 * np.random.randn(*points.shape)
        occ = d["occupancies"]
        if self.unpackbits:
            occ = np.unpackbits(occ)[: points.shape[0]]
        occ = occ.astype(np.float32)
        ind = np.ones(len(points), bool)
        for i in range(3):
            ind &= ((points[:, i] >= vol["query_vol"][0][i])
                    & (points[:, i] <= vol["query_vol"][1][i]))
        data = {None: points[ind].astype(np.float32), "occ": occ[ind]}
        if self.transform is not None:
            data.setdefault("contact", np.zeros_like(data["occ"]))
            data = self.transform(data)
        data["normalized"] = {key: normalize_coord(data[None].copy(), vol["input_vol"],
                                                   plane=key)
                              for key in vol["plane_type"]}
        return data


class PatchPointCloudField(Field):
    """Crop input cloud: points outside the crop's input volume are zeroed,
    flagged in ``mask`` and sent to the overflow cell reso^k of every
    field's scatter index ``ind`` ({plane: (1, N)}), which the crop
    encoder pools into and drops."""

    def __init__(self, file_name, transform=None, transform_add_noise=None,
                 multi_files=None):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files

    def load(self, model_path, idx, vol):
        d = _load(model_path, self.file_name, self.multi_files)
        points = d["points"].astype(np.float32)
        data = {None: points, "normals": d["normals"].astype(np.float32)}
        if self.transform is not None:
            data = self.transform(data)
            points = data[None]
        inside = np.ones(len(points), bool)
        for i in range(3):
            inside &= ((points[:, i] >= vol["input_vol"][0][i])
                       & (points[:, i] <= vol["input_vol"][1][i]))
        mask = ~inside
        data["mask"] = mask
        points[mask] = 0.0
        index = {}
        for key in vol["plane_type"]:
            index[key] = coord2index(points.copy(), vol["input_vol"], reso=vol["reso"],
                                     plane=key)
            index[key][:, mask] = vol["reso"] ** (3 if key == "grid" else 2)
        data["ind"] = index
        return data


class VoxelsField(Field):
    """A .binvox occupancy grid (data/binvox_rw.py, axes fixed to x, y, z)
    as float32 (D, H, W)."""

    def __init__(self, file_name, transform=None):
        self.file_name = file_name
        self.transform = transform

    def load(self, model_path, idx, category):
        from vtaco_tpu_torch.data import binvox_rw

        with open(os.path.join(model_path, self.file_name), "rb") as f:
            voxels = binvox_rw.read_as_3d_array(f).data.astype(np.float32)
        if self.transform is not None:
            voxels = self.transform(voxels)
        return voxels
