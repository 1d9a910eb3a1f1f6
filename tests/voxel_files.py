"""``model.binvox`` files for a synthetic set (the repository holds no
voxel data), shared by tests/families.py, tests/test_torch_cuda.py and
chip_smoke.py. Imports no JAX."""

import os

import numpy as np

from vtaco_tpu_torch.data import binvox_rw


def write_voxels(data_root, res=32, name="model.binvox"):
    """Each model's ``name`` (binvox_rw.write): the res³ cells of
    [-0.5, 0.5]³ that hold an occupied query point of its points.npz."""
    for cat in sorted(os.listdir(data_root)):
        cdir = os.path.join(data_root, cat)
        if not os.path.isdir(cdir):
            continue
        for model in sorted(os.listdir(cdir)):
            mdir = os.path.join(cdir, model)
            if not os.path.isdir(mdir):
                continue
            d = np.load(os.path.join(mdir, "points.npz"))
            pts = d["points"][d["occupancies"] > 0.5]
            vox = np.zeros((res,) * 3, bool)
            ijk = np.clip(np.floor((pts + 0.5) * res).astype(np.int64), 0, res - 1)
            vox[tuple(ijk.T)] = True
            with open(os.path.join(mdir, name), "wb") as f:
                binvox_rw.write(binvox_rw.Voxels(vox, [res] * 3, [0.0] * 3, 1.0, "xyz"), f)
