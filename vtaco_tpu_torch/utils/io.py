"""Point-cloud IO helpers (port of vtaco_tpu/utils/io.py): the
reference's src/utils/io.py names over utils.meshio."""

from __future__ import annotations

import os
import tempfile

import numpy as np

from vtaco_tpu_torch.utils import meshio


def export_pointcloud(vertices, out_file, as_text=True):
    """(N, 3) points → an ASCII PLY (``as_text`` is the reference's
    argument; the file is always ASCII)."""
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"export_pointcloud needs (N, 3) points; got {vertices.shape}")
    meshio.write_ply(out_file, vertices.astype(np.float32))


def load_pointcloud(in_file):
    verts, _ = meshio.read_ply(in_file)
    return verts


def read_off(file):
    """(verts, faces) of an OFF file, given by path or as an open file (the
    reference took a handle)."""
    if not hasattr(file, "read"):
        return meshio.read_off(file)
    data = file.read()
    with tempfile.NamedTemporaryFile("w", suffix=".off", delete=False) as f:
        f.write(data if isinstance(data, str) else data.decode())
        path = f.name
    try:
        return meshio.read_off(path)
    finally:
        os.unlink(path)
