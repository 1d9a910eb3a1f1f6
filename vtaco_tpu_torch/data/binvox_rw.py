"""Minimal .binvox reader/writer (port of vtaco_tpu/data/binvox_rw.py:
``Voxels``, ``read_header``, ``read_as_3d_array``, ``write``; byte for
byte the same reads and writes).

The binvox format (Patrick Min's tool): an ASCII header
(``#binvox 1``, ``dim D D D``, ``translate x y z``, ``scale s``, ``data``)
followed by byte-pair run-length-encoded voxel occupancy in x→z→y order.
"""

from __future__ import annotations

import numpy as np


class Voxels:
    def __init__(self, data, dims, translate, scale, axis_order="xzy"):
        self.data = data
        self.dims = dims
        self.translate = translate
        self.scale = scale
        self.axis_order = axis_order


def read_header(fp):
    line = fp.readline().strip()
    if not line.startswith(b"#binvox"):
        raise IOError("not a binvox file")
    dims = translate = scale = None
    while True:
        line = fp.readline().strip()
        if line.startswith(b"data"):
            break
        tok = line.split()
        if tok[0] == b"dim":
            dims = [int(x) for x in tok[1:]]
        elif tok[0] == b"translate":
            translate = [float(x) for x in tok[1:]]
        elif tok[0] == b"scale":
            scale = float(tok[1])
    return dims, translate, scale


def read_as_3d_array(fp, fix_coords=True):
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2].astype(np.int64)
    data = np.repeat(values, counts).astype(bool)
    data = data.reshape(dims)
    if fix_coords:
        data = np.transpose(data, (0, 2, 1))  # binvox stores x, z, y
        axis_order = "xyz"
    else:
        axis_order = "xzy"
    return Voxels(data, dims, translate, scale, axis_order)


def write(voxels: Voxels, fp):
    data = voxels.data
    if voxels.axis_order == "xyz":
        data = np.transpose(data, (0, 2, 1))
    fp.write(b"#binvox 1\n")
    fp.write(("dim " + " ".join(map(str, voxels.dims)) + "\n").encode())
    fp.write(("translate " + " ".join(map(str, voxels.translate)) + "\n").encode())
    fp.write(f"scale {voxels.scale}\n".encode())
    fp.write(b"data\n")
    flat = data.ravel().astype(np.uint8)
    # RLE with max run 255
    out = bytearray()
    i = 0
    n = len(flat)
    while i < n:
        v = flat[i]
        run = 1
        while i + run < n and flat[i + run] == v and run < 255:
            run += 1
        out.append(int(v))
        out.append(run)
        i += run
    fp.write(bytes(out))
