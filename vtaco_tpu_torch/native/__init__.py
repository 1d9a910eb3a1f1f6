"""Native C++ host extensions of the port (a copy of
vtaco_tpu/native/__init__.py: the g++ build :40-71 and the facades ``_MC``
:74-220, ``_Geom`` :227-370 and ``_Mise`` :372-422).

  mc   (mc.cpp)   marching cubes over packed occupancy bits, with x-slab
                  threads whose boundary-plane vertices are welded, and
                  the iso-band transfer's scanner and grid reconstruction
                  (generate/band.py);
  geom (geom.cpp) KD-tree nearest neighbours, exact winding numbers, the
                  OFF/OBJ reader and the lattice encode of eval_points;
  mise (mise.cpp) the MISE bookkeeping engine.

Each is compiled by g++ at first use into ``vtaco_tpu_torch/_build/``
(listed in .gitignore) with ``CXX_FLAGS``: ``-O3 -std=c++17 -shared -fPIC
-pthread -mavx2 -ffp-contract=off``. ``-mavx2`` turns on mc.cpp's
vectorized occupancy packing (its ``__AVX2__`` path; every x86-64 host of
an H100 has AVX2) without tying the library to the building host's CPU,
as ``-march=native`` would. ``-ffp-contract=off`` keeps g++ from fusing
``a*b + c`` into one FMA, so that the lattice encode's ``p*inv + half``
rounds as numpy's two operations do on any flags. The library's name
carries the hash of the flags, of the source and of every file a
generated header comes from (mc's tables header from the port's
generate/mc_tables.py, written into the build directory, never into the
package), so a change to any of them builds anew and a stale library is
never loaded. A failed build or load raises: there is no numpy fallback
on the serving paths.

Left unbound: geom.cpp's window sort
(``vtaco_window_keys_sort``, ``vtaco_window_permute``): the port sorts its
window route's points on the card (generate/generator.py, _window_plan).

One lock serializes the build and the load: the first calls into an
extension may come from several ``host_map`` worker threads at once, and
two g++ runs writing one library, or a load of a half-written file, must
not happen. Files are written under a name of their own and renamed into
place, so processes that build at once never read a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-mavx2",
             "-ffp-contract=off")

_BUILD_LOCK = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _write_tables_header(path):
    """mc_tables.h, MC_TRI_TABLE[256][16], from generate/mc_tables.py."""
    from vtaco_tpu_torch.generate.mc_tables import TRI_TABLE

    lines = ["// generated from vtaco_tpu_torch/generate/mc_tables.py: do not edit",
             "#pragma once", "#include <cstdint>",
             "static const int16_t MC_TRI_TABLE[256][16] = {"]
    lines += ["  {" + ", ".join(str(int(v)) for v in row) + "}," for row in TRI_TABLE]
    lines.append("};")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


# name → (files its generated headers come from, the writer of each header)
_HEADERS = {"mc": ((os.path.join(_PKG, "generate", "mc_tables.py"),),
                   {"mc_tables.h": _write_tables_header})}


def _digest(name):
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in (os.path.join(_DIR, f"{name}.cpp"), *_HEADERS.get(name, ((), {}))[0]):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_and_load(name: str) -> ctypes.CDLL:
    """native/<name>.cpp's library, compiled first if missing. Call under
    _BUILD_LOCK. Raises RuntimeError when g++ is missing or fails."""
    digest = _digest(name)
    target = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(target):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        include = []
        headers = _HEADERS.get(name, ((), {}))[1]
        if headers:
            inc = os.path.join(BUILD_DIR, f"include_{name}_{digest}")
            os.makedirs(inc, exist_ok=True)
            for header, write in headers.items():
                write(os.path.join(inc, header))
            include = ["-I", inc]
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, *include, os.path.join(_DIR, f"{name}.cpp"),
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stderr}")
        os.replace(tmp, target)
    return ctypes.CDLL(target)


class _Lib:
    """A facade that builds and loads its library at first use."""

    def __init__(self):
        self._lib = None

    def _ensure(self):
        if self._lib is None:
            with _BUILD_LOCK:
                if self._lib is None:
                    self._lib = self._load()
        return self._lib


def _ptr(a, ctype=_f32p):
    return a.ctypes.data_as(ctype)


def _rows3(a, dtype, what):
    """a as a C-contiguous (n, 3) array of dtype; raises on another shape."""
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{what} must be (n, 3); got shape {a.shape}")
    return a


class _MC(_Lib):
    """ctypes facade over the marching-cubes extractor (mc.cpp)."""

    @staticmethod
    def _load():
        vp, i64, c_int, c_float = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib = build_and_load("mc")
        lib.vtaco_mc_run_t.restype = vp
        lib.vtaco_mc_run_t.argtypes = [_f32p, c_int, c_int, c_int, c_float, c_int]
        lib.vtaco_mc_run_band.restype = vp
        lib.vtaco_mc_run_band.argtypes = [_u8p, _f32p, i64, c_int, c_int, c_int, c_float,
                                          c_int]
        lib.vtaco_band_reconstruct.restype = i64
        lib.vtaco_band_reconstruct.argtypes = [_u8p, _f32p, i64, c_int, c_int, c_int,
                                               c_float, _f32p]
        lib.vtaco_mc_num_verts.restype = i64
        lib.vtaco_mc_num_verts.argtypes = [vp]
        lib.vtaco_mc_num_faces.restype = i64
        lib.vtaco_mc_num_faces.argtypes = [vp]
        lib.vtaco_mc_copy.argtypes = [vp, _f32p, _i32p]
        lib.vtaco_mc_free.argtypes = [vp]
        return lib

    def marching_cubes(self, volume, level, threads=None):
        """The ``level`` isosurface of a (nx, ny, nz) field: verts (V, 3)
        float32 in voxel units, faces (F, 3) int32, in the scan's order.
        ``threads=None`` takes one thread below 128³ points and
        min(cpu_count, 8) x-slabs from 128³ up, as the JAX package does;
        vertices on the slabs' boundary planes are welded, so any thread
        count gives the same mesh, and threads=1 the serial order."""
        lib = self._ensure()
        vol = np.ascontiguousarray(volume, np.float32)
        if vol.ndim != 3:
            raise ValueError(f"marching_cubes needs a 3-d volume; got shape {vol.shape}")
        nx, ny, nz = vol.shape
        if threads is None:
            threads = 1
            if nx * ny * nz >= 128 ** 3:
                threads = max(1, min(os.cpu_count() or 1, 8))
        handle = lib.vtaco_mc_run_t(_ptr(vol), nx, ny, nz, ctypes.c_float(level),
                                    int(threads))
        return self._copy_result(handle)

    @staticmethod
    def _band_args(nx, count, packed, vals):
        packed = np.ascontiguousarray(packed, np.uint8)
        vals = np.ascontiguousarray(vals, np.float32)
        if packed.size * 8 < nx ** 3 or not 0 <= int(count) <= vals.size:
            raise ValueError(f"band payload ({packed.size} bytes of bits, {vals.size} "
                             f"values) cannot hold {count} values of a {nx}^3 grid")
        return packed, vals

    def marching_cubes_band(self, nx, level, count, packed, vals, threads=1):
        """Marching cubes on a band payload (generate/band.py) with no
        grid: the mesh of band_reconstruct plus marching_cubes. Raises
        ValueError when the mask's active count is not ``count``."""
        lib = self._ensure()
        packed, vals = self._band_args(nx, count, packed, vals)
        handle = lib.vtaco_mc_run_band(_ptr(packed, _u8p), _ptr(vals), int(count), nx, nx,
                                       nx, ctypes.c_float(level), int(threads))
        if not handle:
            raise ValueError(f"band payload inconsistent: the mask's active count is "
                             f"not {count}")
        return self._copy_result(handle)

    def band_reconstruct(self, nx, level, count, packed, vals):
        """The (nx, nx, nx) float32 grid of a band payload: the values at
        the active vertices, level ± 1 elsewhere. Raises ValueError when
        the mask's active count is not ``count``."""
        lib = self._ensure()
        packed, vals = self._band_args(nx, count, packed, vals)
        out = np.empty((nx, nx, nx), np.float32)
        k = lib.vtaco_band_reconstruct(_ptr(packed, _u8p), _ptr(vals), int(count), nx, nx,
                                       nx, ctypes.c_float(level), _ptr(out))
        if k != count:
            raise ValueError(f"band payload inconsistent: mask implies {k} active "
                             f"vertices, device counted {count}")
        return out

    def _copy_result(self, handle):
        lib = self._lib
        try:
            verts = np.empty((lib.vtaco_mc_num_verts(handle), 3), np.float32)
            faces = np.empty((lib.vtaco_mc_num_faces(handle), 3), np.int32)
            if len(verts):
                lib.vtaco_mc_copy(handle, _ptr(verts), _ptr(faces, _i32p))
        finally:
            lib.vtaco_mc_free(handle)
        return verts, faces


class _Geom(_Lib):
    """ctypes facade over the geometry extension (geom.cpp)."""

    @staticmethod
    def _load():
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib = build_and_load("geom")
        lib.vtaco_kdtree_build.restype = vp
        lib.vtaco_kdtree_build.argtypes = [_f32p, i64]
        lib.vtaco_kdtree_query.argtypes = [vp, _f32p, i64, _f32p, _i32p]
        lib.vtaco_kdtree_free.argtypes = [vp]
        lib.vtaco_winding.argtypes = [_f32p, i64, _i32p, i64, _f32p, i64, _f32p]
        lib.vtaco_lattice_encode.restype = ctypes.c_float
        lib.vtaco_lattice_encode.argtypes = [_f32p, i64, ctypes.c_float, ctypes.c_float,
                                             vp, i64, ctypes.c_int]
        lib.vtaco_read_mesh.restype = vp
        lib.vtaco_read_mesh.argtypes = [ctypes.c_char_p]
        lib.vtaco_mesh_num_verts.restype = i64
        lib.vtaco_mesh_num_verts.argtypes = [vp]
        lib.vtaco_mesh_num_faces.restype = i64
        lib.vtaco_mesh_num_faces.argtypes = [vp]
        lib.vtaco_mesh_copy.argtypes = [vp, _f32p, _i32p]
        lib.vtaco_mesh_free.argtypes = [vp]
        return lib

    def nearest(self, points, queries):
        """Each query's nearest point: (M,) float32 squared distances and
        (M,) int32 indices into ``points`` (-1 and inf when it is empty)."""
        lib = self._ensure()
        pts = _rows3(points, np.float32, "points")
        q = _rows3(queries, np.float32, "queries")
        tree = lib.vtaco_kdtree_build(_ptr(pts), len(pts))
        try:
            d2 = np.empty(len(q), np.float32)
            idx = np.empty(len(q), np.int32)
            lib.vtaco_kdtree_query(tree, _ptr(q), len(q), _ptr(d2), _ptr(idx, _i32p))
        finally:
            lib.vtaco_kdtree_free(tree)
        return d2, idx

    def winding_number(self, verts, faces, points):
        """Exact generalized winding numbers of (P, 3) points, (P,) float32,
        accumulated in float64. Faces with an index outside the vertices
        add nothing."""
        lib = self._ensure()
        v = _rows3(verts, np.float32, "verts")
        f = _rows3(faces, np.int32, "faces")
        p = _rows3(points, np.float32, "points")
        out = np.empty(len(p), np.float32)
        lib.vtaco_winding(_ptr(v), len(v), _ptr(f, _i32p), len(f), _ptr(p), len(p),
                          _ptr(out))
        return out

    def lattice_encode(self, points, box, reso, npad):
        """(N, 3) float32 world coords → ((3, npad) lattice nodes
        ``rint((p/box + 0.5)·reso)``, uint8 for reso ≤ 255 else int16, zero
        past N; the largest residual |w − rint(w)| in lattice units), in
        one pass. NaN, inf and coords off [0, reso] set the residual to
        1e9, so that the caller rejects the encoding."""
        lib = self._ensure()
        p = _rows3(points, np.float32, "points")
        if npad < len(p):
            raise ValueError(f"npad {npad} is below the {len(p)} points")
        out = np.zeros((3, npad), np.uint8 if reso <= 255 else np.int16)
        resid = lib.vtaco_lattice_encode(_ptr(p), len(p), ctypes.c_float(box),
                                         ctypes.c_float(reso), out.ctypes.data_as(ctypes.c_void_p),
                                         npad, int(reso <= 255))
        return out, float(resid)

    def read_triangle_mesh(self, path):
        """(V, 3) float32 verts and (F, 3) int32 faces of an OFF or OBJ
        file (polygons fan-triangulated, comments anywhere in an OFF)."""
        lib = self._ensure()
        handle = lib.vtaco_read_mesh(os.fsencode(path))
        if not handle:
            raise FileNotFoundError(path)
        try:
            verts = np.empty((lib.vtaco_mesh_num_verts(handle), 3), np.float32)
            faces = np.empty((lib.vtaco_mesh_num_faces(handle), 3), np.int32)
            lib.vtaco_mesh_copy(handle, _ptr(verts), _ptr(faces, _i32p))
        finally:
            lib.vtaco_mesh_free(handle)
        return verts, faces


class _Mise(_Lib):
    """ctypes facade over the MISE bookkeeping engine (mise.cpp): one
    handle per object under refinement; generate/mise.py's
    MultiGridExtractorNative wraps it."""

    @staticmethod
    def _load():
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib = build_and_load("mise")
        lib.vtaco_mise_new.restype = vp
        lib.vtaco_mise_new.argtypes = [i64, ctypes.c_float, ctypes.c_int]
        lib.vtaco_mise_free.argtypes = [vp]
        lib.vtaco_mise_resolution.restype = i64
        lib.vtaco_mise_resolution.argtypes = [vp]
        lib.vtaco_mise_query_count.restype = i64
        lib.vtaco_mise_query_count.argtypes = [vp]
        lib.vtaco_mise_query_copy.argtypes = [vp, _i32p]
        lib.vtaco_mise_query_copy_cn.restype = i64
        lib.vtaco_mise_query_copy_cn.argtypes = [vp, ctypes.POINTER(ctypes.c_int16), i64]
        lib.vtaco_mise_update.argtypes = [vp, _i32p, _f32p, i64]
        lib.vtaco_mise_update_queried.argtypes = [vp, _f32p]
        lib.vtaco_mise_increase.argtypes = [vp]
        lib.vtaco_mise_values.argtypes = [vp, _f32p]
        lib.vtaco_mise_values_ptr.restype = vp
        lib.vtaco_mise_values_ptr.argtypes = [vp]
        lib.vtaco_mise_known.argtypes = [vp, ctypes.POINTER(ctypes.c_uint8)]
        return lib


mc = _MC()
geom = _Geom()
mise = _Mise()
