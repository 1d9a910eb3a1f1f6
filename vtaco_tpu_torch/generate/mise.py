"""MISE-style multi-resolution isosurface extraction (port of
vtaco_tpu/generate/mise.py: ``host_map`` :28-42, the grid helpers :45-72,
``MultiGridExtractorNumpy`` :89-162, ``MultiGridExtractorNative``
:165-297, ``DelaunayMeshExtractor`` :314-400, ``multires_decode`` :402-500
and ``multires_decode_batched`` :503-658).

A grid of occupancy values is kept where only the points next to
"active" (boundary-possible) voxels are evaluated; the resolution doubles
and the step repeats. The coarse level is a dense decode at
(resolution0+1)³; each refinement level decodes its lattice points in one
call through the gather route (corner gather + K1/K2 on the card). The
batched form refines B objects in lockstep: one batched dense decode for
the coarse level, then one batched K2 launch per level for all objects'
points (Generator3D.decode_points_batched).

The bookkeeping runs in the native engine (native/mise.cpp);
``MultiGridExtractorNumpy`` is its plain reference, with the same query
order and values. A failed build of the engine raises.
"""

from __future__ import annotations

import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from vtaco_tpu_torch import native

# Per-object host-work thread count of the batched serving paths; None
# means os.cpu_count(). The native engine holds no state shared between
# handles (its page pool is behind a mutex) and ctypes releases the GIL
# around every foreign call, so B objects' grid passes overlap on a
# multi-core host.
HOST_THREADS = None


def host_map(fn, *seqs):
    """``map(fn, *seqs)`` over per-object host work, on up to
    HOST_THREADS threads; serial when one worker is all that helps."""
    n = min(len(s) for s in seqs)
    w = min(HOST_THREADS or os.cpu_count() or 1, n)
    if w <= 1:
        return [fn(*args) for args in zip(*seqs)]
    with ThreadPoolExecutor(max_workers=w) as ex:
        return list(ex.map(fn, *seqs))


def upsample3d_nn(x):
    """Nearest 2x upsampling (src/utils/mesh.py:87-101)."""
    return np.repeat(np.repeat(np.repeat(x, 2, 0), 2, 1), 2, 2)


def _voxel_known(value_known):
    """True where all 8 corner values of a voxel are known."""
    k = value_known
    return (
        k[:-1, :-1, :-1] & k[:-1, :-1, 1:] & k[:-1, 1:, :-1] & k[:-1, 1:, 1:]
        & k[1:, :-1, :-1] & k[1:, :-1, 1:] & k[1:, 1:, :-1] & k[1:, 1:, 1:]
    )


def _voxel_boundary(occ):
    """True where a voxel's 8 corner occupancies disagree (surface voxel)."""
    o = occ
    corners = [
        o[:-1, :-1, :-1], o[:-1, :-1, 1:], o[:-1, 1:, :-1], o[:-1, 1:, 1:],
        o[1:, :-1, :-1], o[1:, :-1, 1:], o[1:, 1:, :-1], o[1:, 1:, 1:],
    ]
    any_occ = corners[0].copy()
    all_occ = corners[0].copy()
    for c in corners[1:]:
        any_occ |= c
        all_occ &= c
    return any_occ & ~all_occ


class _EngineView(np.ndarray):
    """ndarray view over the native engine's memory; ``_keepalive`` pins
    the owning extractor (and so the buffer) for the view's lifetime. The
    pin also lives on the underlying ctypes buffer, so conversions that
    drop the subclass (np.asarray, np.ascontiguousarray) still reach it
    through their ``.base`` chain."""

    _keepalive = None

    def __array_finalize__(self, obj):
        self._keepalive = getattr(obj, "_keepalive", None)


class MultiGridExtractorNumpy:
    """Active-voxel refinement bookkeeping in numpy: the plain reference
    of the native engine, with the protocol of the reference
    (src/utils/mesh.py:7-84): ``query()`` gives the integer grid points
    that need a value, ``update(points, values)`` records them and
    refreshes the voxels' activity, ``increase_resolution()`` doubles the
    grid, keeping the known values. The reference's values are distances
    (occupied where ``values < threshold``); occupancy logits take
    ``invert=False`` (``values >= threshold``)."""

    def __init__(self, resolution0, threshold, invert=True):
        self.resolution = resolution0
        self.threshold = threshold
        self.invert = invert
        shape_values = (resolution0 + 1,) * 3
        self.values = np.empty(shape_values)
        self.value_known = np.full(shape_values, False)
        self.voxel_active = np.full((resolution0,) * 3, True)

    def query(self):
        idx = np.where(~self.value_known & self.value_active)
        return np.stack(idx, axis=-1)

    def update(self, points, values):
        i0, i1, i2 = points.T
        self.values[i0, i1, i2] = values
        self.value_known[i0, i1, i2] = True
        self.voxel_active = ~self.voxel_empty

    def increase_resolution(self):
        self.resolution = 2 * self.resolution
        shape_values = (self.resolution + 1,) * 3
        value_known = np.full(shape_values, False)
        value_known[::2, ::2, ::2] = self.value_known
        self.values = upsample3d_nn(self.values)[:-1, :-1, :-1]
        self.value_known = value_known
        self.voxel_active = upsample3d_nn(self.voxel_active)

    @property
    def occupancies(self):
        if self.invert:
            return self.values < self.threshold
        return self.values >= self.threshold

    @property
    def values_view(self):
        """The value grid (the native engine's zero-copy view; here the
        array itself)."""
        return self.values

    @property
    def value_active(self):
        va = np.full(self.values.shape, False)
        a = self.voxel_active
        for sx in (slice(None, -1), slice(1, None)):
            for sy in (slice(None, -1), slice(1, None)):
                for sz in (slice(None, -1), slice(1, None)):
                    va[sx, sy, sz] |= a
        return va

    @property
    def voxel_known(self):
        return _voxel_known(self.value_known)

    @property
    def voxel_empty(self):
        return ~_voxel_boundary(self.occupancies)


class MultiGridExtractorNative:
    """The MultiGridExtractor protocol on the native engine
    (native/mise.cpp): the same query order (numpy.where C order) and
    values as :class:`MultiGridExtractorNumpy` (every value the protocol
    holds is an f32 decode output or a copy of one, so the f32 grid equals
    the numpy class's f64 grid). For the serving paths it adds
    ``update_queried(values)``, values in query order without passing the
    points back, and ``query_cn(npad)``, the (3, npad) int16 layout of the
    gather route with the pad slots repeating the last real point."""

    def __init__(self, resolution0, threshold, invert=True):
        self._lib = native.mise._ensure()
        self._ct = ctypes
        self.threshold = float(threshold)
        self.invert = bool(invert)
        self._h = self._lib.vtaco_mise_new(
            int(resolution0), ctypes.c_float(self.threshold), int(self.invert))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vtaco_mise_free(h)
            self._h = None

    def _ptr(self, a, ctype):
        return a.ctypes.data_as(self._ct.POINTER(ctype))

    @property
    def resolution(self):
        return int(self._lib.vtaco_mise_resolution(self._h))

    def query(self):
        n = self._lib.vtaco_mise_query_count(self._h)
        out = np.empty((n, 3), np.int32)
        if n:
            self._lib.vtaco_mise_query_copy(self._h, self._ptr(out, self._ct.c_int32))
        return out

    def query_cn(self, npad, out=None):
        """The pending points as a (3, npad) int16 channels-first array and
        their count. ``out``: a C-contiguous (3, npad) int16 array to
        write into; the engine fills every slot, the pad tail included."""
        if out is None:
            out = np.zeros((3, npad), np.int16)
        if not (out.flags.c_contiguous and out.dtype == np.int16
                and out.shape == (3, npad)):
            raise ValueError("query_cn writes a C-contiguous (3, npad) int16 array")
        n = self._lib.vtaco_mise_query_copy_cn(self._h, self._ptr(out, self._ct.c_int16),
                                               npad)
        return out, int(n)

    @property
    def query_count(self):
        """Number of pending query points (no copy)."""
        return int(self._lib.vtaco_mise_query_count(self._h))

    def update(self, points, values):
        pts = np.ascontiguousarray(points, np.int32)
        vals = np.ascontiguousarray(values, np.float32)
        # the engine writes at these nodes unchecked
        if pts.shape != (len(vals), 3) or vals.ndim != 1 or (
                len(pts) and (pts.min() < 0 or pts.max() > self.resolution)):
            raise ValueError(f"update takes (n, 3) nodes of the {self.resolution}³ grid "
                             f"and (n,) values; got {pts.shape} and {vals.shape}")
        self._lib.vtaco_mise_update(self._h, self._ptr(pts, self._ct.c_int32),
                                    self._ptr(vals, self._ct.c_float), len(vals))

    def update_queried(self, values):
        """Record values for the last query's points, in query order."""
        vals = np.ascontiguousarray(values, np.float32)
        if vals.shape != (self.query_count,):
            raise ValueError(f"update_queried takes one value per pending point "
                             f"({self.query_count}); got {vals.shape}")
        self._lib.vtaco_mise_update_queried(self._h, self._ptr(vals, self._ct.c_float))

    def increase_resolution(self):
        self._lib.vtaco_mise_increase(self._h)

    @property
    def values(self):
        n = self.resolution + 1
        out = np.empty((n, n, n), np.float32)
        self._lib.vtaco_mise_values(self._h, self._ptr(out, self._ct.c_float))
        return out

    @property
    def values_view(self):
        """Read-only view of the engine's value grid, without the (R+1)³
        copy (540 MB of float32 at 512³). The view pins this extractor
        alive but is invalidated by a later ``increase_resolution`` or
        ``update``: take it last, hand it to marching cubes, drop it."""
        n = self.resolution + 1
        ptr = self._lib.vtaco_mise_values_ptr(self._h)
        buf = (self._ct.c_float * (n * n * n)).from_address(ptr)
        buf._keepalive = self
        view = np.frombuffer(buf, np.float32).reshape(n, n, n).view(_EngineView)
        view._keepalive = self
        view.flags.writeable = False
        return view

    @property
    def value_known(self):
        n = self.resolution + 1
        out = np.empty((n, n, n), np.uint8)
        self._lib.vtaco_mise_known(self._h, self._ptr(out, self._ct.c_uint8))
        return out.astype(bool)

    @property
    def occupancies(self):
        if self.invert:
            return self.values < self.threshold
        return self.values >= self.threshold


MultiGridExtractor = MultiGridExtractorNative


class DelaunayMeshExtractor:
    """Mesh extraction from scattered implicit-function samples via
    Delaunay tetrahedralization (scipy), on the host.

    Counterpart of src/utils/mesh.py:104-199: simplices whose corners mix
    occupied/unoccupied are "active"; each crossing edge is subdivided at
    the linear iso-crossing; triangles are oriented by the sign of the
    tetrahedron volume against the reference corner's occupancy.
    """

    def __init__(self, points, values, threshold=0.0):
        from scipy.spatial import Delaunay

        self.points = np.asarray(points, np.float64)
        self.values = np.asarray(values, np.float64)
        self.threshold = threshold
        self.delaunay = Delaunay(self.points)

    def active_simplices(self):
        occ = self.values >= self.threshold
        simplices = self.delaunay.simplices
        s_occ = occ[simplices]
        active = np.any(s_occ, axis=1) & np.any(~s_occ, axis=1)
        return simplices[active]

    def update(self, points, values, reduce_to_active=True):
        from scipy.spatial import Delaunay

        if reduce_to_active:
            keep = np.unique(self.active_simplices().ravel())
            self.points = self.points[keep]
            self.values = self.values[keep]
        self.points = np.concatenate([self.points, points], axis=0)
        self.values = np.concatenate([self.values, values], axis=0)
        self.delaunay = Delaunay(self.points)

    def query(self, size):
        """Volume-weighted random samples inside active simplices
        (src/utils/mesh.py:183-214)."""
        tets = self.points[self.active_simplices()]
        vecs = tets[:, :3, :] - tets[:, 3:, :]
        vols = np.abs(np.linalg.det(vecs) / 6.0)
        probs = vols / vols.sum()
        pick = np.random.choice(len(tets), p=probs, size=size)
        w = np.random.dirichlet([1, 1, 1, 1], size=size)[:, :, None]
        return (w * tets[pick]).sum(axis=1)

    def extract_mesh(self):
        from itertools import combinations

        thr = self.threshold
        verts, tris = [], []
        edge_vertex = {}
        for simplex in np.sort(self.active_simplices(), axis=1):
            cut = []
            for i1, i2 in combinations(simplex, 2):
                v1, v2 = self.values[i1], self.values[i2]
                if (v1 < thr) != (v2 < thr):
                    key = (i1, i2)
                    if key not in edge_vertex:
                        tau = (thr - v1) / (v2 - v1)
                        p = (1 - tau) * self.points[i1] + tau * self.points[i2]
                        edge_vertex[key] = len(verts)
                        verts.append(p)
                    cut.append(edge_vertex[key])
            if len(cut) not in (3, 4):
                continue
            p0 = self.points[simplex[0]]
            v0 = self.values[simplex[0]]

            def emit(i1, i2, i3):
                vol = np.linalg.det(
                    np.stack([verts[i1], verts[i2], verts[i3]]) - p0
                ) / 6.0
                if vol * (v0 - thr) <= 0:
                    tris.append((i1, i2, i3))
                else:
                    tris.append((i1, i3, i2))

            emit(cut[0], cut[1], cut[2])
            if len(cut) == 4:
                emit(cut[1], cut[2], cut[3])
        return (
            np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int32).reshape(-1, 3),
        )


def _stats(stats):
    st = stats if stats is not None else {}
    for k in ("coarse_s", "decode_s", "host_s"):
        st.setdefault(k, 0.0)
    st.setdefault("query_pts", [])
    return st


def multires_decode(generator, model, c, resolution0, upsampling_steps,
                    threshold, gating="none", gate_pts=None, gate_feat=None,
                    gate_valid=None, chunk=65536, stats=None):
    """Coarse-to-fine occupancy evaluation → the final dense value grid.

    Level 0 is the dense decode at (resolution0+1)³; each refinement
    doubles the resolution and decodes only the points next to boundary
    voxels, as int16 lattice nodes through ``eval_points_fast(...,
    lattice_reso=R)`` (the gather route: K1 with contact gates, K2
    otherwise). Returns ``(values, threshold)``: the ((R+1),)*3 value grid
    at the final resolution (points never decoded hold their coarse
    values; a read-only view of the engine's memory) and the iso level of
    the refinement, to hand to marching cubes.

    ``threshold``: a level in logit space, None for the coarse field's
    mean (``mc_level: 'mean'``) or 'midpoint' for its (min+max)/2.
    ``chunk`` is kept for the JAX signature: each level is one call.
    ``stats`` (a dict) receives ``coarse_s`` (the level-0 decode and its
    transfer), ``decode_s`` (the refinement decodes), ``host_s`` (the
    engine's bookkeeping) and ``query_pts`` per level."""
    st = _stats(stats)
    n0 = resolution0 + 1
    t0 = time.perf_counter()
    values0 = generator.eval_points_dense(
        model, n0, c, gating, gate_pts, gate_feat, gate_valid,
        transfer_dtype=generator.transfer_dtype).reshape(n0, n0, n0)
    st["coarse_s"] += time.perf_counter() - t0
    if threshold is None:
        threshold = float(values0.mean())
    elif threshold == "midpoint":
        threshold = (float(values0.min()) + float(values0.max())) / 2.0
    t0 = time.perf_counter()
    mg = MultiGridExtractor(resolution0, threshold, invert=False)
    pts0 = mg.query()
    mg.update(pts0, values0[pts0[:, 0], pts0[:, 1], pts0[:, 2]])
    st["host_s"] += time.perf_counter() - t0

    for _ in range(upsampling_steps):
        t0 = time.perf_counter()
        mg.increase_resolution()
        pts = mg.query()
        st["host_s"] += time.perf_counter() - t0
        st["query_pts"].append(int(len(pts)))
        if len(pts) == 0:
            continue
        t0 = time.perf_counter()
        vals = generator.eval_points_fast(
            model, pts, c, gating, gate_pts, gate_feat, gate_valid,
            lattice_reso=mg.resolution,
            transfer_dtype=generator.transfer_dtype).astype(np.float32)
        st["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        mg.update(pts, vals)
        st["host_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    out = mg.values_view
    st["host_s"] += time.perf_counter() - t0
    return out, threshold


def multires_decode_batched(generator, model, c_batched, resolution0,
                            upsampling_steps, thresholds, device_mesh=None,
                            stats=None):
    """Batched MISE: B objects refined in lockstep, ungated.

    The coarse level is one batched dense decode
    (``Generator3D.decode_dense_batched``); every refinement level packs
    all B objects' queries into one (B, 3, M) int16 lattice upload and
    decodes them in one batched K2 launch
    (``Generator3D.decode_points_batched``). Engines with ``query_cn`` (the
    native one) write their columns straight into the upload, each object
    padding with its own last point; others (the numpy reference) are
    stacked into (B, M, 3) with zeros, lattice node 0, after an object's
    last point, as in the JAX package, so those slots are decoded and
    enter the object's int8 scale there.

    ``thresholds``: a scalar, a per-object sequence of levels in logit
    space, or None for each object's coarse-field mean. Returns
    ``(grids, thresholds)``: B value grids at the final resolution and the
    levels used. ``stats`` receives :func:`multires_decode`'s split.
    With ``device_mesh`` both decodes split the objects over the data
    ranks and return all of them on every rank, which then refines every
    object's grid on its host, as one device's caller would."""
    B = next(iter(c_batched.values())).shape[0]
    st = _stats(stats)
    n0 = resolution0 + 1
    t0 = time.perf_counter()
    vals0 = generator.decode_dense_batched(model, n0, c_batched, device_mesh=device_mesh,
                                           transfer_dtype=generator.transfer_dtype)
    st["coarse_s"] += time.perf_counter() - t0
    if thresholds is None:
        thresholds = [float(vals0[b].mean()) for b in range(B)]
    elif np.isscalar(thresholds):
        thresholds = [float(thresholds)] * B
    t0 = time.perf_counter()

    def init_obj(b):
        mg = MultiGridExtractor(resolution0, thresholds[b], invert=False)
        v = vals0[b].reshape(n0, n0, n0)
        pts0 = mg.query()
        mg.update(pts0, v[pts0[:, 0], pts0[:, 1], pts0[:, 2]])
        return mg

    mgs = host_map(init_obj, range(B))
    st["host_s"] += time.perf_counter() - t0

    def advance(mg):
        mg.increase_resolution()
        return mg.query()

    use_cn = all(hasattr(mg, "query_cn") for mg in mgs)
    for _ in range(upsampling_steps):
        t0 = time.perf_counter()
        if use_cn:
            for mg in mgs:
                mg.increase_resolution()
            counts = [mg.query_count for mg in mgs]
            M = max(counts)
            st["query_pts"].append(int(M))
            if M == 0:
                st["host_s"] += time.perf_counter() - t0
                continue
            buf = np.empty((B, 3, M), np.int16)
            host_map(lambda mg, b: mg.query_cn(M, out=buf[b]), mgs, range(B))
            st["host_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            vals = generator.decode_points_batched(
                model, None, c_batched, device_mesh=device_mesh,
                lattice_reso=mgs[0].resolution, transfer_dtype=generator.transfer_dtype,
                pts_cn=buf, n_real=M)
            st["decode_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            host_map(lambda mg, v, n: mg.update_queried(v[:n]) if n else None,
                     mgs, list(vals), counts)
            st["host_s"] += time.perf_counter() - t0
            continue
        ptss = host_map(advance, mgs)
        M = max(len(p) for p in ptss)
        st["query_pts"].append(int(M))
        if M == 0:
            st["host_s"] += time.perf_counter() - t0
            continue
        coords = np.zeros((B, M, 3), np.int16)
        for b, p in enumerate(ptss):
            coords[b, :len(p)] = p
        st["host_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        vals = generator.decode_points_batched(
            model, coords, c_batched, device_mesh=device_mesh,
            lattice_reso=mgs[0].resolution, transfer_dtype=generator.transfer_dtype)
        st["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        def apply(mg, p, v):
            if len(p):
                mg.update(p, v[:len(p)])

        host_map(apply, mgs, ptss, list(vals))
        st["host_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    grids = host_map(lambda mg: mg.values_view, mgs)
    st["host_s"] += time.perf_counter() - t0
    return grids, thresholds
