"""Decode inputs: the feature fields at the query points, channels-first
(port of vtaco_tpu/ops/dense_decode.py).

The mesh-extraction queries form a regular nx³ grid, so trilinear
sampling of the (R, R, R, C) feature grid factorizes into three 1D
align-corners interpolations, each a matmul with a fixed (nx, R) matrix,
and bilinear sampling of a (R, R, C) plane into two, broadcast over the
plane's normal axis. These are plain large products, left to
``torch.einsum`` as the JAX package leaves them to XLA. Outputs are
channels-first (C, N) with N flattened z-slowest, the layout the decoder
trunk streams; the fields are summed in the order grid, xz, xy, yz, as
the decoder's ``sample_features`` sums them.

The JAX package's XLA dense path works in particle order instead (x
slowest, z fastest; vtaco_tpu/ops/dense_decode.py:50-88, 338-358):
``dense_query_grid`` gives the (nx³, 3) points, ``dense_feature_volume``
their (nx³, C) features, from ``dense_grid_features_simple`` and
``dense_plane_features`` on (nx, nx, nx, C) volumes indexed (x, y, z).
``supercell_packed_volume`` lays a grid out as the JAX window kernel reads
it: each super-cell's node neighbourhood in one column.

Arbitrary query points take the corner gather instead
(``scattered_feature_volume_cn``), and the sorted window route keys them
by super-cell (``supercell_keys``). Keys must equal the JAX package's bit
for bit, since the window plan and its overflow count depend on them, so
the coordinate math divides by a ``device_scalar``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vtaco_tpu_torch.ops.geometry import PLANE_AXES

PLANES = ("xz", "xy", "yz")


def _axis_interp_matrix(nx: int, R: int, box_size: float, padding: float,
                        three_d: bool) -> np.ndarray:
    """(nx, R) align-corners linear interpolation matrix for one axis.

    Row i interpolates at the dense-grid coordinate
    ``box_size * (-0.5 + i/(nx-1))`` after the normalization of
    ops.geometry (outlier-only remap) and border clamping."""
    coords = box_size * (-0.5 + np.arange(nx) / (nx - 1))
    eps = 10e-4 if three_d else 10e-6
    u = coords / (1 + padding + eps) + 0.5
    u = np.where(u >= 1.0, 1 - eps, np.maximum(u, 0.0))
    x = np.clip(u * (R - 1), 0.0, R - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, R - 1)
    x1 = np.minimum(x0 + 1, R - 1)
    w = (x - x0).astype(np.float32)
    W = np.zeros((nx, R), np.float32)
    W[np.arange(nx), x0] += 1 - w
    np.add.at(W, (np.arange(nx), x1), w)
    return W


@functools.lru_cache(maxsize=64)
def _interp_matrix_on(nx, R, box_size, padding, three_d, dtype, device):
    """_axis_interp_matrix as a tensor on ``device``, made once per shape:
    copying it from the host on every decode would make the host wait for
    the card. A normal tensor even when first asked for under
    torch.inference_mode, so that autograd may use it later."""
    with torch.inference_mode(False):
        return torch.as_tensor(_axis_interp_matrix(nx, R, box_size, padding, three_d),
                               dtype=dtype, device=device)


def dense_feature_volume_cn(c_planes: dict, nx: int, box_size: float,
                            padding: float, dtype=torch.float32, z=slice(None)):
    """(C, nx³) features of every field at the dense query grid, summed, N
    flattened (z slowest, y, x fastest). Fields are channel-last as the
    encoder returns them, with or without the batch axis of one: the grid
    (Z, Y, X, C), planes (rows: the second coordinate, columns: the
    first, C). ``z``, a slice of the grid's z indices, keeps that z-slab:
    (C, dz·nx²)."""
    nz = len(range(nx)[z])
    acc = 0
    if "grid" in c_planes:
        g = c_planes["grid"]
        if g.ndim == 5:
            g = g[0]
        g = g.to(dtype)
        W = _interp_matrix_on(nx, g.shape[0], box_size, padding, True, dtype, g.device)
        g = g.permute(3, 0, 1, 2)                           # (C, Z, Y, X)
        g = torch.einsum("iz,czyx->ciyx", W[z], g)
        g = torch.einsum("jy,ciyx->cijx", W, g)
        g = torch.einsum("kx,cijx->cijk", W, g)
        acc = acc + g.reshape(g.shape[0], -1)
    for key in PLANES:
        if key not in c_planes:
            continue
        p = c_planes[key]
        if p.ndim == 4:
            p = p[0]
        p = p.to(dtype)                                     # (b, a, C)
        W = _interp_matrix_on(nx, p.shape[0], box_size, padding, False, dtype, p.device)
        p = p.permute(2, 0, 1)                              # (C, b, a)
        p = torch.einsum("ia,cba->cbi", W, p)
        p = torch.einsum("jb,cbi->cji", W, p)               # (C, b, a) at the grid
        C = p.shape[0]
        if key == "xz":      # (C, z, x): broadcast over y
            vol = p[:, z, None, :]
        elif key == "xy":    # (C, y, x): broadcast over z
            vol = p[:, None, :, :]
        else:                # yz, (C, z, y): broadcast over x
            vol = p[:, z, :, None]
        acc = acc + vol.expand(C, nz, nx, nx).reshape(C, -1)
    return acc


def _particle_order(c_planes: dict, nx: int, box_size: float, padding: float):
    """dense_feature_volume_cn's sum as an (nx, nx, nx, C) view indexed
    (x, y, z): the particle order of the JAX package's XLA dense path."""
    dtype = next(iter(c_planes.values())).dtype
    cn = dense_feature_volume_cn(c_planes, nx, box_size, padding, dtype)
    return cn.reshape(cn.shape[0], nx, nx, nx).permute(3, 2, 1, 0)


def dense_grid_features_simple(c_grid, nx: int, box_size: float, padding: float):
    """(1, R, R, R, C) grid features → (nx, nx, nx, C) at the dense query
    grid, indexed (x, y, z)."""
    return _particle_order({"grid": c_grid}, nx, box_size, padding)


def dense_plane_features(c_plane, plane: str, nx: int, box_size: float, padding: float):
    """(1, R, R, C) plane features (rows: the plane's second coordinate)
    → (nx, nx, nx, C), indexed (x, y, z), broadcast over the plane's
    normal axis."""
    return _particle_order({plane: c_plane}, nx, box_size, padding)


def dense_feature_volume(c_planes: dict, nx: int, box_size: float, padding: float):
    """(nx³, C) features of every field at ``dense_query_grid``'s points,
    summed in the order grid, xz, xy, yz."""
    vol = _particle_order(c_planes, nx, box_size, padding)
    return vol.reshape(nx ** 3, vol.shape[-1])


def dense_query_grid(nx: int, box_size: float, device="cuda"):
    """(nx³, 3) dense query points, x slowest and z fastest."""
    cn = dense_query_grid_cn(nx, box_size, device)
    return cn.reshape(3, nx, nx, nx).permute(3, 2, 1, 0).reshape(-1, 3)


def supercell_packed_volume(g, S: int, L: int = 1, dtype=torch.float32):
    """(D, D, D, C) feature grid → ((L+1)³·C, n_pad) packed volume and
    n1 = ceil((D-1)/L): column s holds the (L+1)³ node neighbourhood of
    super-cell s (flat id as in supercell_keys), row j·C + c channel c of
    offset j = (jz·(L+1) + jy)·(L+1) + jx; border nodes past the grid
    repeat its edge; columns are zero-padded to a multiple of S, at least
    2S."""
    D, H, W, C = g.shape
    if not (D == H == W):
        raise ValueError("windowed decode expects a cubic grid")
    P = L + 1
    n1 = -(-(W - 1) // L)
    edge = torch.clamp(torch.arange(L * n1 + 1, device=g.device), max=W - 1)
    gp = g.to(dtype)[edge][:, edge][:, :, edge]
    vol = torch.stack([gp[jz:jz + L * n1:L, jy:jy + L * n1:L, jx:jx + L * n1:L]
                       for jz in range(P) for jy in range(P) for jx in range(P)])
    vol = vol.permute(0, 4, 1, 2, 3).reshape(P ** 3 * C, n1 ** 3)
    n_pad = max(2 * S, -(-n1 ** 3 // S) * S)
    return torch.nn.functional.pad(vol, (0, n_pad - n1 ** 3)), n1


def dense_query_grid_cn(nx: int, box_size: float, device="cuda"):
    """(3, nx³) query coordinates (x, y, z rows), N flattened z-slowest to
    match dense_feature_volume_cn."""
    coords = box_size * (
        -0.5 + torch.arange(nx, dtype=torch.float32, device=device) / (nx - 1))
    gz = coords[:, None, None].expand(nx, nx, nx)
    gy = coords[None, :, None].expand(nx, nx, nx)
    gx = coords[None, None, :].expand(nx, nx, nx)
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)])


def device_scalar(x, device):
    """A float32 scalar tensor on ``device``. Divide by this, not by a
    Python number: CUDA divides by a host scalar as a multiply by its
    reciprocal, which rounds differently from an IEEE division."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _base_coords(p_cn, dims, padding: float):
    """(3, N) world coords → per-axis base corners (int32, clamped to
    dim-2) and pixel coordinates (f32), for axis sizes ``dims`` = (W, H, D)
    of x, y, z: normalization with the 3-D epsilon (outlier-only remap),
    align-corners, border clamp. Every step is one IEEE f32 operation."""
    p_cn = p_cn.to(torch.float32)
    u = p_cn / device_scalar(1 + padding + 10e-4, p_cn.device) + 0.5
    u = torch.where(u >= 1.0, device_scalar(1 - 10e-4, u.device),
                    torch.clamp(u, min=0.0))
    pix, base = [], []
    for a, n in enumerate(dims):
        x = torch.clamp(u[a] * (n - 1), 0.0, n - 1)
        pix.append(x)
        base.append(torch.clamp(torch.floor(x), max=n - 2).to(torch.int32))
    return base, pix


def supercell_base_coords(p_cn, reso: int, padding: float):
    """(3, N) world coords → ``(x0, y0, z0, x, y, z)``: int32 base corners
    and f32 pixel coordinates on a cubic ``reso`` grid, exactly the
    coordinate math of :func:`scattered_grid_features_cn`."""
    base, pix = _base_coords(p_cn, (reso,) * 3, padding)
    return (*base, *pix)


def supercell_keys(p_cn, reso: int, padding: float, L: int = 1):
    """(3, N) world coords → (N,) int32 flat super-cell ids
    ``sx + n1·(sy + n1·sz)``, super-cells of L×L×L cells,
    ``n1 = ceil((reso-1)/L)``, x fastest."""
    n1 = -(-(reso - 1) // L)
    x0, y0, z0, _, _, _ = supercell_base_coords(p_cn, reso, padding)
    return (x0 // L) + n1 * ((y0 // L) + n1 * (z0 // L))


def window_blocks(reso: int, L: int, S: int) -> int:
    """Number of S-wide column blocks of the JAX package's super-cell
    packed volume (``supercell_packed_volume``: n1³ columns padded to a
    multiple of S, at least 2S)."""
    n1 = -(-(reso - 1) // L)
    return max(2 * S, -(-n1 ** 3 // S) * S) // S


def window_overflow(keys, tile: int, S: int, n_blk: int):
    """Points whose super-cell falls outside their tile's 2S window, for
    ``keys`` of points in sorted order cut into tiles of ``tile``: a tile's
    window starts at block ``clip(first key // S, 0, n_blk - 2)``. A
    ragged last tile is padded with copies of the last key, as the JAX
    package pads its points. Returns a 0-dim int64 tensor."""
    n = keys.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=keys.device)
    keys = torch.cat([keys, keys[-1:].expand((-n) % tile)]).view(-1, tile)
    kblk = torch.clamp(keys[:, 0] // S, 0, n_blk - 2)
    local = keys - (kblk * S)[:, None]
    return torch.sum((local < 0) | (local >= 2 * S))


def scattered_grid_features_cn(g, p_cn, padding: float, dtype=torch.float32):
    """(Z, Y, X, C) grid + (3, N) world coords → (C, N) trilinear features:
    ``interp_grid(grid, normalize_3d_coordinate(p))`` semantics
    (align-corners, border clamp, outlier-only remap with the 3-D epsilon).
    The base corner is clamped to dim-2, so its +1 neighbour always
    exists; the 2×2×2 corners are combined x first, then y, then z, as the
    JAX package combines them."""
    D, H, W, C = g.shape
    (x0, y0, z0), (x, y, z) = _base_coords(p_cn, (W, H, D), padding)
    wx = (x - x0).to(dtype)[None]
    wy = (y - y0).to(dtype)[None]
    wz = (z - z0).to(dtype)[None]
    gf = g.to(dtype).reshape(-1, C)
    row = (z0.long() * H + y0) * W + x0

    def corner(dz, dy, dx):
        return gf[row + (dz * H + dy) * W + dx].T

    c00 = corner(0, 0, 0) * (1 - wx) + corner(0, 0, 1) * wx
    c01 = corner(0, 1, 0) * (1 - wx) + corner(0, 1, 1) * wx
    c10 = corner(1, 0, 0) * (1 - wx) + corner(1, 0, 1) * wx
    c11 = corner(1, 1, 0) * (1 - wx) + corner(1, 1, 1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def scattered_plane_features_cn(pl, plane: str, p_cn, padding: float,
                                dtype=torch.float32):
    """(H, W, C) plane + (3, N) world coords → (C, N) bilinear features:
    ``interp_plane(plane, normalize_coordinate(p))`` semantics (the 2-D
    epsilon; columns index the plane's first axis, rows its second). The
    base corner is clamped to dim-2; the corners are combined along the
    columns first, as the JAX package combines them."""
    H, W, C = pl.shape
    a_ax, b_ax = PLANE_AXES[plane]
    p_cn = p_cn.to(torch.float32)
    div = device_scalar(1 + padding + 10e-6, p_cn.device)
    top = device_scalar(1 - 10e-6, p_cn.device)
    uv = []
    for ax in (a_ax, b_ax):
        u = p_cn[ax] / div + 0.5
        uv.append(torch.where(u >= 1.0, top, torch.clamp(u, min=0.0)))
    x = torch.clamp(uv[0] * (W - 1), 0.0, W - 1)
    y = torch.clamp(uv[1] * (H - 1), 0.0, H - 1)
    x0 = torch.clamp(torch.floor(x), max=W - 2)
    y0 = torch.clamp(torch.floor(y), max=H - 2)
    wx = (x - x0).to(dtype)[None]
    wy = (y - y0).to(dtype)[None]
    pf = pl.to(dtype).reshape(-1, C)
    row = y0.long() * W + x0.long()

    def corner(dy, dx):
        return pf[row + dy * W + dx].T

    c0 = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    c1 = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    return c0 * (1 - wy) + c1 * wy


def scattered_feature_volume_cn(c_planes: dict, p_cn, padding: float,
                                dtype=torch.float32):
    """The sum of every field's features at arbitrary (3, N) world coords,
    channels-first (C, N): the scattered counterpart of
    dense_feature_volume_cn (the decoder's ``sample_features``)."""
    acc = 0
    if "grid" in c_planes:
        g = c_planes["grid"]
        acc = acc + scattered_grid_features_cn(g[0] if g.ndim == 5 else g, p_cn,
                                               padding, dtype)
    for key in PLANES:
        if key in c_planes:
            p = c_planes[key]
            acc = acc + scattered_plane_features_cn(p[0] if p.ndim == 4 else p, key,
                                                    p_cn, padding, dtype)
    return acc
