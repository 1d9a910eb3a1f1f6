"""The iso-band transfer of dense occupancy grids (port of
vtaco_tpu/generate/band.py).

Marching cubes reads a grid's values only at the corners of the cells that
the iso-surface crosses; every other vertex contributes nothing but its
sign against the level. So the dense decode ships the band instead of the
whole nx³ float32 volume: on the device (``band_extract``) the level, one
occupancy bit per vertex (``g > level``, packed little-endian), and the
exact float32 logits of the iso-crossing cells' corners, compacted in flat
scan order into a buffer of fixed size ``cap``; on the host
``band_marching_cubes`` extracts the mesh straight from that payload (the
native scanner of native/mc.cpp, no grid), or ``band_reconstruct`` rebuilds
a grid with the exact values in the band and ``level ± 1`` elsewhere. The
mesh equals the full float32 transfer's bit for bit: every value marching
cubes interpolates is the exact float32 logit, and every sign test reads
the shipped bit.

The compaction keeps the fixed size of the JAX package's: the values go to
the positions an int32 cumsum gives them, the first ``cap`` of them kept.
The JAX package scatters every vertex, those outside the band into a
slot that is sliced off; the port gathers instead, each slot's vertex
found by a binary search of the cumsum (``torch.searchsorted``), which
writes no address twice (the same values, bit for bit). No step waits for
the host: ``count`` stays on the device, and a count above
``cap`` is the overflow signal the caller reads after the one payload copy
(``band_payload`` packs the four results into one byte buffer,
``band_unpack`` splits its host copy). There is no numpy fallback on the
serving path: a native engine that fails to build or load raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vtaco_tpu_torch import native

_CORNER_OFFSETS = [
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
    (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
]
LEVEL_MODES = ("midpoint", "mean", "const")


def default_cap(nx: int) -> int:
    """The active-vertex buffer: 1/16 of the grid, at least 65,536 (a
    closed surface crosses O(nx²) cells; 131,072 at 128³)."""
    return max(1 << 16, nx * nx * nx // 16)


def payload_bytes(nx: int, cap: int) -> int:
    """Bytes of one object's band payload: count and level, the packed
    occupancy bits and ``cap`` float32 values."""
    return 8 + -(-nx ** 3 // 8) + 4 * cap


def band_extract(logits_flat, nx: int, cap: int, level_mode, level_const=0.0):
    """The band of a (nx³,) float32 grid flattened x-slowest (the C order of
    the (nx, nx, nx) grid the host reconstructs), on its device.

    ``level_mode``: 'midpoint' ((min + max) / 2, the skimage default the
    reference inherits), 'mean', or 'const' (``level_const``).
    Returns (count, level, packed, vals): the int32 number of active
    vertices (above ``cap``: overflow), the float32 level, the (⌈nx³/8⌉,)
    uint8 occupancy bits and the (cap,) float32 logits of the active
    vertices in flat scan order (zeros past count)."""
    g = logits_flat.float()
    dev = g.device
    if level_mode == "midpoint":
        level = (torch.amin(g) + torch.amax(g)) * 0.5
    elif level_mode == "mean":
        level = torch.mean(g)
    elif level_mode == "const":
        level = torch.tensor(level_const, dtype=torch.float32, device=dev)
    else:
        raise ValueError(f"band level_mode must be one of {LEVEL_MODES}; got {level_mode!r}")
    occ = (g > level).reshape(nx, nx, nx)
    m = nx - 1
    all8 = any8 = None
    for dx, dy, dz in _CORNER_OFFSETS:
        c = occ[dx:m + dx, dy:m + dy, dz:m + dz]
        all8 = c if all8 is None else all8 & c
        any8 = c if any8 is None else any8 | c
    cross = any8 & ~all8                                  # (m, m, m) crossing cells
    act = torch.zeros((nx, nx, nx), dtype=torch.bool, device=dev)
    for dx, dy, dz in _CORNER_OFFSETS:
        act[dx:m + dx, dy:m + dy, dz:m + dz] |= cross
    idx = torch.cumsum(act.reshape(-1).to(torch.int32), 0, dtype=torch.int32)
    count = idx[-1]
    # slot j holds the active vertex whose running count first reaches j + 1
    # (a gather, where the JAX package scatters every vertex, the inactive
    # ones into a discarded slot: on the card those 2 M colliding writes
    # serialize); the slots past count stay zero, as there
    slots = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
    at = torch.searchsorted(idx, slots).clamp_(max=g.numel() - 1)
    vals = torch.where(slots <= count, g[at], 0.0)
    n = nx ** 3
    occf = occ.reshape(-1)
    if n % 8:
        occf = torch.cat([occf, occf.new_zeros(8 - n % 8)])
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    packed = (occf.reshape(-1, 8).to(torch.int32) << shifts).sum(1).to(torch.uint8)
    return count, level, packed, vals


def band_payload(count, level, packed, vals):
    """The four results of ``band_extract`` (or their (B, ...) stacks) as
    one uint8 device buffer per object, for one copy to the host: count
    (int32), level (float32), the bits, the values."""
    lead = packed.shape[:-1]
    parts = [count.to(torch.int32).reshape(*lead, 1), level.float().reshape(*lead, 1)]
    return torch.cat([parts[0].view(torch.uint8), parts[1].view(torch.uint8), packed,
                      vals.contiguous().view(torch.uint8)], dim=-1)


def band_unpack(buf, nx: int, cap: int):
    """A host copy (numpy uint8) of one object's ``band_payload`` → (count
    int, level float, packed, vals)."""
    buf = np.ascontiguousarray(buf)
    nb = -(-nx ** 3 // 8)
    count = int(buf[:4].view(np.int32)[0])
    level = float(buf[4:8].view(np.float32)[0])
    return count, level, buf[8:8 + nb], buf[8 + nb:8 + nb + 4 * cap].view(np.float32)


def band_marching_cubes(nx: int, level: float, count: int, packed, vals,
                        gradient: str = "ascent"):
    """Marching cubes straight from the band payload (native/mc.cpp's
    fused scanner, no grid): the mesh of reconstruct-plus-scan."""
    verts, faces = native.mc.marching_cubes_band(nx, float(level), int(count),
                                                 packed, vals)
    if gradient == "ascent":
        faces = faces[:, ::-1]
    return verts, faces


def band_reconstruct(nx: int, level: float, count: int, packed, vals):
    """A host (nx, nx, nx) float32 grid from the band payload: the exact
    logits at the active vertices, ``level ± 1`` elsewhere (sign-correct
    filler that marching cubes never interpolates), in one native pass."""
    return native.mc.band_reconstruct(nx, float(level), int(count), packed, vals)


def _band_reconstruct_numpy(nx, level, count, packed, vals):
    """The plain numpy form of band_reconstruct, the tests' reference."""
    n = nx * nx * nx
    occ3 = np.unpackbits(np.asarray(packed, np.uint8), bitorder="little")[:n].astype(
        bool).reshape(nx, nx, nx)
    m = nx - 1
    corners = [occ3[dx:m + dx, dy:m + dy, dz:m + dz] for dx, dy, dz in _CORNER_OFFSETS]
    all8 = np.logical_and.reduce(corners)
    any8 = np.logical_or.reduce(corners)
    cross = any8 & ~all8
    act = np.zeros((nx, nx, nx), bool)
    for dx, dy, dz in _CORNER_OFFSETS:
        act[dx:m + dx, dy:m + dy, dz:m + dz] |= cross
    grid = np.where(occ3, np.float32(level + 1.0), np.float32(level - 1.0))
    flat_idx = np.flatnonzero(act.reshape(-1))
    if flat_idx.size != count:
        raise ValueError(f"band payload inconsistent: mask implies {flat_idx.size} "
                         f"active vertices, device counted {count}")
    grid.reshape(-1)[flat_idx] = np.asarray(vals, np.float32)[:count]
    return grid
