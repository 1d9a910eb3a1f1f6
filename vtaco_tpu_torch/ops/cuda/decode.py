"""Fused decoder-trunk kernels for Hopper, with their plain versions
(port of vtaco_tpu/ops/pallas/decode.py: ``pack_trunk_params`` :35-61,
``fused_trunk_window_cn`` :294, ``fused_trunk_cn`` :457 and
``fused_trunk_gated_cn`` :538).

K1 and K2 live in ``csrc/trunk.cu``, K3 and K4 (the two branches of
``fused_trunk_window_cn``) in ``csrc/window.cu``, all four on the tile
chain of ``csrc/tile_chain.cuh``, which takes hidden = C = 32 (every
shipped LocalDecoder config); every other (hidden, C, Ci, n_blocks), as
the Pallas kernels take, goes to the width-generic kernel of
``csrc/trunk_any.cu`` in the same modes. ``_tile_chain`` picks the route
from the widths alone. See each source's header for what bounds it on the
card and how the design answers it. This module packs the weights
(``pack_window_params``: split into TF32 hi/lo parts for the tensor cores;
``pack_any_params``: natural order, padded to multiples of 8, for the
generic kernel, which splits as it stages), checks the
inputs and launches the kernels through ctypes.
``window_gate_candidates`` is the plain version of the kernels' per-tile
contact culling, and ``window_box_edge_contacts`` a contact set that
probes its margin.

Wrapper contract: CPU tensors take the plain PyTorch version in
ops/fast_trunk.py (the function the kernel computes); CUDA tensors launch
the kernel or raise — nothing falls back. Each wrapper counts its launches
in ``<wrapper>.launches``, incremented only where the kernel is launched
(``fused_trunk_window_cn`` counts its gated branch, K4, in
``.launches_gated``); ``fused_trunk_cn`` and ``fused_trunk_window_cn``
also count, in ``.launches_cimg``, those of their launches that took c_img
rows (MODE_CIMG, VTacOH's fingertip rows).
``fused_trunk_cn_batched``, K2 over an object axis in one launch, counts
in its own ``.launches``. Those counters count the tile chain's launches;
the generic kernel's count in ``.launches_generic`` of each wrapper (and
``fused_trunk_window_cn.launches_generic_gated``,
``.launches_generic_cimg`` of ``fused_trunk_cn`` and
``fused_trunk_window_cn``).
``store_dtype=torch.bfloat16`` stores the streamed per-point operands as
bf16 (coords, features, c_img) while all math stays f32; the plain path
rounds the same operands the same way.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import build
from vtaco_tpu_torch.ops.dense_decode import (
    scattered_grid_features_cn,
    supercell_keys,
    window_blocks,
    window_overflow,
)

WIDTHS = (32, 32)  # (hidden, C) of the tile chain (tile_chain.cuh kWidth)
# blocks whose split weights fit one block's shared memory beside the tile
# chain's three tiles of scratch: 6240 NB + 164 floats (+ a 2048-float
# c_img product) of at most 41,024
TILE_CHAIN_BLOCKS = 6
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
WINDOW_TILE = 128  # points per tile of the tile kernels (kTile)


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: what ``cvt.rna.tf32.f32`` gives for finite x."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _fragments(w):
    """(P, 32, 32) weights (out, in) → (P, 2, 1024): the hi then the lo TF32
    part of each, in csrc/tile_chain.cuh's core-matrix order: k8 step jk,
    core matrix nb along N and kb along K, row r and element e hold
    W[8nb + r][8jk + 2e + kb] (the input axis permuted within each
    8-block)."""
    P = w.shape[0]
    w = w.float().reshape(P, 4, 8, 4, 4, 2).permute(0, 3, 1, 5, 2, 4).reshape(P, 1024)
    hi = tf32_rna(w)
    return torch.stack([hi, tf32_rna(w - hi)], dim=1)


def pack_window_params(tp, with_img: bool, img_rows: bool = False):
    """extract_trunk_params output → (blob, w_img) for the tile kernels.

    ``blob`` is the flat f32 array of ``tile_chain.cuh``'s ``Layout``: the
    3·NB chain products (wc, w0, w1 of each block) split into TF32 hi/lo
    parts (``_fragments``), then wp (coord columns + b_in) | bc | b0 | b1 |
    w_out | b_out padded to 4 in natural order, and with ``img_rows`` the
    c_img half of fc_p_img as one more product (the MODE_CIMG tail).
    ``w_img`` is that (h, C) half, or None for fc_p. The wrapper packs on
    every call, so the parts are few: each is an operation on the device."""
    w_in, b_in = tp["fc_p_img"] if with_img else tp["fc_p"]
    w_in = w_in.float()
    w_out, b_out = tp["fc_out"]
    blocks = tp["blocks"]
    prods = []
    for (wc, _), blk in zip(tp["fc_c"], blocks):
        prods += [wc, blk[0], blk[2]]
    w_img = w_in[:, 3:] if with_img else None
    parts = [_fragments(torch.stack(prods)),
             torch.cat([w_in[:, :3], b_in.float()[:, None]], dim=1),
             *[b for _, b in tp["fc_c"]], *[blk[1] for blk in blocks],
             *[blk[3] for blk in blocks], w_out, b_out.reshape(1),
             b_out.new_zeros(3)]
    if img_rows:
        parts.append(_fragments(w_img[None]))
    return torch.cat([t.float().reshape(-1) for t in parts]), w_img


def _stored(x, store_dtype):
    """The f32 values a kernel reads from `x` stored as `store_dtype`."""
    x = x.float()
    return x if store_dtype is None else x.to(store_dtype).float()


def _tile_lib(name):
    """csrc/<name>.cu's library, after checking that it tiles WINDOW_TILE
    points; ``<name>_smem_bytes`` gives a launch's shared memory."""
    lib = build.library(name)
    I = ctypes.c_int
    tile = getattr(lib, f"{name}_tile")
    tile.restype = I
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes, smem.restype = [I], I
    if tile() != WINDOW_TILE:
        raise RuntimeError(f"{name}.cu tiles {tile()} points, WINDOW_TILE is "
                           f"{WINDOW_TILE}")
    return lib


@functools.cache
def _lib():
    lib = _tile_lib("trunk")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.trunk_cn_launch.argtypes = [P, I, I, I, I, P, P, P, I, P,
                                    ctypes.c_longlong, P]
    lib.trunk_cn_launch.restype = I
    lib.trunk_cn_batched_launch.argtypes = [P, I, I, I, I, I, P, ctypes.c_longlong, P,
                                            I, P, ctypes.c_longlong, P]
    lib.trunk_cn_batched_launch.restype = I
    lib.trunk_gated_cn_launch.argtypes = [P, I, I, I, I, I, I, F, P, P, P, I, P,
                                          ctypes.c_longlong, P]
    lib.trunk_gated_cn_launch.restype = I
    return lib


@functools.cache
def _window_lib():
    lib = _tile_lib("window")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window_cn_launch.argtypes = [P, I, I, I, I, I, I, F, I, P, P, P, I, F,
                                     F, I, I, P, P, P, ctypes.c_longlong, P]
    lib.window_cn_launch.restype = I
    return lib


def _check(tp, p_cn, C, *others, c_img=None):
    """N, after checking that the coords are (3, N), each (C, N) operand in
    ``others`` matches, the c_img rows are (Ci, N) for the fc_p_img weights
    (3 + Ci inputs), the weights take C features, and all share one CUDA
    device with the weights."""
    dev = p_cn.device
    if dev.type != "cuda":
        raise ValueError(f"the trunk kernels take CUDA or CPU tensors, got {dev}")
    N = p_cn.shape[-1]
    if p_cn.shape != (3, N) or any(t.shape != (C, N) for t in others):
        raise ValueError(f"coords must be (3, N) and features ({C}, N), got "
                         f"{[tuple(t.shape) for t in (p_cn, *others)]}")
    if tp["fc_c"] and tp["fc_c"][0][0].shape[1] != C:
        raise ValueError(f"the decoder takes {tp['fc_c'][0][0].shape[1]} feature "
                         f"channels, got {C}")
    if c_img is not None:
        n_in = tp["fc_p_img"][0].shape[1]
        if c_img.dim() != 2 or c_img.shape != (n_in - 3, N):
            raise ValueError(f"c_img rows must be ({n_in - 3}, {N}) for fc_p_img's "
                             f"{n_in} inputs, got {tuple(c_img.shape)}")
        others = (*others, c_img)
    if any(t.device != dev for t in (tp["fc_out"][0], *others)):
        raise ValueError("coords, features and weights must share one device")
    return N


def _tile_chain(tp, C, c_img=None):
    """Whether the tile chain (trunk.cu, window.cu) takes these widths:
    hidden = C = 32, 32 c_img rows if any, and at most TILE_CHAIN_BLOCKS
    blocks. Every other width takes csrc/trunk_any.cu. The widths alone
    decide: a launch that fails raises, it never reroutes."""
    h = tp["fc_out"][0].shape[1]
    return ((h, C) == WIDTHS and len(tp["blocks"]) <= TILE_CHAIN_BLOCKS
            and (c_img is None or c_img.shape[0] == WIDTHS[1]))


def _pad8(x):
    return -(-x // 8) * 8


def any_plan(H):
    """csrc/trunk_any.cu's tile at hidden width H, which no other width
    changes (the launch takes MT, KS and WO from it): ``(T, KS, MT, WO,
    chunk, smem_bytes)``, T points per tile, k-slices of KS input channels
    (32, else 16, with MT = 2; 8 with MT = 1), MT m16 tiles per warp, WO of
    the eight warps along the output channels, ``chunk`` output channels
    covered at once and the bytes of shared memory: net and h (T x (Hp +
    4) each), two weight slices (min(Hp, chunk) x KS), two streamed slices
    (KS x (T + 8)) and 4 T words of coordinates and gates (Hp = H padded
    to a multiple of 8). None where even the smallest tile does not fit."""
    Hp = _pad8(H)
    MT = 2 if Hp <= 512 else 1
    NT = 16 // MT
    WO = 1
    while WO < 8 and WO * NT * 8 < Hp:
        WO *= 2
    T = (8 // WO) * MT * 16
    chunk = WO * NT * 8
    wch = min(Hp, chunk)
    for KS in ((32, 16) if MT == 2 else (8,)):
        smem = 4 * (2 * T * (Hp + 4) + 2 * wch * KS + 2 * KS * (T + 8) + 4 * T)
        if smem <= SMEM_LIMIT:
            return T, KS, MT, WO, chunk, smem
    return None


# the widest hidden layer a tile holds: net and h of its 16 points beside
# one slice of 8 input channels
ANY_MAX_HIDDEN = max(H for H in range(8, 4096, 8) if any_plan(H) is not None)


def any_smem_bytes(H):
    """Shared memory of csrc/trunk_any.cu's tile at hidden width H; C and
    Ci stream through k-slices and change nothing."""
    return _any_plan_or_raise(H)[5]


def any_tile(H):
    """Points per tile of the generic kernel at hidden width H: 256 up to
    hidden 64, then 128, 64, 32 and 16 (from hidden 520 on), as eight
    warps tile the T x hidden output. Raises ValueError past
    ANY_MAX_HIDDEN, where even the tile of 16 points does not fit a
    block's shared memory."""
    return _any_plan_or_raise(H)[0]


def _any_plan_or_raise(H):
    plan = any_plan(H)
    if plan is None:
        raise ValueError(
            f"the generic trunk kernel holds hidden widths up to {ANY_MAX_HIDDEN}, "
            f"got hidden={H}: net and h of its smallest tile of 16 points beside "
            f"one weight slice exceed the {SMEM_LIMIT} B of shared memory a "
            f"block has")
    return plan


def pack_any_params(tp, mode, gate_feat=None):
    """extract_trunk_params output → csrc/trunk_any.cu's flat f32 blob, in
    natural order with hidden, C and Ci padded to multiples of 8 by zero
    weights and biases (exact: a padded hidden channel stays 0 through every
    ReLU and meets zero columns and a zero w_out): the coord columns of
    fc_p (mode 0) or fc_p_img (modes 1, 2) and b_in, then per block wc,
    bc, w0, b0, w1, b1, then w_out and b_out (padded to 8); in mode 1 the
    c_img columns W_img of fc_p_img after them, in mode 2 W_img g_f for
    each finger's feature g_f (``gate_feat`` (F, Ci)). The TF32 split
    happens in the kernel."""
    w_in, b_in = tp["fc_p_img"] if mode else tp["fc_p"]
    Hp = _pad8(w_in.shape[0])

    def pad(x, rows, cols=None):
        x = x.float()
        if cols is None:
            return torch.nn.functional.pad(x.reshape(-1), (0, rows - x.numel()))
        return torch.nn.functional.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))

    parts = [pad(w_in[:, :3], Hp, 3), pad(b_in, Hp)]
    for (wc, bc), (w0, b0, w1, b1) in zip(tp["fc_c"], tp["blocks"]):
        parts += [pad(wc, Hp, _pad8(wc.shape[1])), pad(bc, Hp), pad(w0, Hp, Hp),
                  pad(b0, Hp), pad(w1, Hp, Hp), pad(b1, Hp)]
    w_out, b_out = tp["fc_out"]
    parts += [pad(w_out, Hp), pad(b_out, 8)]
    if mode == 1:
        w_img = w_in[:, 3:]
        parts.append(pad(w_img, Hp, _pad8(w_img.shape[1])))
    elif mode == 2:
        gproj = gate_feat.float() @ w_in[:, 3:].float().T             # (F, h)
        parts.append(pad(gproj, gproj.shape[0], Hp))
    return torch.cat([t.reshape(-1) for t in parts])


def _contact_rows(gate_pts, gate_valid):
    """The (F K, 4) f32 contact rows the gated kernels read: (q, |q|²) in
    finger order, |q|² replaced by -1 on invalid rows."""
    q = gate_pts.reshape(-1, 3).float()
    q2 = torch.where(gate_valid.reshape(-1).bool(), (q * q).sum(dim=1), -1.0)
    return torch.cat([q, q2[:, None]], dim=1).contiguous()


@functools.cache
def _any_lib():
    lib = build.library("trunk_any")
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.trunk_any_launch.argtypes = [P, I, I, I, I, I, P, I, I, F, I, I, I, P, LL, P,
                                     LL, P, I, P, LL, I, P]
    lib.trunk_any_launch.restype = I
    lib.trunk_any_window_launch.argtypes = [P, I, I, I, I, I, P, I, I, F, I, I, I, P,
                                            P, I, F, F, I, I, P, P, P, P, LL, P]
    lib.trunk_any_window_launch.restype = I
    return lib


def _any_operands(tp, C, mode, Ci=0, gate=None, radius=0.015):
    """What csrc/trunk_any.cu takes besides the streamed operands: ``(lib,
    head, keep)``, head the launch's first thirteen arguments (blob,
    hidden, C, Ci, n_blocks, mode, contacts, F, K, r², and any_plan's MT,
    KS, WO) and keep the tensors they point into, to be held until the
    launch is enqueued. Raises past ANY_MAX_HIDDEN."""
    H = tp["fc_out"][0].shape[1]
    Ci = Ci if mode == 1 else 0
    _, KS, MT, WO, _, _ = _any_plan_or_raise(H)
    lib = _any_lib()
    contacts, F, K, r2 = None, 0, 0, 0.0
    gate_feat = None
    if mode == 2:
        gate_pts, gate_feat, gate_valid = gate
        F, K, _ = gate_pts.shape
        contacts = _contact_rows(gate_pts, gate_valid)
        r2 = float(radius) * float(radius)
    blob = pack_any_params(tp, mode, gate_feat)
    keep = (blob, contacts)
    head = (blob.data_ptr(), H, C, Ci, len(tp["blocks"]), mode,
            None if contacts is None else contacts.data_ptr(), F, K, r2, MT, KS, WO)
    return lib, head, keep


def _check_smem(smem_bytes, blob):
    """Raises unless a launch with ``blob`` (``smem_bytes`` of its floats
    from the kernel's library) fits a block's shared memory."""
    smem = smem_bytes(blob.numel())
    if smem > SMEM_LIMIT:
        raise ValueError(f"the kernel needs {smem} B of shared memory, more "
                         f"than a block has ({SMEM_LIMIT})")


def _streamed(x, store_dtype):
    return x.to(store_dtype or torch.float32).contiguous()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def _trunk_operands(tp, p_cn, feats_cn, c_img_cn=None, gate=None,
                    store_dtype=None):
    """What csrc/trunk.cu takes: ``(blob, contacts, streamed)``,
    ``_window_operands``' blob and contacts in mode 0 (coords), 1 (c_img
    rows) or 2 (gated by ``gate`` = (gate_pts, gate_feat, gate_valid)), and
    the (3, N) coords, (C, N) features and c_img rows (or None), contiguous
    in ``store_dtype`` (float32 for None)."""
    mode = 2 if gate is not None else 0 if c_img_cn is None else 1
    blob, contacts = _window_operands(tp, mode, gate)
    streamed = [None if t is None else _streamed(t, store_dtype)
                for t in (p_cn, feats_cn, c_img_cn)]
    return blob, contacts, streamed


def fused_trunk_cn(tp, p_cn, feats_cn, c_img_cn=None, *, store_dtype=None):
    """K2: the ungated fused trunk. p_cn (3, N), feats_cn (C, N), optional
    c_img_cn (Ci, N) → (N,) float32 logits, for any N and widths."""
    if p_cn.device.type == "cpu":
        c_img = None if c_img_cn is None else _stored(c_img_cn, store_dtype)
        return FT.trunk_cn(tp, _stored(p_cn, store_dtype),
                           _stored(feats_cn, store_dtype), c_img)
    C = feats_cn.shape[0]
    N = _check(tp, p_cn, C, feats_cn, c_img=c_img_cn)
    bf16 = int(store_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(p_cn.device).cuda_stream
    out = torch.empty(N, dtype=torch.float32, device=p_cn.device)
    if not _tile_chain(tp, C, c_img_cn):
        mode = 0 if c_img_cn is None else 1
        lib, head, _keep = _any_operands(tp, C, mode,
                                         0 if c_img_cn is None else c_img_cn.shape[0])
        x, f, ci = [None if t is None else _streamed(t, store_dtype)
                    for t in (p_cn, feats_cn, c_img_cn)]
        rc = lib.trunk_any_launch(*head, x.data_ptr(), 0, f.data_ptr(), 0,
                                  None if ci is None else ci.data_ptr(), bf16,
                                  out.data_ptr(), N, 1, stream)
        _raise_on(rc, "trunk_any_launch")
        fused_trunk_cn.launches_generic += 1
        fused_trunk_cn.launches_generic_cimg += c_img_cn is not None
        return out
    blob, _, (x, f, ci) = _trunk_operands(tp, p_cn, feats_cn, c_img_cn,
                                          store_dtype=store_dtype)
    lib = _lib()
    _check_smem(lib.trunk_smem_bytes, blob)
    rc = lib.trunk_cn_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]),
        x.data_ptr(), f.data_ptr(), None if ci is None else ci.data_ptr(),
        bf16, out.data_ptr(), N, stream)
    _raise_on(rc, "trunk_cn_launch")
    fused_trunk_cn.launches += 1
    fused_trunk_cn.launches_cimg += c_img_cn is not None
    return out


fused_trunk_cn.launches = 0
fused_trunk_cn.launches_cimg = 0
fused_trunk_cn.launches_generic = 0
fused_trunk_cn.launches_generic_cimg = 0


def fused_trunk_cn_batched(tp, p_cn, feats_bcn, *, store_dtype=None):
    """K2 over B objects in one launch: the JAX package's ``fused_trunk_cn``
    under ``vmap`` (an object axis on the features). p_cn (3, N), shared by
    every object (the dense grid), or (B, 3, N); feats_bcn (B, C, N) →
    (B, N) float32 logits, for any N and widths. The plain version is
    ``trunk_cn`` per object."""
    if p_cn.device.type == "cpu":
        f, p = _stored(feats_bcn, store_dtype), _stored(p_cn, store_dtype)
        out = torch.empty((f.shape[0], f.shape[-1]), dtype=torch.float32)
        for b in range(len(f)):
            out[b] = FT.trunk_cn(tp, p if p.dim() == 2 else p[b], f[b])
        return out
    if feats_bcn.dim() != 3 or p_cn.dim() not in (2, 3):
        raise ValueError(f"features must be (B, C, N) and coords (3, N) or (B, 3, N), "
                         f"got {tuple(feats_bcn.shape)} and {tuple(p_cn.shape)}")
    B, C, N = feats_bcn.shape
    shared = p_cn.dim() == 2
    if not shared and p_cn.shape[0] != B:
        raise ValueError(f"coords for {p_cn.shape[0]} objects, features for {B}")
    _check(tp, p_cn if shared else p_cn[0], C, feats_bcn[0])
    out = torch.empty((B, N), dtype=torch.float32, device=p_cn.device)
    if B == 0 or N == 0:
        return out
    x, f = _streamed(p_cn, store_dtype), _streamed(feats_bcn, store_dtype)
    bf16 = int(store_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(p_cn.device).cuda_stream
    if not _tile_chain(tp, C):
        lib, head, _keep = _any_operands(tp, C, 0)
        rc = lib.trunk_any_launch(*head, x.data_ptr(), 0 if shared else 3 * N,
                                  f.data_ptr(), C * N, None, bf16, out.data_ptr(), N,
                                  B, stream)
        _raise_on(rc, "trunk_any_launch")
        fused_trunk_cn_batched.launches_generic += 1
        return out
    blob, _ = _window_operands(tp, 0)
    lib = _lib()
    _check_smem(lib.trunk_smem_bytes, blob)
    rc = lib.trunk_cn_batched_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]), B, x.data_ptr(),
        0 if shared else 3 * N, f.data_ptr(), bf16, out.data_ptr(), N, stream)
    _raise_on(rc, "trunk_cn_batched_launch")
    fused_trunk_cn_batched.launches += 1
    return out


fused_trunk_cn_batched.launches = 0
fused_trunk_cn_batched.launches_generic = 0


def fused_trunk_gated_cn(tp, p_cn, feats_cn, gate_pts, gate_feat, gate_valid,
                         *, radius=0.015, store_dtype=None):
    """K1: contact gating + trunk in one kernel; the same function as
    ``gate_contact_cn`` feeding ``trunk_cn`` with the fc_p_img projection.

    gate_pts (F, K, 3) contact points, gate_feat (F, Ci) finger features,
    gate_valid (F, K) bool, any K >= 1. Returns (N,) float32 logits. Fastest on
    points in lattice or super-cell order, whose tiles of ``WINDOW_TILE``
    consecutive points keep few contacts; right in any order."""
    if p_cn.device.type == "cpu":
        p = _stored(p_cn, store_dtype)
        c_img = FT.gate_contact_cn(p, gate_pts, gate_feat, gate_valid, radius)
        return FT.trunk_cn(tp, p, _stored(feats_cn, store_dtype), c_img)
    C = feats_cn.shape[0]
    N = _check(tp, p_cn, C, feats_cn)
    if any(t.device != p_cn.device for t in (gate_pts, gate_feat, gate_valid)):
        raise ValueError("coords and contacts must share one device")
    n_fingers, K, _ = gate_pts.shape
    bf16 = int(store_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(p_cn.device).cuda_stream
    out = torch.empty(N, dtype=torch.float32, device=p_cn.device)
    if not _tile_chain(tp, C):
        lib, head, _keep = _any_operands(tp, C, 2, gate=(gate_pts, gate_feat, gate_valid),
                                         radius=radius)
        x, f = _streamed(p_cn, store_dtype), _streamed(feats_cn, store_dtype)
        rc = lib.trunk_any_launch(*head, x.data_ptr(), 0, f.data_ptr(), 0, None, bf16,
                                  out.data_ptr(), N, 1, stream)
        _raise_on(rc, "trunk_any_launch")
        fused_trunk_gated_cn.launches_generic += 1
        return out
    blob, contacts, (x, f, _) = _trunk_operands(
        tp, p_cn, feats_cn, gate=(gate_pts, gate_feat, gate_valid),
        store_dtype=store_dtype)
    lib = _lib()
    _check_smem(lib.trunk_smem_bytes, blob)
    rc = lib.trunk_gated_cn_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]), n_fingers, K,
        float(radius) * float(radius), contacts.data_ptr(), x.data_ptr(),
        f.data_ptr(), bf16, out.data_ptr(), N, stream)
    _raise_on(rc, "trunk_gated_cn_launch")
    fused_trunk_gated_cn.launches += 1
    return out


fused_trunk_gated_cn.launches = 0
fused_trunk_gated_cn.launches_generic = 0


def _window_operands(tp, mode, gate=None):
    """(blob, contacts) of the tile kernels in ``mode`` (0 coords, 1 c_img
    rows, 2 gated with ``gate`` = (gate_pts, gate_feat, gate_valid)): the
    blob is ``pack_window_params``'s, in mode 2 followed by W_img g_f per
    finger;
    the contacts (mode 2, else None) are the (F K, 4) rows (q, |q|²) in
    finger order, |q|² replaced by -1 on invalid rows."""
    blob, w_img = pack_window_params(tp, with_img=mode != 0, img_rows=mode == 1)
    if mode != 2:
        return blob, None
    gate_pts, gate_feat, gate_valid = gate
    gproj = gate_feat.float() @ w_img.T                  # (F, h): W_img g_f
    return torch.cat([blob, gproj.reshape(-1)]), _contact_rows(gate_pts, gate_valid)


def window_gate_candidates(p_cn, gate_pts, gate_valid, radius=0.015,
                           tile=WINDOW_TILE):
    """The contacts the gated tile kernels (K1, K4) keep for each tile of
    ``tile`` consecutive points, by their rule, in f32: the valid contacts
    q whose squared distance to the box of the tile's points is at most
    r² + 2^-19 (|q|² + P² + r²), P² the largest |p|² of the box (the
    margin covers the rounding of the expanded distance: ``tile_gate`` in
    csrc/tile_chain.cuh). A ragged last tile boxes its real points. p_cn (3, N), gate_pts
    (F, K, 3), gate_valid (F, K) → (n_tiles, F, K) bool."""
    n_f, K, _ = gate_pts.shape
    N = p_cn.shape[1]
    n_tiles = -(-N // tile)
    p = p_cn.float()
    p = torch.cat([p, p[:, -1:].expand(3, n_tiles * tile - N)], dim=1)
    p = p.reshape(3, n_tiles, tile)
    lo, hi = p.amin(dim=2), p.amax(dim=2)                   # (3, n_tiles)
    big = torch.maximum(lo * lo, hi * hi)
    P2 = big[0] + big[1] + big[2]
    q = gate_pts.reshape(n_f * K, 3).float().to(p.device)
    q2 = torch.sum(q * q, dim=1)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=p.device)
    keep = []
    chunk = 4096                      # tiles at a time: (3, F K, chunk) floats
    for s in range(0, n_tiles, chunk):
        l, h = lo[:, None, s:s + chunk], hi[:, None, s:s + chunk]
        d = q.T[:, :, None] - torch.minimum(torch.maximum(q.T[:, :, None], l), h)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]            # (F K, tiles)
        keep.append(d2 <= r2 + 2.0 ** -19 * (q2[:, None] + P2[None, s:s + chunk] + r2))
    keep = torch.cat(keep, dim=1) & gate_valid.reshape(-1, 1).to(p.device)
    return keep.T.reshape(n_tiles, n_f, K)


def window_box_edge_contacts(p_cn, seed, n_fingers=5, K=128, radius=0.015,
                             tile=WINDOW_TILE):
    """(n_fingers, K, 3) f32 contacts on ``p_cn``'s device that probe the
    culling's margin: each r (1 ± 1e-6) from the box of one of the kernels'
    tiles of ``p_cn`` (its first tile when it holds fewer points), out from
    the middle of a face or out along the diagonal of a corner."""
    g = torch.Generator().manual_seed(seed)
    n_tiles = max(p_cn.shape[1] // tile, 1)
    box = p_cn[:, :n_tiles * tile].reshape(3, n_tiles, -1).double().cpu()
    lo, hi = box.amin(2), box.amax(2)
    shape = (n_fingers, K)
    t = torch.randint(0, n_tiles, shape, generator=g)
    kind = torch.randint(0, 8, shape, generator=g)
    s = radius * (1 + 1e-6 * (2 * torch.randint(0, 2, shape, generator=g) - 1))
    lo, hi = lo[:, t], hi[:, t]                                  # (3, F, K)
    q = (lo + hi) / 2
    for axis in range(3):
        q[axis] = torch.where(kind == 2 * axis, hi[axis] + s, q[axis])
        q[axis] = torch.where(kind == 2 * axis + 1, lo[axis] - s, q[axis])
        q[axis] = torch.where(kind == 6, hi[axis] + s / 3 ** 0.5, q[axis])
        q[axis] = torch.where(kind == 7, lo[axis] - s / 3 ** 0.5, q[axis])
    return q.permute(1, 2, 0).float().to(p_cn.device)


def window_trunk_plain(tp, grid, p_cn, *, reso, padding, L, S, tile,
                       c_img_cn=None, gate_pts=None, gate_feat=None,
                       gate_valid=None, radius=0.015, keys_out=None):
    """The function K3/K4 compute, in plain PyTorch: the corner-gather
    features (``scattered_grid_features_cn``) into ``trunk_cn``, with
    ``gate_contact_cn`` for K4, and the window overflow count."""
    keys = supercell_keys(p_cn, reso, padding, L)
    if keys_out is not None:
        keys_out.copy_(keys)
    n_overflow = window_overflow(keys, tile, S, window_blocks(reso, L, S))
    feats = scattered_grid_features_cn(grid, p_cn, padding)
    if gate_pts is not None:
        c_img_cn = FT.gate_contact_cn(p_cn, gate_pts, gate_feat, gate_valid,
                                      radius)
    return FT.trunk_cn(tp, p_cn, feats, c_img_cn), n_overflow


def fused_trunk_window_cn(tp, grid, p_cn, *, reso, padding, L, S, tile,
                          c_img_cn=None, gate_pts=None, gate_feat=None,
                          gate_valid=None, radius=0.015, keys_out=None):
    """K3 (ungated, optionally with c_img rows) and K4 (contact-gated): the
    trunk at arbitrary points with the trilinear interpolation of ``grid``
    fused in. The contract of the JAX package's ``fused_trunk_window_cn``.

    grid (R, R, R, C) f32 channels-last (``reso`` = R); p_cn (3, N) f32
    world coords, any N, in super-cell order (``supercell_keys`` at L) for
    speed: the kernel is right in any order, but sorted tiles of
    ``WINDOW_TILE`` points share grid cells and keep few contacts;
    c_img_cn (Ci, N) extra input-projection rows (fc_p_img weights), or the
    gate_* contact gating (fc_p_img, as ``fused_trunk_gated_cn``), not both.
    Returns ``(logits (N,) f32, n_overflow)``: n_overflow, a 0-dim int64
    tensor, counts the points whose super-cell lies outside their tile's
    2S window (tiles of ``tile`` consecutive points, windows as the JAX
    kernel places them). The kernel's logits are right for every point
    whatever the count; the count tells the caller that its plan and the
    keys disagree, as it tells the JAX caller that the TPU kernel's were
    clamped. ``keys_out`` (N,) int32, if given, receives the keys the count
    was taken from: the kernel's own on CUDA. On CUDA a NaN coordinate
    reads as 0 where the plain version gives NaN."""
    if gate_pts is not None and c_img_cn is not None:
        raise ValueError("c_img rows and contact gating are exclusive")
    gated = gate_pts is not None
    if p_cn.device.type == "cpu":
        return window_trunk_plain(
            tp, grid, p_cn, reso=reso, padding=padding, L=L, S=S, tile=tile,
            c_img_cn=c_img_cn, gate_pts=gate_pts, gate_feat=gate_feat,
            gate_valid=gate_valid, radius=radius, keys_out=keys_out)
    if gated:
        n_fingers, K, _ = gate_pts.shape
        mode = 2
    else:
        n_fingers = K = 0
        mode = 0 if c_img_cn is None else 1
    if grid.shape != (reso,) * 3 + (grid.shape[-1],) or grid.dtype != torch.float32:
        raise ValueError(f"grid must be ({reso},)*3 + (C,) float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if p_cn.dtype != torch.float32:
        raise ValueError(f"coords must be float32, got {p_cn.dtype}")
    C = grid.shape[-1]
    N = _check(tp, p_cn, C, c_img=c_img_cn)
    if grid.device != p_cn.device or (gated and gate_pts.device != p_cn.device):
        raise ValueError("coords, grid and contacts must share one device")
    x = p_cn.contiguous()
    g = grid.contiguous()
    ci = None if c_img_cn is None else _streamed(c_img_cn, None)
    keys = keys_out if keys_out is not None else torch.empty(
        N, dtype=torch.int32, device=p_cn.device)
    if (keys.shape != (N,) or keys.dtype != torch.int32
            or keys.device != p_cn.device or not keys.is_contiguous()):
        raise ValueError("keys_out must be a contiguous (N,) int32 tensor on "
                         "the coords' device")
    out = torch.empty(N, dtype=torch.float32, device=p_cn.device)
    n1 = -(-(reso - 1) // L)
    box_eps = float(np.float32(1 + padding + 10e-4))
    u_hi = float(np.float32(1 - 10e-4))
    stream = torch.cuda.current_stream(p_cn.device).cuda_stream
    gate = (gate_pts, gate_feat, gate_valid) if gated else None
    if not _tile_chain(tp, C, c_img_cn):
        lib, head, _keep = _any_operands(
            tp, C, mode, 0 if ci is None else ci.shape[0], gate=gate, radius=radius)
        scratch = torch.empty((C, N), dtype=torch.float32, device=p_cn.device)
        rc = lib.trunk_any_window_launch(
            *head, x.data_ptr(), g.data_ptr(), reso, box_eps, u_hi, L, n1,
            None if ci is None else ci.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            keys.data_ptr(), N, stream)
        _raise_on(rc, "trunk_any_window_launch")
        if gated:
            fused_trunk_window_cn.launches_generic_gated += 1
        else:
            fused_trunk_window_cn.launches_generic += 1
            fused_trunk_window_cn.launches_generic_cimg += c_img_cn is not None
        return out, window_overflow(keys, tile, S, window_blocks(reso, L, S))
    blob, contacts = _window_operands(tp, mode, gate)
    lib = _window_lib()
    _check_smem(lib.window_smem_bytes, blob)
    rc = lib.window_cn_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]), n_fingers, K,
        float(radius) * float(radius), mode,
        None if contacts is None else contacts.data_ptr(), x.data_ptr(),
        g.data_ptr(), reso, box_eps, u_hi,
        L, n1, None if ci is None else ci.data_ptr(), out.data_ptr(),
        keys.data_ptr(), N, stream)
    _raise_on(rc, "window_cn_launch")
    if gated:
        fused_trunk_window_cn.launches_gated += 1
    else:
        fused_trunk_window_cn.launches += 1
        fused_trunk_window_cn.launches_cimg += c_img_cn is not None
    return out, window_overflow(keys, tile, S, window_blocks(reso, L, S))


fused_trunk_window_cn.launches = 0
fused_trunk_window_cn.launches_gated = 0
fused_trunk_window_cn.launches_cimg = 0
fused_trunk_window_cn.launches_generic = 0
fused_trunk_window_cn.launches_generic_gated = 0
fused_trunk_window_cn.launches_generic_cimg = 0
