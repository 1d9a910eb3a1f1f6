"""Fused decoder-trunk kernels for Hopper, with their plain versions
(port of vtaco_tpu/ops/pallas/decode.py: ``pack_trunk_params`` :35-61,
``fused_trunk_cn`` :457 and ``fused_trunk_gated_cn`` :538).

Both kernels live in ``csrc/trunk.cu`` (see its header for what bounds
them on the card and how the design answers it); this module packs the
weights, checks the inputs and launches them through ctypes.

Wrapper contract: CPU tensors take the plain PyTorch version in
ops/fast_trunk.py (the function the kernel computes); CUDA tensors launch
the kernel or raise — nothing falls back. Each wrapper counts its launches
in ``<wrapper>.launches``, incremented only where the kernel is launched.
``store_dtype=torch.bfloat16`` stores the streamed per-point operands as
bf16 (coords, features, c_img) while all math stays f32; the plain path
rounds the same operands the same way.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import build

WIDTHS = (32, 32)  # (hidden, C) the kernel is instantiated for
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def pack_trunk_params(tp, with_img: bool):
    """extract_trunk_params output → (blob, w_img).

    ``blob`` is the flat f32 weight array in the kernel's layout
    (csrc/trunk.cu, ``Layout``): wc | w0 | w1 | wp (coord columns + b_in)
    | bc | b0 | b1 | w_out | b_out padded to 4. ``w_img`` is the (h, C)
    c_img half of the fc_p_img projection, or None for the fc_p packing."""
    w_in, b_in = tp["fc_p_img"] if with_img else tp["fc_p"]
    w_in = w_in.float()
    w_out, b_out = tp["fc_out"]
    blocks = tp["blocks"]
    parts = [
        torch.stack([w for w, _ in tp["fc_c"]]),
        torch.stack([blk[0] for blk in blocks]),
        torch.stack([blk[2] for blk in blocks]),
        torch.cat([w_in[:, :3], b_in.float()[:, None]], dim=1),
        torch.stack([b for _, b in tp["fc_c"]]),
        torch.stack([blk[1] for blk in blocks]),
        torch.stack([blk[3] for blk in blocks]),
        w_out.reshape(-1),
        torch.cat([b_out.reshape(1), b_out.new_zeros(3)]),
    ]
    blob = torch.cat([t.float().reshape(-1) for t in parts])
    return blob, (w_in[:, 3:].contiguous() if with_img else None)


def _stored(x, store_dtype):
    """The f32 values a kernel reads from `x` stored as `store_dtype`."""
    x = x.float()
    return x if store_dtype is None else x.to(store_dtype).float()


@functools.cache
def _lib():
    lib = build.library("trunk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.trunk_cn_launch.argtypes = [P, I, I, I, I, P, P, P, I, P,
                                    ctypes.c_longlong, P]
    lib.trunk_cn_launch.restype = I
    lib.trunk_gated_cn_launch.argtypes = [P, I, I, I, I, I, I, ctypes.c_float,
                                          P, P, I, P, ctypes.c_longlong, P]
    lib.trunk_gated_cn_launch.restype = I
    return lib


def _check(tp, p_cn, feats_cn, blob):
    dev = p_cn.device
    if dev.type != "cuda":
        raise ValueError(f"the trunk kernels take CUDA or CPU tensors, got {dev}")
    C, N = feats_cn.shape
    h = tp["fc_out"][0].shape[1]
    if (h, C) != WIDTHS:
        raise NotImplementedError(
            f"the CUDA trunk is instantiated for hidden = C = 32 (every "
            f"LocalDecoder config in configs/); got hidden={h}, C={C}")
    if p_cn.shape != (3, N):
        raise ValueError(f"coords must be (3, {N}), got {tuple(p_cn.shape)}")
    if feats_cn.device != dev or blob.device != dev:
        raise ValueError("coords, features and weights must share one device")
    if blob.numel() * 4 > SMEM_LIMIT:
        raise ValueError(f"{blob.numel() * 4} B of weights exceed shared memory")
    return N


def _streamed(x, store_dtype):
    return x.to(store_dtype or torch.float32).contiguous()


def _pad4(t):
    return torch.cat([t, t.new_zeros((-t.numel()) % 4)])


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def fused_trunk_cn(tp, p_cn, feats_cn, c_img_cn=None, *, store_dtype=None):
    """K2: the ungated fused trunk. p_cn (3, N), feats_cn (C, N), optional
    c_img_cn (C, N) → (N,) float32 logits, for any N."""
    if p_cn.device.type == "cpu":
        c_img = None if c_img_cn is None else _stored(c_img_cn, store_dtype)
        return FT.trunk_cn(tp, _stored(p_cn, store_dtype),
                           _stored(feats_cn, store_dtype), c_img)
    blob, w_img = pack_trunk_params(tp, with_img=c_img_cn is not None)
    if w_img is not None:
        blob = torch.cat([blob, w_img.reshape(-1)])
    blob = _pad4(blob)
    N = _check(tp, p_cn, feats_cn, blob)
    x = _streamed(p_cn, store_dtype)
    f = _streamed(feats_cn, store_dtype)
    ci = None if c_img_cn is None else _streamed(c_img_cn, store_dtype)
    out = torch.empty(N, dtype=torch.float32, device=p_cn.device)
    rc = _lib().trunk_cn_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]),
        x.data_ptr(), f.data_ptr(), None if ci is None else ci.data_ptr(),
        int(store_dtype == torch.bfloat16), out.data_ptr(), N,
        torch.cuda.current_stream(p_cn.device).cuda_stream)
    _raise_on(rc, "trunk_cn_launch")
    fused_trunk_cn.launches += 1
    return out


fused_trunk_cn.launches = 0


def fused_trunk_gated_cn(tp, p_cn, feats_cn, gate_pts, gate_feat, gate_valid,
                         *, radius=0.015, store_dtype=None):
    """K1: contact gating + trunk in one kernel; the same function as
    ``gate_contact_cn`` feeding ``trunk_cn`` with the fc_p_img projection.

    gate_pts (5, K, 3) contact points, gate_feat (5, C) finger features,
    gate_valid (5, K) bool. Returns (N,) float32 logits."""
    if p_cn.device.type == "cpu":
        p = _stored(p_cn, store_dtype)
        c_img = FT.gate_contact_cn(p, gate_pts, gate_feat, gate_valid, radius)
        return FT.trunk_cn(tp, p, _stored(feats_cn, store_dtype), c_img)
    blob, w_img = pack_trunk_params(tp, with_img=True)
    n_fingers, K, _ = gate_pts.shape
    # each finger's valid contacts first, in their order, and their count:
    # the kernel tests only those (an invalid row never gates a point)
    valid = gate_valid.bool()
    order = torch.argsort((~valid).long() * K
                          + torch.arange(K, device=valid.device), dim=1)
    valid = torch.gather(valid, 1, order).reshape(-1)
    q = torch.gather(gate_pts.float(), 1, order[..., None].expand(-1, -1, 3))
    q = q.reshape(n_fingers * K, 3)
    q2 = torch.where(valid, torch.sum(q * q, dim=1), torch.full_like(q[:, 0], 1e30))
    gproj = gate_feat.float() @ w_img.T                  # (5, h): W_img g_f
    count = _pad4(gate_valid.sum(dim=1).float())
    blob = _pad4(torch.cat([blob, gproj.reshape(-1), count,
                            torch.cat([q, q2[:, None]], dim=1).reshape(-1)]))
    N = _check(tp, p_cn, feats_cn, blob)
    x = _streamed(p_cn, store_dtype)
    f = _streamed(feats_cn, store_dtype)
    out = torch.empty(N, dtype=torch.float32, device=p_cn.device)
    rc = _lib().trunk_gated_cn_launch(
        blob.data_ptr(), blob.numel(), 32, 32, len(tp["blocks"]), n_fingers, K,
        float(radius) * float(radius), x.data_ptr(), f.data_ptr(),
        int(store_dtype == torch.bfloat16), out.data_ptr(), N,
        torch.cuda.current_stream(p_cn.device).cuda_stream)
    _raise_on(rc, "trunk_gated_cn_launch")
    fused_trunk_gated_cn.launches += 1
    return out


fused_trunk_gated_cn.launches = 0
