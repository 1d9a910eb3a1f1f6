"""The decoder trunk in channels-first layout: the plain PyTorch versions
of the CUDA kernels in ops/cuda/decode.py, and the fingertip gates that
feed them c_img rows (port of vtaco_tpu/ops/fast_trunk.py:24-130).

Activations are (C, N) with points on the last axis; every Linear layer
becomes ``W @ X + b``. ``extract_trunk_params`` reads the weights straight
from a LocalDecoder module, whose nn.Linear weights are already in the
(out, in) layout the kernels want. Numerically the same function as
LocalDecoder.forward_feats / forward_img_feats.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_trunk_params(decoder, with_img: bool):
    """The LocalDecoder weights the trunk needs, as (weight (out, in),
    bias) pairs: ``fc_p`` or ``fc_p_img``, per-block ``fc_c`` and
    (fc_0, fc_1), and ``fc_out``."""
    def lin(m):
        return (m.weight.detach(), m.bias.detach())

    if decoder.fc_c is None:
        raise NotImplementedError(
            "the fast routes on a LocalDecoder with c_dim 0: the JAX package's "
            "extract_trunk_params reads fc_c0, which such a decoder lacks, and fails "
            "with a KeyError at vtaco_tpu/ops/fast_trunk.py:33 (F9 (a), ROADMAP.md §3); "
            "use eval_points(fast=False)")
    out = {
        "fc_out": lin(decoder.fc_out),
        "fc_c": [lin(m) for m in decoder.fc_c],
        "blocks": [lin(b.fc_0) + lin(b.fc_1) for b in decoder.blocks],
    }
    out["fc_p_img" if with_img else "fc_p"] = lin(
        decoder.fc_p_img if with_img else decoder.fc_p)
    return out


def _dense_t(x_cn, weight, bias, dtype):
    """(in, N) → (out, N)."""
    y = weight.to(dtype) @ x_cn
    return (y + bias.to(dtype)[:, None]).to(dtype)


def trunk_cn(tp, p_cn, c_cn, c_img_cn=None, dtype=torch.float32, leaky=False):
    """Decoder trunk: (3, N) coords + (C, N) features [+ (C, N) per-point
    tactile features → the fc_p_img projection] → (N,) float32 logits."""
    p_cn = p_cn.to(dtype)
    c_cn = c_cn.to(dtype)
    act = (lambda x: F.leaky_relu(x, 0.2)) if leaky else F.relu
    if c_img_cn is not None:
        x = torch.cat([p_cn, c_img_cn.to(dtype)], dim=0)
        net = _dense_t(x, *tp["fc_p_img"], dtype)
    else:
        net = _dense_t(p_cn, *tp["fc_p"], dtype)
    for (ck, cb), (w0, b0, w1, b1) in zip(tp["fc_c"], tp["blocks"]):
        net = net + _dense_t(c_cn, ck, cb, dtype)
        h = _dense_t(act(net), w0, b0, dtype)
        dx = _dense_t(act(h), w1, b1, dtype)
        net = net + dx
    logits = _dense_t(act(net).to(torch.float32), *tp["fc_out"], torch.float32)
    return logits[0]


def contact_sq_dist(p_cn, gate_pts, gate_valid):
    """(5K, N) squared distances in the expanded form
    ``|q|² + |p|² - 2 q·p``, with invalid contact rows poisoned to 1e30 so
    they never pass a radius test. The CUDA kernel computes the same
    expanded form; the direct ``(p - q)²`` rounds differently and flips
    hits near the radius."""
    F5, K, _ = gate_pts.shape
    q = gate_pts.reshape(F5 * K, 3).to(p_cn.dtype)
    q2 = torch.where(gate_valid.reshape(F5 * K),
                     torch.sum(q * q, dim=1), torch.full_like(q[:, 0], 1e30))
    return q2[:, None] + torch.sum(p_cn * p_cn, dim=0)[None, :] - 2.0 * (q @ p_cn)


def gate_contact_cn(p_cn, gate_pts, gate_feat, gate_valid, radius=0.015):
    """Per-point tactile features (C, N) by contact proximity.

    p_cn (3, N); gate_pts (5, K, 3); gate_valid (5, K); gate_feat (5, C).
    A point takes a finger's feature when any valid contact of that
    finger lies within ``radius``; the last touching finger wins;
    untouched points get zeros."""
    F5, K, _ = gate_pts.shape
    d2 = contact_sq_dist(p_cn, gate_pts, gate_valid)
    within_f = torch.any((d2 < radius * radius).reshape(F5, K, -1), dim=1)
    any_f = torch.any(within_f, dim=0)
    # last touching finger: argmax over the reversed finger axis
    last_f = (F5 - 1) - torch.argmax(within_f.flip(0).to(torch.uint8), dim=0)
    feat = gate_feat.T[:, last_f]                                # (C, N)
    return torch.where(any_f[None, :], feat, torch.zeros_like(feat))


def gate_tips_cn(p_cn, tips, tip_feat, tip_valid, radius=0.05):
    """Per-point tactile features (C, N) by fingertip proximity (VTacOH).

    p_cn (3, N); tips (5, 3); tip_valid (5,) bool (the touching fingers);
    tip_feat (5, C). Each point takes the feature of its nearest fingertip
    when that tip is within ``radius`` and touching, else zeros. The
    squared distances use the expanded form ``|q|² + |p|² - 2 q·p``, as the
    JAX package does; they round differently from ``(p - q)²`` at the
    radius."""
    q = tips.to(p_cn.dtype)
    d2 = (torch.sum(q * q, dim=1)[:, None] + torch.sum(p_cn * p_cn, dim=0)[None, :]
          - 2.0 * (q @ p_cn))                                      # (5, N)
    near = torch.amin(d2, dim=0) < radius * radius
    assign = torch.argmin(d2, dim=0)
    valid = tip_valid[assign] & near
    feat = tip_feat.T[:, assign]                                   # (C, N), a copy
    return feat.masked_fill_(~valid[None, :], 0.0)
