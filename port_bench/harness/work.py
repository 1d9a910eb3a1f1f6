"""The work the kernels' inputs need, counted from shapes, and the least
time the card could take for it.

The decoder chain (``simple_local``: hidden = C, n_blocks blocks) on N
points needs, per point, two operations per multiply-add of every layer:
the input projection of the coords (3 x h, with a bias), n_blocks
feature projections (C x h) and residual blocks (two h x h), and the head
(h x 1). The tactile rows of fingertip gating (K2 c_img) add a C x h
product on each point whose row is not zero; contact gating (K1) adds
nothing per point that these inputs need beyond the chain (the gated
points take a per-finger vector that the kernel forms once), and no
distance test is counted, since a kernel may cull every one. Bytes: the
coords, features (and c_img rows) read once in the stored dtype, the
float32 logits written once.

A roofline share is the least time, the larger of operations over the
TF32 tensor peak and bytes over the HBM peak (harness/device.py), over
the kernel time measured for the same work.
"""

from __future__ import annotations

from port_bench.harness.device import PEAK_BYTES, PEAK_FLOPS


def chain_flops(n_points: int, hidden: int, c_dim: int, n_blocks: int) -> int:
    per_point = 2 * (3 * hidden + n_blocks * (c_dim * hidden + 2 * hidden * hidden) + hidden)
    return n_points * per_point


def k1_work(n_points, hidden, c_dim, n_blocks, store_bytes=4) -> tuple:
    """(operations, bytes) of K1 (contact-gated trunk) on n_points."""
    flops = chain_flops(n_points, hidden, c_dim, n_blocks)
    return flops, n_points * ((3 + c_dim) * store_bytes + 4)


def k2_cimg_work(n_points, n_rows, hidden, c_dim, n_blocks, c_img_dim, store_bytes=4):
    """(operations, bytes) of K2 with c_img rows on n_points, n_rows of
    which carry a tactile feature."""
    flops = chain_flops(n_points, hidden, c_dim, n_blocks) + 2 * n_rows * c_img_dim * hidden
    return flops, n_points * ((3 + c_dim + c_img_dim) * store_bytes + 4)


def k2_batched_work(n_objects, n_points, hidden, c_dim, n_blocks, store_bytes=4):
    """(operations, bytes) of K2 over n_objects sharing one grid of
    n_points coords."""
    flops = n_objects * chain_flops(n_points, hidden, c_dim, n_blocks)
    return flops, 3 * n_points * store_bytes + n_objects * n_points * (c_dim * store_bytes + 4)


def least_s(flops, nbytes) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_pct(flops, nbytes, seconds):
    """The share of the roofline in %, or None where nothing was timed."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_s(flops, nbytes) / seconds


def model_flops(fn, *args, **kw):
    """(fn's result, the floating operations of its matrix products and
    convolutions), counted by torch's FlopCounterMode from the shapes of
    the calls fn makes."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kw)
    return out, counter.get_total_flops()
