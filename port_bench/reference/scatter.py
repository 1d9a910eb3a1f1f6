# Frozen copy of vtaco_tpu_torch/ops/scatter.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""Point → cell pooling through ``Tensor.scatter_reduce``
(port of vtaco_tpu/ops/scatter.py:24-73).

Per-point features are (B, N, C); pooled cells are (B, S, C). Empty cells
are 0 in both reductions (``include_self=False`` on a zero tensor leaves
them untouched).
"""

from __future__ import annotations

import torch


def _pool(src, index, num_cells: int, reduce: str):
    B, N, C = src.shape
    out = src.new_zeros((B, num_cells, C))
    idx = index[..., None].expand(B, N, C)
    return out.scatter_reduce(1, idx, src, reduce=reduce, include_self=False)


def scatter_mean(src, index, num_cells: int):
    """Mean-pool (B, N, C) features into (B, num_cells, C) by int64 (B, N)
    cell ids."""
    return _pool(src, index, num_cells, "mean")


def scatter_max(src, index, num_cells: int):
    """Max-pool (B, N, C) features into (B, num_cells, C)."""
    return _pool(src, index, num_cells, "amax")


def gather_cells(cells, index):
    """(B, S, C) pooled features gathered back to (B, N, C) points."""
    B, N = index.shape
    return torch.gather(cells, 1, index[..., None].expand(B, N, cells.shape[-1]))
