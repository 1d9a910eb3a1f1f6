"""Local voxel coordinates and the NeRF positional encoding of the crop
models (port of vtaco_tpu/ops/local_coords.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

_L = 10
FREQ_BANDS = tuple(float(f) for f in (2.0 ** np.linspace(0, _L - 1, _L)) * math.pi)


def positional_encoding(p, basis_function: str = "sin_cos"):
    """(..., D) coords in [0, 1] → (..., 2L·D) sin/cos over L = 10 octave
    bands of ``2p - 1`` ('sin_cos'), or p itself (any other name)."""
    if basis_function != "sin_cos":
        return p
    p = 2.0 * p - 1.0
    out = []
    for freq in FREQ_BANDS:
        out.append(torch.sin(freq * p))
        out.append(torch.cos(freq * p))
    return torch.cat(out, dim=-1)


def map2local(p, s: float, pos_encoding: str = "linear"):
    """Points → their position in their voxel of side ``s``, in [0, 1)
    (``remainder`` takes the divisor's sign, as jnp.remainder does, so a
    negative coordinate maps into [0, 1) too), then encoded."""
    return positional_encoding(torch.remainder(p, s) / s, pos_encoding)
