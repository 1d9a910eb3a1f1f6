"""An in-memory LRU of decoded npz files for the input pipeline (port of
vtaco_tpu/data/npz_cache.py).

The data fields read the same ``points.npz`` and ``pointcloud.npz`` of a
model every epoch (the random transforms differ per access, the arrays on
disk do not), and decompressing them can keep the loader's workers from
feeding the card. ``load_npz`` keeps the decoded arrays, as read-only
views, up to ``VTACO_NPZ_CACHE_MB`` megabytes (default 2048; 0 turns the
cache off), evicting the least recently used file first. The cache is
per process and thread-safe.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

_LOCK = threading.Lock()
_CACHE: "OrderedDict[str, dict]" = OrderedDict()
_SIZE = 0


def _limit_bytes():
    return int(os.environ.get("VTACO_NPZ_CACHE_MB", "2048")) * 1024 * 1024


def _nbytes(d):
    return sum(v.nbytes for v in d.values() if hasattr(v, "nbytes"))


def load_npz(path: str) -> dict:
    """``np.load`` of ``path`` as a dict of arrays, from the cache when it
    holds the file (its arrays read-only there); a copy of its own when the
    cache is off."""
    global _SIZE
    limit = _limit_bytes()
    if limit <= 0:
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files}
    with _LOCK:
        if path in _CACHE:
            _CACHE.move_to_end(path)
            return _CACHE[path]
    with np.load(path, allow_pickle=True) as z:
        data = {k: z[k] for k in z.files}
    for v in data.values():
        if hasattr(v, "setflags"):
            v.setflags(write=False)
    with _LOCK:
        if path in _CACHE:
            # another thread read it meanwhile: keep its entry, which the
            # size already counts
            _CACHE.move_to_end(path)
            return _CACHE[path]
        _CACHE[path] = data
        _SIZE += _nbytes(data)
        while _SIZE > limit and len(_CACHE) > 1:
            _, old = _CACHE.popitem(last=False)
            _SIZE -= _nbytes(old)
    return data


def clear():
    """Empty the cache."""
    global _SIZE
    with _LOCK:
        _CACHE.clear()
        _SIZE = 0
