"""Host-memory tuning for grid-sized serving allocations (port of
vtaco_tpu/utils/host.py:29-39).

The serving paths churn host buffers far above glibc's mmap threshold:
540 MB value grids at 513³ (generate/mise.py), batched logit fetches,
mesh vertex arrays. glibc returns each such buffer to the OS on free, and
the next allocation faults its pages in again. :func:`enable_heap_reuse`
tells glibc to serve and keep large allocations on the heap, so
grid-sized buffers recycle warm pages from one extraction to the next.
The native MISE engine's block pool (native/mise.cpp) does the same for
its own buffers; this covers numpy's.

The cost: the process's resident memory stays at its high-water mark, so
the serving CLI calls it at start, and importing the package does not.
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def enable_heap_reuse(threshold_bytes: int = 1 << 30) -> bool:
    """Keep allocations below ``threshold_bytes`` on the glibc heap and
    never trim freed space back to the OS. Returns True when applied,
    False where the C library has no ``mallopt`` (not glibc)."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    ok1 = mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
    ok2 = mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
    return bool(ok1 and ok2)
