"""Counting the host's waits for the card in a call
(``torch.cuda.set_sync_debug_mode``), for the checks that a fused block of
training steps runs without one."""

from __future__ import annotations

import warnings

import torch


def host_syncs(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` with torch's synchronization debugging on:
    (its result, [(file, line) of each synchronizing call]). The mode sees
    the waits that torch's own CUDA operations report, such as ``.item()``,
    ``.cpu()`` and data-dependent shapes."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [(w.filename, w.lineno) for w in seen
                 if "called a synchronizing CUDA operation" in str(w.message)]
