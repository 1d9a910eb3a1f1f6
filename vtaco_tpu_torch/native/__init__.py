"""Native C++ host extensions of the port (a copy of the MISE part of
vtaco_tpu/native/__init__.py: the g++ build :57-71 and the ``_Mise`` facade
:372-422).

``mise.cpp`` (the MISE bookkeeping engine, standard library only) is
compiled by g++ (``-O3 -std=c++17 -shared -fPIC -pthread``) at first use
into ``vtaco_tpu_torch/_build/`` (listed in .gitignore), under a name that
carries the hash of the source, so an edited source is rebuilt and a stale
library is never loaded. A failed build or load raises: there is no numpy
fallback on the serving paths.

One lock serializes the build and the load: the first calls into the
extension may come from several ``host_map`` worker threads at once, and
two g++ runs writing one library, or a load of a half-written file, must
not happen.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_BUILD_LOCK = threading.Lock()


def _target(name: str) -> str:
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_and_load(name: str) -> ctypes.CDLL:
    """native/<name>.cpp's library, compiled first if missing. Call under
    _BUILD_LOCK. Raises RuntimeError when g++ is missing or fails."""
    target = _target(name)
    if not os.path.exists(target):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, os.path.join(_DIR, f"{name}.cpp"),
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stderr}")
        os.replace(tmp, target)
    return ctypes.CDLL(target)


class _Mise:
    """ctypes facade over the MISE bookkeeping engine (mise.cpp): one
    handle per object under refinement; generate/mise.py's
    MultiGridExtractorNative wraps it."""

    def __init__(self):
        self._lib = None

    def _ensure(self):
        if self._lib is None:
            with _BUILD_LOCK:
                if self._lib is None:
                    self._lib = self._load()
        return self._lib

    @staticmethod
    def _load():
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        c_f = ctypes.POINTER(ctypes.c_float)
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        lib = build_and_load("mise")
        lib.vtaco_mise_new.restype = vp
        lib.vtaco_mise_new.argtypes = [i64, ctypes.c_float, ctypes.c_int]
        lib.vtaco_mise_free.argtypes = [vp]
        lib.vtaco_mise_resolution.restype = i64
        lib.vtaco_mise_resolution.argtypes = [vp]
        lib.vtaco_mise_query_count.restype = i64
        lib.vtaco_mise_query_count.argtypes = [vp]
        lib.vtaco_mise_query_copy.argtypes = [vp, c_i32]
        lib.vtaco_mise_query_copy_cn.restype = i64
        lib.vtaco_mise_query_copy_cn.argtypes = [vp, ctypes.POINTER(ctypes.c_int16), i64]
        lib.vtaco_mise_update.argtypes = [vp, c_i32, c_f, i64]
        lib.vtaco_mise_update_queried.argtypes = [vp, c_f]
        lib.vtaco_mise_increase.argtypes = [vp]
        lib.vtaco_mise_values.argtypes = [vp, c_f]
        lib.vtaco_mise_values_ptr.restype = vp
        lib.vtaco_mise_values_ptr.argtypes = [vp]
        lib.vtaco_mise_known.argtypes = [vp, ctypes.POINTER(ctypes.c_uint8)]
        return lib


mise = _Mise()
