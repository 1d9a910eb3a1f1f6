"""Build the package's CUDA sources into plain-C shared libraries and load
them with ctypes.

Each source under ``vtaco_tpu_torch/csrc/`` becomes one library, compiled
for ``sm_90a`` by ``nvcc`` at first use into ``vtaco_tpu_torch/_build/``
(listed in .gitignore). The library name carries a hash of its source and
of every header under ``csrc/`` (``tile_chain.cuh``, which ``trunk.cu``
and ``window.cu`` include), so an edited source or header is rebuilt and a
stale library is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once, and waits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

SOURCES = ("trunk", "window", "trunk_any")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel. Returns {name: ptxas
    report} for the libraries built by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports = {}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        reports[name] = log
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_target(name))
        _loaded[name] = lib
    return lib
