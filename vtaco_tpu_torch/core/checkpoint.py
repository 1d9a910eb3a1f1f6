"""Checkpoint IO (port of vtaco_tpu/core/checkpoint.py:22-152).

A checkpoint the port writes is one ``torch.save`` file: the
``state_dict()`` of every registered object (the model and its
optimizer) and the scalars the train loop keeps (``epoch_it``, ``it``,
``loss_val_best``) under ``_scalars``. Relative file names resolve
against the checkpoint directory. Files are written to a temporary name
and renamed, so a crash never leaves half a checkpoint. ``save_async``
copies the state to the host at once and writes it on one background
thread, the pending saves in order; ``wait`` blocks until they are on
disk.

``load`` and ``load_raw`` also read the JAX package's checkpoints (flax
msgpack, read by core/flax_msgpack.py with no JAX installed), telling the
two formats apart by the file's first bytes: torch.save's zip header
``PK\\x03\\x04`` or a msgpack map header. A JAX file loads into the
registered ``model`` and ``optimizer`` through
``weights.jax_checkpoint_to_torch``; its ``load_raw`` gives the
``{"model": state_dict}`` a torch file gives, for partial restores. An
http(s) file name is fetched into the checkpoint directory first, once,
cached by its base name.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Any, Dict

import numpy as np
import torch

from vtaco_tpu_torch.core import flax_msgpack
from vtaco_tpu_torch.core.weights import jax_checkpoint_to_torch, jax_state_dict

ZIP_MAGIC = b"PK\x03\x04"


def _to_py(v):
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _host_copy(obj):
    """A copy of a state_dict on the host that later updates of the live
    objects do not reach."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write(payload, path):
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


class CheckpointIO:
    def __init__(self, checkpoint_dir="./chkpts", **kwargs):
        self.module_dict: Dict[str, Any] = kwargs
        self.checkpoint_dir = checkpoint_dir
        self._pool = None
        self._pending = []
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **kwargs):
        self.module_dict.update(kwargs)

    def _path(self, filename):
        return filename if os.path.isabs(filename) else os.path.join(
            self.checkpoint_dir, filename)

    def _payload(self, scalars):
        payload = {k: v.state_dict() for k, v in self.module_dict.items()}
        payload["_scalars"] = dict(scalars)
        return payload

    def save(self, filename, **scalars):
        _write(self._payload(scalars), self._path(filename))

    def save_async(self, filename, **scalars):
        """Non-blocking save: the state is copied to the host now (the
        caller may update it right after), and written on a background
        thread, one save after another in the order they were asked for.
        Returns a Future."""
        payload = _host_copy(self._payload(scalars))
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="ckpt")
        fut = self._pool.submit(_write, payload, self._path(filename))
        self._pending.append(fut)
        return fut

    def wait(self):
        """Block until every pending save is written; a failed save raises
        here."""
        if self._pool is None:
            return
        self._pool.shutdown(wait=True)
        self._pool = None
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def _download(self, url: str) -> str:
        """Fetch a checkpoint URL into the checkpoint directory, once
        (cached by its base name), and return that name. Without network
        access the fetch raises URLError saying so."""
        import urllib.error
        import urllib.request

        name = os.path.basename(url.split("?", 1)[0]) or "model.ckpt"
        dest = self._path(name)
        if not os.path.exists(dest):
            tmp = dest + ".tmp"
            try:
                with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
                    while chunk := r.read(1 << 20):
                        f.write(chunk)
            except OSError as e:
                raise urllib.error.URLError(
                    f"checkpoint download failed for {url!r} (no network "
                    f"egress here? download it yourself and pass a path): {e}") from e
            os.replace(tmp, dest)
        return name

    def _read(self, filename):
        """(format, payload) of a checkpoint file: 'torch' and the
        torch.load payload, or 'jax' and the decoded flax tree."""
        if filename.startswith(("http://", "https://")):
            filename = self._download(filename)
        path = self._path(filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            head = f.read(4)
            if head == ZIP_MAGIC:
                f.seek(0)
                return "torch", torch.load(f, map_location="cpu", weights_only=True)
            if flax_msgpack.is_msgpack_map(head):
                f.seek(0)
                return "jax", flax_msgpack.loads(f.read())
        raise ValueError(f"{path} is neither a torch.save zip nor a flax msgpack "
                         f"checkpoint (first bytes {head!r})")

    def load_raw(self, filename):
        """(payload without scalars, scalars) of a checkpoint file, with no
        object to load it into: for partial restores such as the
        pretrained-t2d graft. A JAX file's payload is ``{"model": its
        torch-named state_dict}``. A missing file raises
        FileNotFoundError."""
        kind, payload = self._read(filename)
        scalars = {k: _to_py(v) for k, v in payload.pop("_scalars", {}).items()}
        if kind == "jax":
            payload = {"model": jax_state_dict(payload.get("state", {}))}
        return payload, scalars

    def load(self, filename):
        """Load every registered object that the file holds (load_state_dict,
        strict) and return the scalars. A JAX file loads into the registered
        ``model`` and ``optimizer``."""
        kind, payload = self._read(filename)
        scalars = {k: _to_py(v) for k, v in payload.pop("_scalars", {}).items()}
        if kind == "jax":
            if "model" not in self.module_dict or "state" not in payload:
                print("Warning: could not find model in checkpoint!")
                return scalars
            jax_checkpoint_to_torch(payload, self.module_dict["model"],
                                    self.module_dict.get("optimizer"))
            return scalars
        for k, obj in self.module_dict.items():
            if k in payload:
                obj.load_state_dict(payload[k])
            else:
                print(f"Warning: could not find {k} in checkpoint!")
        return scalars
