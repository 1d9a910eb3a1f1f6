"""Checkpoint IO (port of vtaco_tpu/core/checkpoint.py:22-152).

A checkpoint is one ``torch.save`` file: the ``state_dict()`` of every
registered object (the model and its optimizer) and the scalars the
train loop keeps (``epoch_it``, ``it``, ``loss_val_best``) under
``_scalars``. Relative file names resolve against the checkpoint
directory. Files are written to a temporary name and renamed, so a
crash never leaves half a checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


class CheckpointIO:
    def __init__(self, checkpoint_dir="./chkpts", **kwargs):
        self.module_dict: Dict[str, Any] = kwargs
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **kwargs):
        self.module_dict.update(kwargs)

    def _path(self, filename):
        return filename if os.path.isabs(filename) else os.path.join(
            self.checkpoint_dir, filename)

    def save(self, filename, **scalars):
        payload = {k: v.state_dict() for k, v in self.module_dict.items()}
        payload["_scalars"] = dict(scalars)
        path = self._path(filename)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def load_raw(self, filename):
        """(payload without scalars, scalars) of a checkpoint file, with no
        object to load it into: for partial restores such as the
        pretrained-t2d graft. A missing file raises FileNotFoundError."""
        path = self._path(filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return payload, payload.pop("_scalars", {})

    def load(self, filename):
        """Load every registered object that the file holds (load_state_dict,
        strict) and return the scalars."""
        payload, scalars = self.load_raw(filename)
        for k, obj in self.module_dict.items():
            if k in payload:
                obj.load_state_dict(payload[k])
            else:
                print(f"Warning: could not find {k} in checkpoint!")
        return scalars
