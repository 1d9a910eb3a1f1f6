"""YAML configs with recursive ``inherit_from`` chaining and deep merge.

Port of vtaco_tpu/core/config.py:25-98, so the repo's configs load
unchanged. The factory surface (get_model / get_generator) lives in
core/factory.py (get_model, get_trainer, get_generator, get_inferencer)
and is re-exported here, with get_dataset, as in the JAX package.
``DEFAULT_CONFIG`` is the repo's configs/default.yaml, by path.
"""

from __future__ import annotations

import os
from typing import Optional

import yaml

from vtaco_tpu_torch.core.factory import (  # noqa: F401
    get_generator, get_inferencer, get_model, get_trainer)

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "default.yaml")


def get_dataset(mode, cfg, return_idx=False):
    from vtaco_tpu_torch.data.core import get_dataset as _get_dataset

    return _get_dataset(mode, cfg, return_idx=return_idx)


def load_config(path: str, default_path: Optional[str] = None) -> dict:
    """Load a YAML config, following ``inherit_from`` chains."""
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # relative to cwd, or else to the including file's directory and
        # its two parents (…/configs/<exp>/x.yaml → repo root)
        if not os.path.exists(inherit_from) and not os.path.isabs(inherit_from):
            base = os.path.dirname(os.path.abspath(path))
            for up in (base, os.path.dirname(base),
                       os.path.dirname(os.path.dirname(base))):
                cand = os.path.join(up, inherit_from)
                if os.path.exists(cand):
                    inherit_from = cand
                    break
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = dict()

    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: dict, dict2: dict) -> None:
    """Deep-merge dict2 into dict1."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
