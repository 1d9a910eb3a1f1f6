"""Weight carry-over from the JAX package's parameter trees.

A flax tree (nested dicts of numpy arrays: ``params`` and
``batch_stats``) is translated to the reference's torch state_dict names
and layouts, then loaded with ``strict=True``. This module keeps its own
copy of the translation in vtaco_tpu/core/torch_import.py
(``_translate_path`` :31-122, ``_LEAF_TO_TORCH`` :160-166, ``_flatten``
:239, ``export_state_dict`` :259-289), since the port imports nothing of
the JAX package.

The translation covers every family's tree: ResNet blocks
(``layer{s}_{b}`` with ``conv3``/``bn3`` and ``down_conv``/``down_bn``),
PointNet++'s ``sa*``/``fp*`` ``mlp{i}`` and ``bn{i}``, the voxel
encoders' ``conv_in``, ``conv_{i}`` and ``fc``, the fusion's shared heads
(``encoder.layers.0.self_attn``, ``decoder.layers.0.cross_attn``) and
positional embeddings, and the index encoder's ``embedding`` (the bare
``encoder.weight``). Where the export's names differ from the
reference's torch names (PointNet++'s ``mlp_convs``/``mlp_bns``), the
port's modules follow the export.

Layouts: Dense kernels (in, out) transpose to (out, in); conv kernels
(*k, I, O) become (O, I, *k) (transpose convs (*k, I, O) become a
spatially flipped (I, O, *k)). The U-Nets' ``upconv_1x1`` (the 1x1 conv
after a bilinear upsampling) is a plain conv here, where the JAX
package's ``export_state_dict`` lays it out as a transpose conv (its name
holds "upconv"), and the order-string index of a layer inside an
ExtResNetBlock's conv1/2/3 is dropped as inside DoubleConv's SingleConvs,
where the JAX package's export keeps it (``conv1.conv1``) when the conv
comes second in the order; BatchNorm ``scale``/``bias`` and
``mean``/``var`` become ``weight``/``bias`` and
``running_mean``/``running_var``.

``jax_checkpoint_to_torch`` loads a whole JAX checkpoint (the payload of
a ``model.ckpt`` that the JAX package's ``CheckpointIO`` writes, read by
core/flax_msgpack.py) into the port's model and optimizer: the
parameters and statistics as above, and optax's state as the torch
optimizer's (Adam's ``mu``/``nu``/``count`` as ``exp_avg``/
``exp_avg_sq``/``step``, SGD's momentum ``trace`` as
``momentum_buffer``), the moments translated like the parameters they
belong to.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np
import torch

def _translate_path(path: Tuple[str, ...]) -> str:
    """flax parameter-tree path → torch dotted name prefix."""
    out = []
    for i, comp in enumerate(path):
        # TransformerFusion: the reference weight-ties its layer clones, so
        # layers.0 is the canonical copy of every shared tensor
        if comp == "self_attn":
            out.append("encoder.layers.0.self_attn")
            continue
        if comp == "cross_attn":
            out.append("decoder.layers.0.cross_attn")
            continue
        if comp == "encoder_pos_embed":
            out.append("encoder.layers.0.self_posembed.position_embedding_head")
            continue
        if comp == "decoder_pos_embed":
            out.append("decoder.layers.0.self_posembed.position_embedding_head")
            continue
        m = re.fullmatch(r"head(\d+)", comp)
        if m:
            out.append(f"head.{m.group(1)}")
            continue
        m = re.fullmatch(r"extra_nonlinear(\d+)", comp)
        if m:
            out.append(f"extra_nonlinear.{m.group(1)}")
            continue
        if i > 0 and path[i - 1].endswith("_pos_embed"):
            # PositionEmbeddingLearned Sequential: Conv1d, BatchNorm1d,
            # ReLU, Conv1d → indices 0, 1, 3
            out.append({"conv1": "0", "bn": "1", "conv2": "3"}[comp])
            continue
        if comp == "embedding":
            continue
        m = re.fullmatch(r"block(\d+)", comp)
        if m:
            out.append(f"blocks.{m.group(1)}")
            continue
        m = re.fullmatch(r"fc_c(\d+)", comp)
        if m:
            out.append(f"fc_c.{m.group(1)}")
            continue
        if comp == "unet_mod":
            out.append("unet")
            continue
        if comp == "unet3d_mod":
            out.append("unet3d")
            continue
        m = re.fullmatch(r"down(\d+)", comp)
        if m:
            out.append(f"down_convs.{m.group(1)}")
            continue
        m = re.fullmatch(r"up(\d+)", comp)
        if m:
            out.append(f"up_convs.{m.group(1)}")
            continue
        m = re.fullmatch(r"enc(\d+)", comp)
        if m:
            out.append(f"encoders.{m.group(1)}.basic_module")
            continue
        m = re.fullmatch(r"dec(\d+)", comp)
        if m:
            out.append(f"decoders.{m.group(1)}.basic_module")
            continue
        m = re.fullmatch(r"layer(\d+)_(\d+)", comp)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
            continue
        if comp == "down_conv":
            out.append("downsample.0")
            continue
        if comp == "down_bn":
            out.append("downsample.1")
            continue
        m = re.fullmatch(r"(conv|groupnorm|batchnorm)(\d+)", comp)
        in_single_conv = i > 0 and bool(
            re.fullmatch(r"SingleConv\d", path[i - 1])
            or (i > 1 and re.fullmatch(r"conv[123]", path[i - 1])
                and re.fullmatch(r"(enc|dec)\d+", path[i - 2])))
        if m and (in_single_conv or comp not in ("conv1", "conv2", "conv3")):
            # UNet3D SingleConv sub-layers (DoubleConv's SingleConv1/2 and
            # ExtResNetBlock's conv1/2/3) drop their order-string index;
            # numbered convs elsewhere (UNet2D, ResNet) keep it
            out.append(m.group(1))
            continue
        out.append(comp)
    return ".".join(out)


_LEAF_TO_TORCH = {
    "kernel": "weight",
    "bias": "bias",
    "scale": "weight",
    "embedding": "weight",
}


def _flatten(tree, prefix=()):
    out = {}
    if hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def export_state_dict(params, batch_stats):
    """flax (params, batch_stats) trees → torch-named numpy state_dict."""
    sd = {}
    for path, leaf in _flatten(params).items():
        prefix = _translate_path(path[:-1])
        leaf_name = path[-1]
        tname = f"{prefix}.{_LEAF_TO_TORCH.get(leaf_name, leaf_name)}"
        v = np.asarray(leaf)
        if leaf_name == "kernel":
            if v.ndim == 2:
                v = v.T
                if "position_embedding_head" in tname:
                    v = v[:, :, None]  # back to the pointwise Conv1d
            elif v.ndim in (4, 5):
                dims = v.ndim - 2
                if ("upconv" in tname and "upconv_1x1" not in tname) or "upsample" in tname:
                    v = v[tuple(slice(None, None, -1) for _ in range(dims))]
                    v = v.transpose((dims, dims + 1) + tuple(range(dims)))
                else:
                    v = v.transpose((dims + 1, dims) + tuple(range(dims)))
        sd[tname] = v
    stat_map = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _flatten(batch_stats).items():
        prefix = _translate_path(path[:-1])
        sd[f"{prefix}.{stat_map.get(path[-1], path[-1])}"] = np.asarray(leaf)
    return sd


def load_jax_params(model, params, batch_stats):
    """Load JAX trees into ``model`` with ``strict=True``: every unmatched
    key, on either side, raises. BatchNorm's ``num_batches_tracked``
    counters have no JAX counterpart and keep the model's own values."""
    own = model.state_dict()
    sd = {}
    for name, v in export_state_dict(params, batch_stats).items():
        like = own.get(name)
        sd[name] = torch.as_tensor(np.ascontiguousarray(v)).to(
            device=like.device if like is not None else "cpu",
            dtype=like.dtype if like is not None else torch.float32)
    for name, t in own.items():
        if name.endswith("num_batches_tracked"):
            sd.setdefault(name, t)
    model.load_state_dict(sd, strict=True)
    return model


def _to_numpy(v):
    """A leaf of a decoded JAX tree as numpy (bfloat16 leaves come as
    torch tensors, numpy has no such type: they widen to float32)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v)


def jax_state_dict(state):
    """The torch-named state_dict (CPU tensors) of a JAX checkpoint's
    ``state``: its ``params`` and ``batch_stats`` through
    ``export_state_dict``."""
    sd = export_state_dict(_map_leaves(state.get("params", {})),
                           _map_leaves(state.get("batch_stats", {})))
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def _map_leaves(tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(v) for k, v in tree.items()}
    return _to_numpy(tree)


_RNG_DROPPED = []


def _moments(model, tree, what):
    """{parameter: tensor} of an optimizer-state tree laid out as the
    parameters (optax's mu, nu, trace), translated like them. Raises if a
    parameter of ``model`` has none."""
    sd = export_state_dict(_map_leaves(tree), {})
    out = {}
    for name, p in model.named_parameters():
        if name not in sd:
            raise ValueError(f"the JAX checkpoint's optimizer state has no {what} "
                             f"for parameter {name}")
        v = torch.as_tensor(np.ascontiguousarray(sd[name]))
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{what} of {name} is {tuple(v.shape)}, the parameter "
                             f"{tuple(p.shape)}")
        out[p] = v.to(device=p.device, dtype=p.dtype)
    return out


def jax_checkpoint_to_torch(payload, model, optimizer=None):
    """Load a JAX checkpoint's payload ({"_scalars", "state": {"params",
    "batch_stats", "opt_state", "step", "rng"}}, as core/flax_msgpack.py
    reads it) into ``model`` (``load_jax_params``: strict, BatchNorm
    counters kept) and, if given, ``optimizer``, the torch optimizer the
    port's Trainer builds for optax's ``adam`` or ``sgd(momentum=0.9)``.
    ``state.rng`` has no torch counterpart and is dropped (printed once);
    the step count travels in the payload's ``_scalars`` (``it``)."""
    state = payload["state"]
    load_jax_params(model, _map_leaves(state["params"]),
                    _map_leaves(state.get("batch_stats", {})))
    if optimizer is not None:
        opt = state.get("opt_state", {}).get("0", {})
        if isinstance(optimizer, torch.optim.Adam) and "mu" in opt:
            mu = _moments(model, opt["mu"], "mu")
            nu = _moments(model, opt["nu"], "nu")
            step = float(_to_numpy(opt["count"]))
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p not in mu:
                        raise ValueError("the optimizer holds a parameter the "
                                         "model does not name")
                    optimizer.state[p] = {
                        "step": torch.tensor(step, dtype=torch.float32),
                        "exp_avg": mu[p], "exp_avg_sq": nu[p]}
        elif isinstance(optimizer, torch.optim.SGD) and "trace" in opt:
            trace = _moments(model, opt["trace"], "trace")
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p not in trace:
                        raise ValueError("the optimizer holds a parameter the "
                                         "model does not name")
                    optimizer.state[p] = {"momentum_buffer": trace[p]}
        else:
            raise ValueError(f"the JAX optimizer state {sorted(opt)} does not map onto "
                             f"{type(optimizer).__name__}")
    if "rng" in state and not _RNG_DROPPED:
        _RNG_DROPPED.append(True)
        print("Note: the JAX checkpoint's PRNG key (state.rng) has no torch "
              "counterpart and is dropped: a resumed run draws other random "
              "numbers than the JAX package would")
