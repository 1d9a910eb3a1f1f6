"""Encoder and decoder registries, name → constructor (port of
vtaco_tpu/core/registry.py).

``core.factory`` looks a config's ``model.encoder``, ``encoder_hand``,
``encoder_img`` and ``decoder`` names up here, so a module registered by
name is selectable from a config with no change to the factory:

    from vtaco_tpu_torch.core.registry import register_decoder

    @register_decoder("my_decoder")
    class MyDecoder(torch.nn.Module):
        def __init__(self, dim=3, c_dim=128, hidden_size=256, padding=0.1):
            ...

The factory passes each constructor the config keys its signature
declares, as it does for the built-in modules.
"""

from __future__ import annotations

from typing import Callable, Dict

encoder_dict: Dict[str, Callable] = {}
decoder_dict: Dict[str, Callable] = {}


def register_encoder(name: str):
    """Class decorator: the constructor of encoder ``name``."""
    def deco(fn):
        encoder_dict[name] = fn
        return fn

    return deco


def register_decoder(name: str):
    """Class decorator: the constructor of decoder ``name``."""
    def deco(fn):
        decoder_dict[name] = fn
        return fn

    return deco


def _populate():
    from vtaco_tpu_torch.models import decoder as dec
    from vtaco_tpu_torch.models import layers, pointnet, pointnetpp, voxels

    encoder_dict.update({
        "pointnet_local_pool": pointnet.LocalPoolPointnet,
        "pointnet_crop_local_pool": pointnet.PatchLocalPoolPointnet,
        "pointnet_plus_plus": pointnetpp.PointNetPlusPlus,
        "voxel_simple_local": voxels.LocalVoxelEncoder,
        "Resnet18": layers.Resnet18,
        "Resnet34": layers.Resnet34,
        "Resnet50": layers.Resnet50,
        "UNet": layers.TactileUNet,
    })
    decoder_dict.update({
        "simple_local": dec.LocalDecoder,
        "attention_local": dec.AttentionDecoder,
        "simple_local_crop": dec.PatchLocalDecoder,
        "simple_local_point": dec.LocalPointDecoder,
    })


_populate()
