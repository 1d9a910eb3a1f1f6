"""3D U-Net that smooths the object feature volume (port of
vtaco_tpu/models/unet3d.py: SingleConv, DoubleConv, Abstract3DUNet,
UNet3D).

Conv order ``'gcr'`` (GroupNorm on the input channels, bias-free conv,
ReLU), GroupNorm eps 1e-5, max-pool down, nearest up with concat joins, a
1x1x1 final conv. Convolutions are plain ``nn.Conv3d``: the JAX package's
SmallChannelConv3 is a TPU layout workaround with the same parameters.
Layout NCDHW.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def number_of_features_per_level(init_channels: int, num_levels: int):
    return [init_channels * 2 ** k for k in range(num_levels)]


class SingleConv(nn.Sequential):
    """One conv layer assembled from an order string of 'g' (GroupNorm),
    'c' (conv, bias only without a norm) and 'r' (ReLU)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, order="gcr",
                 num_groups=8, padding=1):
        super().__init__()
        if set(order) - set("gcr"):
            raise NotImplementedError(
                f"unet3d layer order {order!r}: only 'g', 'c', 'r' are ported")
        has_norm = "g" in order
        ch = in_ch
        for i, op in enumerate(order):
            if op == "r":
                self.add_module("ReLU", nn.ReLU())
            elif op == "c":
                self.add_module("conv", nn.Conv3d(ch, out_ch, kernel_size,
                                                  padding=padding,
                                                  bias=not has_norm))
                ch = out_ch
            else:  # GroupNorm over the channels present at this position
                groups = num_groups if ch >= num_groups else 1
                self.add_module("groupnorm", nn.GroupNorm(groups, ch, eps=1e-5))


class DoubleConv(nn.Module):
    """Two SingleConvs; on the encoder path the first goes to
    max(out/2, in) channels, on the decoder path both go to out."""

    def __init__(self, in_ch, out_ch, encoder, kernel_size=3, order="gcr",
                 num_groups=8):
        super().__init__()
        mid = max(out_ch // 2, in_ch) if encoder else out_ch
        self.SingleConv1 = SingleConv(in_ch, mid, kernel_size, order, num_groups)
        self.SingleConv2 = SingleConv(mid, out_ch, kernel_size, order, num_groups)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class _Level(nn.Module):
    """Holds one level's DoubleConv under the reference's ``basic_module``
    name (encoders.i.basic_module / decoders.i.basic_module)."""

    def __init__(self, basic_module):
        super().__init__()
        self.basic_module = basic_module

    def forward(self, x):
        return self.basic_module(x)


class Abstract3DUNet(nn.Module):
    def __init__(self, in_channels, out_channels, f_maps=64, layer_order="gcr",
                 num_groups=8, num_levels=4):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.encoders = nn.ModuleList()
        ch = in_channels
        for out_f in f_maps:
            self.encoders.append(_Level(DoubleConv(
                ch, out_f, True, order=layer_order, num_groups=num_groups)))
            ch = out_f
        rev = list(reversed(f_maps))
        self.decoders = nn.ModuleList(
            _Level(DoubleConv(rev[i] + rev[i + 1], rev[i + 1], False,
                              order=layer_order, num_groups=num_groups))
            for i in range(len(rev) - 1))
        self.final_conv = nn.Conv3d(f_maps[0], out_channels, 1)

    def forward(self, x):
        feats = []
        for i, enc in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2)
            x = enc(x)
            feats.insert(0, x)
        for dec, enc_f in zip(self.decoders, feats[1:]):
            x = F.interpolate(x, size=enc_f.shape[2:], mode="nearest")
            x = dec(torch.cat([enc_f, x], dim=1))
        return self.final_conv(x)


class UNet3D(Abstract3DUNet):
    """Standard 3D U-Net (DoubleConv + nearest upsampling)."""


def build_unet3d(kwargs: dict) -> UNet3D:
    """UNet3D from reference-style unet3d_kwargs (final_sigmoid and
    is_segmentation are inactive at inference and ignored)."""
    kw = dict(kwargs)
    kw.pop("final_sigmoid", None)
    kw.pop("is_segmentation", None)
    return UNet3D(**kw)
