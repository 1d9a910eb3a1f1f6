"""3D U-Net that smooths the object feature volume (port of
vtaco_tpu/models/unet3d.py: SingleConv, DoubleConv, Abstract3DUNet,
UNet3D).

Conv order ``'gcr'`` (GroupNorm on the input channels, bias-free conv,
ReLU), GroupNorm eps 1e-5, max-pool down, nearest up with concat joins, a
1x1x1 final conv. Convolutions are plain ``nn.Conv3d``: the JAX package's
SmallChannelConv3 is a TPU layout workaround with the same parameters.
Layout NCDHW.

``remat`` (unet3d_kwargs, as in the JAX package: false, true or 'finest')
recomputes each level's DoubleConv in the backward pass
(torch.utils.checkpoint) instead of keeping its activations: every level,
or with 'finest' only the full-resolution ones (the first encoder level
and the last decoder level). Parameter names do not change, so
checkpoints interchange across the settings.

GroupNorm on a bfloat16 input (mixed precision) normalizes in float32,
with the float32 value of its weight and bias, and rounds the result to
bfloat16 once, as flax's GroupNorm does (``force_float32_reductions``).
torch's own GroupNorm does so on the CPU, but its CUDA kernel for
bfloat16 rounds on the way: near zero its outputs stray by up to about
10^6 of their own bfloat16 ulps (chip_smoke.py measures both).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def number_of_features_per_level(init_channels: int, num_levels: int):
    return [init_channels * 2 ** k for k in range(num_levels)]


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm (same parameters) that normalizes a reduced-precision
    input in float32 and casts the result back once."""

    def forward(self, x):
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


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
                self.add_module("groupnorm", GroupNorm(groups, ch, eps=1e-5))


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
    name (encoders.i.basic_module / decoders.i.basic_module); with
    ``remat`` its forward is recomputed in the backward pass."""

    def __init__(self, basic_module, remat=False):
        super().__init__()
        self.basic_module = basic_module
        self.remat = remat

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.basic_module, x, use_reentrant=False)
        return self.basic_module(x)


class Abstract3DUNet(nn.Module):
    def __init__(self, in_channels, out_channels, f_maps=64, layer_order="gcr",
                 num_groups=8, num_levels=4, basic_module="double_conv", remat=False):
        super().__init__()
        if basic_module != "double_conv":
            raise NotImplementedError(
                f"unet3d basic_module {basic_module!r} (ResidualUNet3D) is not "
                "ported yet (ROADMAP.md, item 11)")
        if remat not in (False, True, "finest"):
            raise ValueError(f"unet3d remat must be false, true or 'finest'; got {remat!r}")
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.encoders = nn.ModuleList()
        ch = in_channels
        for i, out_f in enumerate(f_maps):
            self.encoders.append(_Level(DoubleConv(
                ch, out_f, True, order=layer_order, num_groups=num_groups),
                remat=remat is True or (remat == "finest" and i == 0)))
            ch = out_f
        rev = list(reversed(f_maps))
        n_dec = len(rev) - 1
        self.decoders = nn.ModuleList(
            _Level(DoubleConv(rev[i] + rev[i + 1], rev[i + 1], False,
                              order=layer_order, num_groups=num_groups),
                   remat=remat is True or (remat == "finest" and i == n_dec - 1))
            for i in range(n_dec))
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
