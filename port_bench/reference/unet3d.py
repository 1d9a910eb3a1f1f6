# Frozen copy of vtaco_tpu_torch/models/unet3d.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""3D U-Net that smooths the object feature volume (port of
vtaco_tpu/models/unet3d.py: SingleConv, DoubleConv, ExtResNetBlock,
Abstract3DUNet, UNet3D, ResidualUNet3D).

A conv order string of ``'g'`` (GroupNorm over the channels present at
its position, eps 1e-5), ``'b'`` (BatchNorm as flax's: momentum 0.9,
biased variance, the whole batch's statistics under
``models.layers.batch_stats_group``), ``'c'`` (the conv, bias-free after a
norm) and ``'r'``, ``'l'`` (leaky, slope 0.1) or ``'e'`` (ELU); the
default ``'gcr'``. With ``basic_module`` 'double_conv' (UNet3D): max-pool
down, nearest up with concat joins, a 1x1x1 final conv. With
'ext_resnet' (ResidualUNet3D): ExtResNetBlocks, whose decoder levels
upsample by a stride-2 transposed conv (``up_convs``) and join by a sum;
that conv returns 2n - 1 voxels where the skip holds 2n, so the JAX
package fails at the first join, and the port raises there (F9 (c),
ROADMAP.md §3): only one level runs. Convolutions are plain ``Conv3d``s: the JAX package's
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

from port_bench.reference.init import Conv3d, Drawn
from port_bench.reference.layers import _flax_batch_norm


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


class BatchNorm3d(nn.BatchNorm3d):
    """flax's BatchNorm on NCDHW (momentum 0.9, the biased variance)."""

    def forward(self, x):
        return _flax_batch_norm(self, x, self.training)


_ACTIVATIONS = {"r": ("ReLU", nn.ReLU), "l": ("LeakyReLU", lambda: nn.LeakyReLU(0.1)),
                "e": ("ELU", nn.ELU)}


class SingleConv(nn.Sequential):
    """One conv layer assembled from an order string of 'g' (GroupNorm),
    'b' (BatchNorm), 'c' (conv, bias only without a norm) and 'r', 'l' or
    'e' (activations)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, order="gcr",
                 num_groups=8, padding=1):
        super().__init__()
        if set(order) - set("gbcrle"):
            raise ValueError(f"unet3d layer order {order!r}: unsupported layer type")
        has_norm = "g" in order or "b" in order
        ch = in_ch
        for op in order:
            if op in _ACTIVATIONS:
                name, act = _ACTIVATIONS[op]
                self.add_module(name, act())
            elif op == "c":
                self.add_module("conv", Conv3d(ch, out_ch, kernel_size,
                                               padding=padding,
                                               bias=not has_norm))
                ch = out_ch
            elif op == "b":
                self.add_module("batchnorm", BatchNorm3d(ch, eps=1e-5, momentum=0.1))
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


class ExtResNetBlock(nn.Module):
    """The residual block of ResidualUNet3D: conv1's output is the
    residual, conv2, then conv3 without the activation, the sum, then the
    order's activation (ReLU when it names none)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, order="cge", num_groups=8):
        super().__init__()
        self.conv1 = SingleConv(in_ch, out_ch, kernel_size, order, num_groups)
        self.conv2 = SingleConv(out_ch, out_ch, kernel_size, order, num_groups)
        self.conv3 = SingleConv(out_ch, out_ch, kernel_size,
                                "".join(c for c in order if c not in "rel"), num_groups)
        self.act = (nn.LeakyReLU(0.1) if "l" in order else nn.ELU() if "e" in order
                    else nn.ReLU())

    def forward(self, x):
        residual = self.conv1(x)
        return self.act(self.conv3(self.conv2(residual)) + residual)


class _UpConv3d(Drawn, nn.Module):
    """flax's ConvTranspose(k=3, stride 2, padding 1): the kernel (O, I, 3,
    3, 3), unflipped, correlated with the input dilated by 2 and padded by
    one voxel; n voxels become 2n - 1. Drawn as flax draws the kernel (*k,
    I, O): fan_in = 27 I."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters()

    def forward(self, x):
        return F.conv_transpose3d(x, self.weight.flip(2, 3, 4).transpose(0, 1), self.bias,
                                  stride=2, padding=1)


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
        if basic_module not in ("double_conv", "ext_resnet"):
            raise ValueError(f"unet3d basic_module {basic_module!r}")
        if remat not in (False, True, "finest"):
            raise ValueError(f"unet3d remat must be false, true or 'finest'; got {remat!r}")
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.residual = basic_module == "ext_resnet"

        def block(ins, outs, encoder):
            if self.residual:
                return ExtResNetBlock(ins, outs, order=layer_order, num_groups=num_groups)
            return DoubleConv(ins, outs, encoder, order=layer_order, num_groups=num_groups)

        self.encoders = nn.ModuleList()
        ch = in_channels
        for i, out_f in enumerate(f_maps):
            self.encoders.append(_Level(block(ch, out_f, True),
                                        remat=remat is True or (remat == "finest" and i == 0)))
            ch = out_f
        rev = list(reversed(f_maps))
        n_dec = len(rev) - 1
        self.decoders = nn.ModuleList(
            _Level(block(rev[i + 1] if self.residual else rev[i] + rev[i + 1], rev[i + 1],
                         False),
                   remat=remat is True or (remat == "finest" and i == n_dec - 1))
            for i in range(n_dec))
        if self.residual:
            self.up_convs = nn.ModuleList(_UpConv3d(rev[i], rev[i + 1]) for i in range(n_dec))
        self.final_conv = Conv3d(f_maps[0], out_channels, 1)

    def forward(self, x):
        feats = []
        for i, enc in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2)
            x = enc(x)
            feats.insert(0, x)
        for i, (dec, enc_f) in enumerate(zip(self.decoders, feats[1:])):
            if self.residual:
                tgt = enc_f.shape[2:]
                x = self.up_convs[i](x)[:, :, :tgt[0], :tgt[1], :tgt[2]]
                if x.shape != enc_f.shape:
                    raise NotImplementedError(
                        f"ResidualUNet3D's join of a {tuple(x.shape[2:])} upsampling to a "
                        f"{tuple(tgt)} skip: the JAX package's transposed conv returns "
                        "2n - 1 voxels and its sum fails at "
                        "vtaco_tpu/models/unet3d.py:265 (F9 (c), ROADMAP.md §3)")
                x = dec(enc_f + x)
            else:
                x = F.interpolate(x, size=enc_f.shape[2:], mode="nearest")
                x = dec(torch.cat([enc_f, x], dim=1))
        return self.final_conv(x)


class UNet3D(Abstract3DUNet):
    """Standard 3D U-Net (DoubleConv + nearest upsampling)."""


class ResidualUNet3D(Abstract3DUNet):
    """Residual 3D U-Net (ExtResNetBlock + transposed-conv upsampling)."""

    def __init__(self, in_channels, out_channels, f_maps=64, layer_order="gcr",
                 num_groups=8, num_levels=5, basic_module="ext_resnet", remat=False):
        super().__init__(in_channels, out_channels, f_maps, layer_order, num_groups,
                         num_levels, basic_module, remat)


def build_unet3d(kwargs: dict) -> UNet3D:
    """UNet3D from reference-style unet3d_kwargs (``basic_module``
    'ext_resnet' makes it residual, as the JAX package's does;
    final_sigmoid and is_segmentation are inactive at inference and
    ignored)."""
    kw = dict(kwargs)
    kw.pop("final_sigmoid", None)
    kw.pop("is_segmentation", None)
    return UNet3D(**kw)
