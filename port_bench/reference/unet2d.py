# Frozen copy of vtaco_tpu_torch/models/unet2d.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""Plain 2D U-Net that smooths the hand encoder's plane features (port of
vtaco_tpu/models/unet2d.py:18-102): two ReLU 3x3 convs per level, 2x2
max-pool down, 2x2 transpose-conv up (``up_mode`` 'transpose') or, with
any other ``up_mode``, bilinear x2 upsampling and a 1x1 conv
(``upconv_1x1``), a concat (or add) merge, a 1x1 final conv, no
normalization and no output activation. Layout NCHW.

The bilinear x2 is ``F.interpolate(align_corners=False)``, which clamps
the source index at the border, where ``jax.image.resize`` renormalizes
its triangle kernel over the taps inside: at x2 both give the edge row
itself (tests/test_torch_options.py shows it).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from port_bench.reference.init import Conv2d, ConvTranspose2d, xavier_normal_


class DownConv(nn.Module):
    def __init__(self, in_ch, out_ch, pooling=True):
        super().__init__()
        self.pooling = pooling
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, kernel_init=xavier_normal_)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, kernel_init=xavier_normal_)

    def forward(self, x):
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        return (F.max_pool2d(x, 2) if self.pooling else x), x


class UpConv(nn.Module):
    def __init__(self, in_ch, out_ch, merge_mode="concat", up_mode="transpose"):
        super().__init__()
        self.merge_mode = merge_mode
        if up_mode == "transpose":
            self.upconv = ConvTranspose2d(in_ch, out_ch, 2, stride=2,
                                          kernel_init=xavier_normal_)
        else:
            self.upconv_1x1 = Conv2d(in_ch, out_ch, 1, kernel_init=xavier_normal_)
        self.conv1 = Conv2d(2 * out_ch if merge_mode == "concat" else out_ch,
                            out_ch, 3, padding=1, kernel_init=xavier_normal_)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, kernel_init=xavier_normal_)

    def merge(self, from_down, from_up):
        if hasattr(self, "upconv"):
            from_up = self.upconv(from_up)
        else:
            from_up = self.upconv_1x1(F.interpolate(from_up, scale_factor=2,
                                                    mode="bilinear", align_corners=False))
        if self.merge_mode == "concat":
            return torch.cat([from_up, from_down], dim=1)
        return from_up + from_down

    def forward(self, from_down, from_up):
        x = self.merge(from_down, from_up)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


def check_unet_modes(merge_mode):
    if merge_mode not in ("concat", "add"):
        raise ValueError(f"U-Net merge_mode {merge_mode!r}")


class UNet2D(nn.Module):
    """``num_classes`` output channels (the encoder passes c_dim)."""

    def __init__(self, num_classes, in_channels=3, depth=4, start_filts=32,
                 up_mode="transpose", merge_mode="concat"):
        super().__init__()
        check_unet_modes(merge_mode)
        self.down_convs = nn.ModuleList()
        outs = in_channels
        for i in range(depth):
            ins, outs = outs, start_filts * 2 ** i
            self.down_convs.append(DownConv(ins, outs, pooling=i < depth - 1))
        self.up_convs = nn.ModuleList()
        for _ in range(depth - 1):
            ins, outs = outs, outs // 2
            self.up_convs.append(UpConv(ins, outs, merge_mode, up_mode))
        self.conv_final = Conv2d(outs, num_classes, 1, kernel_init=xavier_normal_)

    def forward(self, x):
        skips = []
        for down in self.down_convs:
            x, before_pool = down(x)
            skips.append(before_pool)
        for i, up in enumerate(self.up_convs):
            x = up(skips[-(i + 2)], x)
        return self.conv_final(x)
