"""Building blocks (port of vtaco_tpu/models/layers.py:30-161): the
fully-connected ResNet block and the from-scratch ResNet-18 tactile image
encoder. Parameter names are the reference's torch names, so a JAX tree
carried over by core/weights.py loads with ``strict=True``. BatchNorm runs
with running statistics (the modules are used in eval mode).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class ResnetBlockFC(nn.Module):
    """``x_s + fc_1(relu(fc_0(relu(x))))``, fc_1 zero-initialized, and a
    bias-free linear shortcut when the sizes differ."""

    def __init__(self, size_in, size_out=None, size_h=None):
        super().__init__()
        size_out = size_in if size_out is None else size_out
        size_h = min(size_in, size_out) if size_h is None else size_h
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)
        self.shortcut = (None if size_in == size_out
                         else nn.Linear(size_in, size_out, bias=False))

    def forward(self, x):
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class BasicBlock(nn.Module):
    """ResNet basic block: 3x3 + 3x3 convs, BatchNorm after each."""

    expansion = 1

    def __init__(self, in_ch, channels, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, channels, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, channels, 1, stride, bias=False),
                nn.BatchNorm2d(channels))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """7x7/2 stem, 3x3/2 max-pool, four stages, global average pool, then
    ``Linear(512, 100) -> Linear(100, num_classes)`` with no activation
    between. Takes NCHW images."""

    def __init__(self, blocks_num, num_classes=2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for stage, (ch, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                   blocks_num)):
            stride = 1 if stage == 0 else 2
            blocks = [BasicBlock(in_ch, ch, stride,
                                 downsample=stride != 1 or in_ch != ch)]
            blocks += [BasicBlock(ch, ch) for _ in range(1, n_blocks)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            in_ch = ch
        self.linear = nn.Linear(512, 100)
        self.fc = nn.Linear(100, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.mean(x, dim=(2, 3))
        return self.fc(self.linear(x))


def Resnet18(num_classes=32):
    return ResNet((2, 2, 2, 2), num_classes=num_classes)
