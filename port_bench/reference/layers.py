# Frozen copy of vtaco_tpu_torch/models/layers.py, trimmed to what the benchmark runs and
# kept as its plain reference: it imports nothing of the port and is never
# edited to follow it.
"""Building blocks (port of vtaco_tpu/models/layers.py:30-285): the
fully-connected ResNet block, the from-scratch ResNet-18/34/50/101/152
tactile image encoders (basic and bottleneck blocks) and the tactile
depth U-Net. Parameter names are the reference's
torch names, so a JAX tree carried over by core/weights.py loads with
``strict=True``. Each layer draws its parameters as the JAX package's
does (models/init.py): the ResNets' convolutions ``kaiming_out``, the
U-Net's ``xavier_normal`` with zero biases, ResnetBlockFC's ``fc_1`` a
zero kernel, every other kernel flax's ``lecun_normal`` and every bias
zero. The initializers are re-exported here under the JAX package's
names.

BatchNorm is ``BatchNorm2d`` below (``BatchNorm1d`` on (N, C) rows, and
``batch_norm_last`` on channel-last features): in train mode it computes the batch
statistics, normalizes with them and moves its running statistics as
flax's BatchNorm does: the biased variance in flax's one-pass form
max(E[x²] - E[x]², 0) (torch.nn.BatchNorm2d normalizes with the two-pass
variance and moves its running variance with the unbiased one), and
momentum 0.1 in torch's convention, flax's 0.9. The one-pass form matters
where the batch variance is small beside the squared mean, as for the
tactile U-Net's first convolutions on images scaled to [0, 1/255].
Like flax's ``force_float32_reductions`` (its default), a bfloat16 input
is reduced and normalized in float32 with the float32 value of the scale
and bias, and the result is cast back to bfloat16; the running
statistics stay float32. Inside ``frozen_batch_stats()`` (the
recomputation of a rematerialized forward) the statistics do not move.
Inside ``batch_stats_group(model, group)`` (a data-parallel train step)
the statistics are those of the whole batch across ``group``'s ranks:
the per-channel sums, sums of squares and counts are all-reduced, with
autograd, as GSPMD's mean over the sharded batch axis is global.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
import torch.nn.functional as F

from port_bench.reference.init import Conv2d, Linear, kaiming_out_, xavier_normal_, zeros_


# the JAX package's names (vtaco_tpu/models/layers.py:25-27)
kaiming_out = kaiming_out_
xavier_normal = xavier_normal_

_FROZEN_STATS = [0]   # > 0 while a rematerialized forward is recomputed


@contextlib.contextmanager
def frozen_batch_stats():
    """Train-mode BatchNorm2d normalizes with its batch statistics but
    leaves its running statistics and counter alone: the context of the
    backward pass's recomputation under torch.utils.checkpoint, so that a
    rematerialized step moves them once, as JAX's functional remat does. A
    plain counter, not thread-local: the autograd engine recomputes on its
    own thread on the card."""
    _FROZEN_STATS[0] += 1
    try:
        yield
    finally:
        _FROZEN_STATS[0] -= 1


@contextlib.contextmanager
def batch_stats_group(model, group):
    """Train-mode BatchNorm of ``model`` takes its statistics over the
    whole batch of ``group``'s ranks in the block (None: this rank's
    rows)."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.stats_group = group
    try:
        yield
    finally:
        for m in bns:
            m.stats_group = None


def _batch_moments(x, dims, group):
    """Per-channel E[x] and E[x²] over ``dims``, across ``group``'s ranks
    when it is set."""
    if group is not None:
        raise NotImplementedError("the reference runs in one process: no group")
    return x.mean(dim=dims), (x * x).mean(dim=dims)


def _flax_batch_norm(bn, x, train):
    """BatchNorm over every axis of x but axis 1, as flax's: in ``train``
    the batch statistics (biased one-pass variance) normalize x and move
    the running statistics (unless frozen), else the running ones do."""
    dt = torch.promote_types(x.dtype, torch.float32)
    if not train:
        return F.batch_norm(x.to(dt), bn.running_mean, bn.running_var,
                            bn.weight.to(dt), bn.bias.to(dt), False, 0.0,
                            bn.eps).to(x.dtype)
    dims = (0,) + tuple(range(2, x.dim()))
    view = (-1,) + (1,) * (x.dim() - 2)
    xf = x.to(dt)
    mean, sq = _batch_moments(xf, dims, getattr(bn, "stats_group", None))
    var = torch.clamp(sq - mean * mean, min=0.0)
    if not _FROZEN_STATS[0]:
        with torch.no_grad():
            bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), bn.momentum)
            bn.running_var.lerp_(var.to(bn.running_var.dtype), bn.momentum)
            bn.num_batches_tracked += 1
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(dt)
    y = (xf - mean.view(view)) * mul.view(view) + bn.bias.to(dt).view(view)
    return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        return _flax_batch_norm(self, x, self.training)


class BatchNorm1d(nn.BatchNorm1d):
    """On (N, C) or (N, C, L). ``train`` (default: the module's mode)
    chooses the batch statistics, for callers that, like flax's, pass the
    mode per call."""

    def forward(self, x, train=None):
        return _flax_batch_norm(self, x, self.training if train is None else train)


class ResnetBlockFC(nn.Module):
    """``x_s + fc_1(relu(fc_0(relu(x))))``, fc_1 zero-initialized, and a
    bias-free linear shortcut when the sizes differ."""

    def __init__(self, size_in, size_out=None, size_h=None):
        super().__init__()
        size_out = size_in if size_out is None else size_out
        size_h = min(size_in, size_out) if size_h is None else size_h
        self.fc_0 = Linear(size_in, size_h)
        self.fc_1 = Linear(size_h, size_out, kernel_init=zeros_)
        self.shortcut = (None if size_in == size_out
                         else Linear(size_in, size_out, bias=False))

    def forward(self, x):
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class BasicBlock(nn.Module):
    """ResNet basic block: 3x3 + 3x3 convs, BatchNorm after each."""

    expansion = 1

    def __init__(self, in_ch, channels, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, channels, 3, stride, 1, bias=False,
                            kernel_init=kaiming_out_)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels, 3, 1, 1, bias=False,
                            kernel_init=kaiming_out_)
        self.bn2 = BatchNorm2d(channels)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, channels, 1, stride, bias=False, kernel_init=kaiming_out_),
                BatchNorm2d(channels))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """7x7/2 stem, 3x3/2 max-pool, four stages of ``block`` (BasicBlock
    or Bottleneck), global average pool, then ``Linear(512 * expansion,
    100) -> Linear(100, num_classes)`` with no activation between. A
    stage's first block downsamples where its stride is 2 or its input
    width differs from its output's. Takes NCHW images."""

    def __init__(self, block, blocks_num, num_classes=2):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, kernel_init=kaiming_out_)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for stage, (ch, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                   blocks_num)):
            stride = 1 if stage == 0 else 2
            out_ch = ch * block.expansion
            blocks = [block(in_ch, ch, stride,
                            downsample=stride != 1 or in_ch != out_ch)]
            blocks += [block(out_ch, ch) for _ in range(1, n_blocks)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            in_ch = out_ch
        self.linear = Linear(512 * block.expansion, 100)
        self.fc = Linear(100, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.mean(x, dim=(2, 3))
        return self.fc(self.linear(x))


def Resnet18(num_classes=32):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes=num_classes)


