# Frozen copy of vtaco_tpu_torch/models/init.py, kept as the benchmark's plain
# reference: it imports nothing of the port and is never edited to follow it.
"""The JAX package's parameter initializers on torch tensors, and the
layers that draw their parameters with them.

flax's defaults, which the JAX package keeps for every layer it does not
name an initializer for: ``lecun_normal`` kernels (a normal cut at ±2 of
its std, the std scaled up by 1/0.87962566103423978 so that the cut
normal's std is 1/√fan_in) and zero biases for ``Dense``, ``Conv`` and
``ConvTranspose``; ones and zeros for the norms' scales and biases; a
normal of std 1/√features for ``Embed``. The JAX package's own
(vtaco_tpu/models/layers.py:25-27, models/fusion.py:37-40):
``kaiming_out`` (a normal of std √(2/fan_out)) for the ResNets'
convolutions, ``xavier_normal`` (std √(2/(fan_in + fan_out))) for the
U-Nets' convolutions, a zero kernel for ResnetBlockFC's ``fc_1`` and the
fusion's relation normal (std √(2/key_dim)).

Each initializer takes a tensor in PyTorch's layout and the
``torch.Generator`` to draw from (None: PyTorch's default generator for
the tensor's device). The fans are flax's, from its kernel layout: a
Linear's (out, in) weight is flax's (in, out) kernel, fan_in = in; a
ConvNd's (out, in, *k) is flax's (*k, in, out), fan_in = in·∏k and
fan_out = out·∏k; a ConvTransposeNd's (in, out, *k) is also flax's (*k,
in, out), fan_in = in·∏k (``transposed``), where PyTorch's own fan
computation would take ``out``.

``Linear``, ``Conv1d``/``2d``/``3d``, ``ConvTranspose2d`` and
``Embedding`` are torch's layers whose ``reset_parameters(generator)``
(which torch calls at construction, with PyTorch's default generator)
draws ``kernel_init`` (default lecun_normal_; embed_normal_ for
Embedding) and ``bias_init`` (default zeros_).
``init_params(module, generator)`` draws every parameter of a module
again that way and resets BatchNorm's running statistics.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

# the std of a standard normal cut at ±2 (flax's truncated_normal)
TRUNC_STD = 0.87962566103423978


def fans(w, transposed=False):
    """(fan_in, fan_out) of a weight in PyTorch's layout, as flax computes
    them from its kernel: (out, in, *k), or (in, out, *k) ``transposed``."""
    field = math.prod(w.shape[2:])
    out_ch, in_ch = (w.shape[1], w.shape[0]) if transposed else w.shape[:2]
    return in_ch * field, out_ch * field


@torch.no_grad()
def normal_(w, generator=None, transposed=False, std=1.0):
    return w.normal_(0.0, std, generator=generator)


@torch.no_grad()
def lecun_normal_(w, generator=None, transposed=False):
    std = fans(w, transposed)[0] ** -0.5 / TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def kaiming_out_(w, generator=None, transposed=False):
    return normal_(w, generator, std=(2.0 / fans(w, transposed)[1]) ** 0.5)


def xavier_normal_(w, generator=None, transposed=False):
    return normal_(w, generator, std=(2.0 / sum(fans(w, transposed))) ** 0.5)


def relation_normal(key_dim):
    """The fusion's relation-unit kernels: a normal of std √(2/key_dim)."""
    return functools.partial(normal_, std=(2.0 / key_dim) ** 0.5)


def embed_normal_(w, generator=None, transposed=False):
    """flax's Embed: a normal of std 1/√features on (num_embeddings,
    features)."""
    return normal_(w, generator, std=w.shape[1] ** -0.5)


@torch.no_grad()
def zeros_(w, generator=None, transposed=False):
    return w.zero_()


@torch.no_grad()
def ones_(w, generator=None, transposed=False):
    return w.fill_(1.0)


class Drawn:
    """A layer (a torch layer, or a module holding ``weight`` and
    ``bias``) whose reset_parameters draws ``kernel_init`` and
    ``bias_init`` from ``generator``."""

    def __init__(self, *args, kernel_init=lecun_normal_, bias_init=zeros_, **kwargs):
        self.kernel_init, self.bias_init = kernel_init, bias_init
        super().__init__(*args, **kwargs)

    def reset_parameters(self, generator=None):
        transposed = getattr(self, "transposed", False)
        self.kernel_init(self.weight, generator, transposed)
        if getattr(self, "bias", None) is not None:
            self.bias_init(self.bias, generator, transposed)


class Linear(Drawn, nn.Linear):
    pass


class Conv1d(Drawn, nn.Conv1d):
    pass


class Conv2d(Drawn, nn.Conv2d):
    pass


class Conv3d(Drawn, nn.Conv3d):
    pass


class ConvTranspose2d(Drawn, nn.ConvTranspose2d):
    pass


class Embedding(Drawn, nn.Embedding):
    def __init__(self, *args, kernel_init=embed_normal_, **kwargs):
        super().__init__(*args, kernel_init=kernel_init, **kwargs)


def init_params(module, generator=None):
    """Draw every parameter of ``module`` again as its layers draw them at
    construction, from ``generator`` (None: PyTorch's default generator
    of each parameter's device), and reset BatchNorm's running
    statistics. Returns the module."""
    for m in module.modules():
        if isinstance(m, Drawn):
            m.reset_parameters(generator)
        elif hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return module
