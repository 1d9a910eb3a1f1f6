"""Tensor parallelism over the mesh's ``model`` axis (port of
vtaco_tpu/parallel/tp.py).

The JAX package commits each wide leaf to a sharding that partitions its
last axis, the output channels of a flax kernel, over ``model`` when that
axis divides evenly with at least MIN_SHARD elements per chip; GSPMD then
partitions the program. The port keeps the rule, on the output-channel
axis of the torch layout: dim 0 of a ``Conv*d`` or ``Linear`` weight,
dim 1 of a ``ConvTranspose*d`` weight, the last dim of other matrices
(an ``Embedding``'s features), dim 0 of a rank-1 parameter. BatchNorm's
running statistics stay whole on every rank (a placement in the JAX
package that changes no value).

Each rank stores its slice of every partitioned parameter (Adam's moments
follow), as the original of a torch parametrization whose value is the
whole tensor, all-gathered over the model group with autograd. So a
layer that reads a partitioned parameter computes with the whole tensor
and its gradient lands on the slice. ``Conv*d``, ``ConvTranspose*d`` and
``Linear`` layers compute column-parallel instead: each rank computes its
output channels from the whole input, then the output is all-gathered
along channels; a copy ahead of the layer (identity forward, all-reduce
backward) sums the input's gradient over the model group. Every rank of
a model group therefore holds the same activations, and the data axis
averages the gradients as without a model axis.
"""

from __future__ import annotations

import contextlib
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

# Minimum elements per chip on the partitioned axis
MIN_SHARD = 16

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def tp_partitioned(size: int, model_size: int, min_shard: int = MIN_SHARD) -> bool:
    """Whether an axis of ``size`` partitions over ``model_size`` ranks
    (vtaco_tpu/parallel/tp.py:45-56)."""
    return model_size > 1 and size % model_size == 0 and size // model_size >= min_shard


def tp_axis(module, name, shape):
    """The torch axis of a parameter that holds the JAX kernel's last axis
    (its output channels)."""
    if len(shape) == 1:
        return 0
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return 1
    if isinstance(module, (nn.modules.conv._ConvNd, nn.Linear)):
        return 0
    return len(shape) - 1


def tp_spec(model: nn.Module, model_size: int, min_shard: int = MIN_SHARD):
    """{parameter name: partitioned axis} of ``model`` under the rule."""
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if parametrize.is_parametrized(m, pname):
                continue
            ax = tp_axis(m, pname, p.shape)
            if p.dim() and tp_partitioned(p.shape[ax], model_size, min_shard):
                out[f"{mname}.{pname}" if mname else pname] = ax
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    model group (each rank's output channels contribute to the input's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherAxis(torch.autograd.Function):
    """All-gather along ``axis`` over the group in rank order; the
    backward takes this rank's part (every rank of the group holds the
    same upstream gradient)."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[axis]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.rank * ctx.n, ctx.n), None, None


class _Gathered(nn.Module):
    """Parametrization whose original is this rank's slice along
    ``axis`` and whose value is the whole tensor."""

    def __init__(self, axis, group):
        super().__init__()
        self.axis, self.group = axis, group

    def forward(self, local):
        return _GatherAxis.apply(local, self.axis, self.group)

    def right_inverse(self, full):
        n = full.shape[self.axis] // dist.get_world_size(self.group)
        return full.narrow(self.axis, dist.get_rank(self.group) * n, n).clone()


def _local(module, name):
    """This rank's slice of a parameter (the swapped one under
    torch.func.functional_call), or the whole unpartitioned one (None
    for a layer without bias)."""
    if parametrize.is_parametrized(module, name):
        return getattr(module.parametrizations, name).original
    return getattr(module, name)


def _column_forward(module, group):
    """The column-parallel forward of a Conv*d, ConvTranspose*d or Linear
    whose weight (and bias) are partitioned, or None where the layer has
    groups."""
    if isinstance(module, nn.Linear):
        def forward(self, x):
            y = F.linear(_CopyToModel.apply(x, group), _local(self, "weight"),
                         _local(self, "bias"))
            return _GatherAxis.apply(y, y.dim() - 1, group)
        return forward
    if getattr(module, "groups", 1) != 1:
        return None
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        conv_t = _CONV_T[len(module.kernel_size)]

        def forward(self, x):
            y = conv_t(_CopyToModel.apply(x, group), _local(self, "weight"),
                       _local(self, "bias"), self.stride, self.padding,
                       self.output_padding, 1, self.dilation)
            return _GatherAxis.apply(y, 1, group)
        return forward

    def forward(self, x):
        y = self._conv_forward(_CopyToModel.apply(x, group), _local(self, "weight"),
                               _local(self, "bias"))
        return _GatherAxis.apply(y, 1, group)
    return forward


def _optimizer_state(optimizer, p, fn):
    """Apply fn to the tensors of p's optimizer state shaped like p."""
    if optimizer is None:
        return
    st = optimizer.state.get(p, {})
    for k, v in st.items():
        if isinstance(v, torch.Tensor) and v.shape == p.shape:
            st[k] = fn(v)


def shard_state(mesh, model, optimizer=None, min_shard: int = MIN_SHARD):
    """Partition ``model``'s parameters over the mesh's model axis (in
    place; the Parameter objects stay, so the optimizer keeps them) and
    slice its optimizer state with them. Returns {name: axis} of the
    partitioned parameters; with ``model`` 1 nothing changes."""
    spec = tp_spec(model, mesh.shape["model"], min_shard)
    if not spec:
        return spec
    group = mesh.get_group("model")
    modules = dict(model.named_modules())
    for name, ax in spec.items():
        mname, _, pname = name.rpartition(".")
        mod = modules[mname]
        p = getattr(mod, pname)
        _optimizer_state(optimizer, p, _Gathered(ax, group).right_inverse)
        p.grad = None
        parametrize.register_parametrization(mod, pname, _Gathered(ax, group), unsafe=True)
    column = []
    for mod in modules.values():
        if parametrize.is_parametrized(mod, "weight") and isinstance(
                mod, (nn.modules.conv._ConvNd, nn.Linear)):
            fwd = _column_forward(mod, group)
            if fwd is not None:
                mod.forward = types.MethodType(fwd, mod)
                column.append(mod)
    model._tp = {"spec": spec, "group": group, "column": column, "mesh": mesh,
                 "min_shard": min_shard}
    return spec


def _unshard_state(model, optimizer=None):
    """Undo shard_state: every partitioned parameter whole again (all-
    gathered: every rank of the model group calls this), with its
    optimizer state."""
    tp = model.__dict__.pop("_tp", None)
    if tp is None:
        return
    for mod in tp["column"]:
        del mod.forward
    modules = dict(model.named_modules())
    for name, ax in tp["spec"].items():
        mname, _, pname = name.rpartition(".")
        mod = modules[mname]
        p = getattr(mod.parametrizations, pname).original
        _optimizer_state(optimizer, p, lambda v: _GatherAxis.apply(v, ax, tp["group"]))
        p.grad = None
        with torch.no_grad():
            parametrize.remove_parametrizations(mod, pname, leave_parametrized=True)


@contextlib.contextmanager
def unsharded(model, optimizer=None):
    """The whole parameters (and optimizer state) in the block, for what
    one rank does alone (a checkpoint, a visualization), which must run
    no collective; every rank enters and leaves it."""
    tp = getattr(model, "_tp", None)
    _unshard_state(model, optimizer)
    try:
        yield
    finally:
        if tp is not None:
            shard_state(tp["mesh"], model, optimizer, tp["min_shard"])
