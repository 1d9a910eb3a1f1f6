"""The (data, model) device mesh and the rows each rank takes (port of
vtaco_tpu/parallel/mesh.py).

The JAX package is one process that drives every local chip, and GSPMD
runs one program over the global batch. The port runs one process per
card in one torch.distributed group, and computes what that program
computes:

  * every rank of a host builds the same global batch (the same loader
    and seed) and takes its data index's rows of it (``batch_rows``);
    a batch whose leading axis does not divide ``data`` is replicated,
    every rank computing all of it (the B = 1 evaluation batches);
  * whatever couples rows (train-mode BatchNorm, the depth min-max
    normalization, the loss means, the gradients) is reduced over the
    data group, so that a data-parallel step equals the one-device step
    on the global batch;
  * with ``data.shard_by_process`` each host loads its own shard of the
    model list (parallel/multihost.py), and the global batch is hosts ×
    ``batch_size``, as ``jax.process_count()`` makes it there.

Ranks are laid out row-major over (data, model), as
``np.asarray(devices).reshape(data, model)`` lays out the JAX mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.device_mesh import DeviceMesh

from vtaco_tpu_torch.parallel.multihost import process_shard


class Mesh(DeviceMesh):
    """A DeviceMesh with dims ("data", "model") whose ``shape`` maps each
    dim to its size, as a jax.sharding.Mesh's does."""

    @property
    def shape(self):
        return dict(zip(self.mesh_dim_names, self.mesh.shape))


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the first data × model ranks of the
    group; data -1 takes every rank left (world // model). Cards run
    NCCL, the CPU gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed group "
                           "(parallel.multihost.initialize_distributed)")
    n = dist.get_world_size()
    if data == -1:
        data = n // model
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(device_type, np.arange(data * model).reshape(data, model),
                mesh_dim_names=("data", "model"))


def mesh_shape_from_config(cfg, batch_size: Optional[int], n_devices: int):
    """``training.mesh`` → (data, model), or None for one device: data -1
    means every device (n_devices // model), clamped down to the largest
    count that divides ``batch_size`` (vtaco_tpu/parallel/mesh.py:42-61)."""
    mcfg = (cfg.get("training") or {}).get("mesh")
    if not mcfg:
        return None
    data = mcfg.get("data", -1)
    model = mcfg.get("model", 1) or 1
    if data == -1:
        data = n_devices // model
        if batch_size is not None:
            while data > 1 and batch_size % data:
                data -= 1
    if (data or 1) <= 1 and model <= 1:
        return None
    return data, model


def mesh_from_config(cfg, batch_size: Optional[int] = None) -> Optional[Mesh]:
    """The training mesh of ``training.mesh`` over the group's ranks (one
    device without a group), or None when both axes are 1 (one card keeps
    the plain path). A mesh the group cannot hold raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape_from_config(cfg, batch_size, world)
    return None if shape is None else make_mesh(*shape)


def data_group(mesh):
    """This rank's process group along the mesh's data axis."""
    return mesh.get_group("data")


@torch.no_grad()
def broadcast_module(module, mesh):
    """The module's parameters and buffers from the first rank of its data
    group, then of its model group: every rank of the mesh starts from
    the same values."""
    by_dtype = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for dim in ("data", "model"):
        group = mesh.get_group(dim)
        if dist.get_world_size(group) == 1:
            continue
        src = dist.get_process_group_ranks(group)[0]
        for ts in by_dtype.values():
            flat = _flatten_dense_tensors([t.data for t in ts])
            dist.broadcast(flat, src, group=group)
            torch._foreach_copy_(ts, _unflatten_dense_tensors(flat, ts))


class Rows(NamedTuple):
    """This rank's rows of a batch: global rows [start, stop) of ``total``,
    its share of a batch split over the data axis, or all of a
    ``replicated`` one; the host's batch begins at global row
    ``host_start``."""
    start: int
    stop: int
    total: int
    host_start: int = 0
    replicated: bool = False

    @property
    def local(self) -> slice:
        """The rows in the host's batch."""
        return slice(self.start - self.host_start, self.stop - self.host_start)

    def take(self, x):
        """This rank's rows of a host batch's array or tensor."""
        return x[self.local]

    def draw(self, x):
        """This rank's rows of a draw made for the whole global batch."""
        return x[self.start:self.stop]


def batch_rows(n: int, mesh) -> Rows:
    """This rank's rows of a host batch of ``n`` rows: its data index's
    share of the global batch (hosts × n rows, parallel/multihost.py)
    when that divides the data axis, else all of it (replicated, which
    needs one host: other hosts hold other rows)."""
    host, hosts = process_shard()
    total = n * hosts
    data = mesh.shape["data"]
    if total % data:
        if hosts > 1:
            raise ValueError(f"a batch of {total} rows over {hosts} hosts does not "
                             f"divide the data axis ({data})")
        return Rows(0, n, n, replicated=True)
    per = total // data
    d = mesh.get_coordinate()[0]
    rows = Rows(d * per, (d + 1) * per, total, host * n)
    if rows.local.start < 0 or rows.local.stop > n:
        raise ValueError(f"data rank {d}'s rows {rows.start}:{rows.stop} are not on "
                         f"host {host}")
    return rows


def shard_batch(mesh, tree):
    """Each leaf (dict entries, list or tuple items) cut to this rank's
    rows of its leading axis (batch_rows)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return batch_rows(len(tree), mesh).take(tree)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its backward sums the gradient over the
    group likewise (every rank's sum reads every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``'s ranks, with autograd."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """x of every rank of ``group`` (equal shapes) concatenated along dim
    0 in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def gather_rows(x: torch.Tensor, mesh, rows: Rows) -> torch.Tensor:
    """Every data rank's rows of x (this rank's are ``rows``) in rank
    order: the whole batch on every rank. A replicated x is returned as
    it is."""
    return x if rows.replicated else all_gather_cat(x, data_group(mesh))
