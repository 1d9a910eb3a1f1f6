"""The process group and the input shard of a host (port of
vtaco_tpu/parallel/multihost.py).

The JAX package runs one process per host, which drives that host's
chips; its ``data.shard_by_process`` gives each host a strided shard of
the model list, and the global batch is hosts × ``batch_size``. The port
runs one process per card, so a host runs several ranks: they share
their host's shard, and each takes its rows of the host's batch
(parallel/mesh.batch_rows). The group follows torchrun's environment
contract (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK):
torchrun sets it, and ``initialize_distributed`` sets LOCAL_WORLD_SIZE
and GROUP_RANK for the groups it makes itself, so that ``process_shard``
reads one contract.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, auto=None, *, local_rank=0, local_size=1,
                           init_method=None):
    """Join or make the process group, once per process; a second call
    is a no-op, as is a single-host call with nothing to coordinate.
    Modes, in order:

    * torchrun (WORLD_SIZE > 1 in the environment), or ``auto`` (or
      VTACO_DISTRIBUTED=1), the JAX CLI's auto-discovery: the group of
      the environment (``env://``);
    * hosts, as the JAX CLI's VTACO_COORDINATOR / VTACO_NUM_PROCESSES /
      VTACO_PROCESS_ID: ``coordinator_address`` 'host:port' (the TCP
      store), ``num_processes`` hosts (> 1), this host's ``process_id``,
      and this rank's ``local_rank`` of the host's ``local_size`` ranks;
      global rank process_id × local_size + local_rank;
    * one host with ``local_size`` > 1 ranks (the train CLI's own
      launch): ``init_method`` (a ``file://`` store), rank ``local_rank``.

    The backend is NCCL where a card is visible, else gloo; under NCCL the
    rank's card is its local rank."""
    if dist.is_initialized():
        return
    if auto is None:
        auto = os.environ.get("VTACO_DISTRIBUTED", "0") not in ("", "0")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or auto:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
        return
    hosts = int(num_processes) if coordinator_address is not None and num_processes else 1
    if hosts <= 1 and local_size <= 1:
        return
    if hosts > 1:
        if process_id is None:
            raise ValueError("several hosts need this host's process_id")
        init_method, host = f"tcp://{coordinator_address}", int(process_id)
    elif init_method is None:
        raise ValueError("several ranks on one host need an init_method")
    else:
        host = 0
    os.environ["LOCAL_WORLD_SIZE"] = str(local_size)
    os.environ["GROUP_RANK"] = str(host)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=hosts * local_size,
                            rank=host * local_size + local_rank)


def process_shard():
    """This host's ``(shard index, shard count)``: its index among the
    group's hosts and their number; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    host = int(os.environ.get("GROUP_RANK", dist.get_rank() // local))
    return host, world // local
