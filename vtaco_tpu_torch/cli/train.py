"""Train CLI (port of vtaco_tpu/cli/train.py):

    python -m vtaco_tpu_torch.cli.train configs/VTacO/VTacO_YCB.yaml \\
        --data-root D --mesh-root M [--max-iters N] [--exit-after S] [--cpu]

Trains on the first CUDA device unless ``--cpu`` is given. ``--exit-after
S`` saves a checkpoint and exits with code 3 after S seconds (the
reference's preemption contract). Every ``training.visualize_every``
iterations the loop writes the validation split's meshes (or, for a
tactile depth stack, its predicted sensor clouds) under
``<out_dir>/vis`` (generate.generator.LoopGenerator). ``--on-device``
keeps the train and val splits on the device (``data.on_device``) and
``--steps-per-dispatch K`` runs the steps in blocks of K with one host
read each (``training.steps_per_dispatch``); the ``*_fast`` configs set
both, and bfloat16 mixed precision.

Several cards, as the JAX CLI uses them (``training.mesh``,
parallel/mesh.py): where the mesh that ``training.mesh`` asks for on
this host's visible cards spans more than one, the plain command starts
one worker process per card of it itself (torch.multiprocessing, a file
store) and trains data-parallel (tensor-parallel over ``model``); under
``torchrun`` each process joins torchrun's group instead. The JAX CLI's
VTACO_COORDINATOR / VTACO_NUM_PROCESSES / VTACO_PROCESS_ID name the
hosts of a multi-host run (each host then starts a worker per visible
card). ``--cpu`` counts one device, unless the call already runs inside
a process group.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

from vtaco_tpu_torch.core.config import load_config
from vtaco_tpu_torch.data.core import get_dataset
from vtaco_tpu_torch.generate.generator import make_loop_generator
from vtaco_tpu_torch.parallel.mesh import mesh_shape_from_config
from vtaco_tpu_torch.parallel.multihost import initialize_distributed
from vtaco_tpu_torch.train.loop import train

DEFAULT_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "default.yaml")


def _parser():
    parser = argparse.ArgumentParser(description="Train a 3D reconstruction model.")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--exit-after", type=int, default=-1,
                        help="Checkpoint and exit (code 3) after this many seconds.")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="Stop after N iterations.")
    parser.add_argument("--cpu", action="store_true", help="Train on the CPU.")
    parser.add_argument("--data-root", type=str, default=None, help="Override data.path.")
    parser.add_argument("--mesh-root", type=str, default=None,
                        help="Override data.mesh_dir/depth_origin root.")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Override training.batch_size.")
    parser.add_argument("--out-dir", type=str, default=None,
                        help="Override training.out_dir.")
    parser.add_argument("--on-device", action="store_true",
                        help="Keep the dataset on the device (data.on_device).")
    parser.add_argument("--steps-per-dispatch", type=int, default=None,
                        help="Train steps per block on a device-resident dataset.")
    return parser


def _config(args):
    cfg = load_config(args.config, DEFAULT_CFG)
    if args.data_root:
        cfg["data"]["path"] = args.data_root
    if args.mesh_root:
        cfg["data"]["mesh_dir"] = os.path.join(args.mesh_root, "mesh_obj")
        cfg["data"]["depth_origin"] = os.path.join(args.mesh_root, "depth_origin.txt")
    if args.batch_size:
        cfg["training"]["batch_size"] = args.batch_size
    if args.out_dir:
        cfg["training"]["out_dir"] = args.out_dir
    if args.on_device:
        cfg["data"]["on_device"] = True
    if args.steps_per_dispatch:
        cfg["training"]["steps_per_dispatch"] = args.steps_per_dispatch
    return cfg


def _hosts():
    """The JAX CLI's multi-host variables: (coordinator, hosts, host id)."""
    env = os.environ
    return (env.get("VTACO_COORDINATOR"),
            int(env["VTACO_NUM_PROCESSES"]) if "VTACO_NUM_PROCESSES" in env else None,
            int(env["VTACO_PROCESS_ID"]) if "VTACO_PROCESS_ID" in env else None)


def _local_ranks(cfg):
    """The worker processes this host starts: every visible card on a
    multi-host run, else the cards of the mesh that ``training.mesh``
    asks for (1: no process group)."""
    coordinator, hosts, _ = _hosts()
    n_cards = torch.cuda.device_count()
    if coordinator is not None and (hosts or 1) > 1:
        return n_cards
    batch = min(cfg["training"]["batch_size"], len(get_dataset("train", cfg)))
    shape = mesh_shape_from_config(cfg, batch, n_cards)
    if shape is None:
        return 1
    need = shape[0] * shape[1]
    if need > n_cards:
        raise ValueError(f"training.mesh asks for a {shape[0]}x{shape[1]} mesh; "
                         f"{n_cards} cards are visible")
    return need


def _run(args, cfg, device):
    out_dir = cfg["training"]["out_dir"]
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(out_dir, exist_ok=True)
        shutil.copyfile(args.config, os.path.join(out_dir, "config.yaml"))
    train(cfg, exit_after=args.exit_after, max_iters=args.max_iters, device=device,
          generator_factory=make_loop_generator)


def _worker(local_rank, argv, local_size, store):
    """One card's process of the CLI's own launch."""
    args = _parser().parse_args(argv)
    coordinator, hosts, host = _hosts()
    initialize_distributed(coordinator, hosts, host, local_rank=local_rank,
                           local_size=local_size, init_method=f"file://{store}")
    try:
        _run(args, _config(args), f"cuda:{local_rank}")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    cfg = _config(args)
    if args.cpu:
        _run(args, cfg, "cpu")
        return
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        local = _local_ranks(cfg)
        if local > 1:
            with tempfile.TemporaryDirectory() as tmp:
                torch.multiprocessing.start_processes(
                    _worker, args=(argv, local, os.path.join(tmp, "store")),
                    nprocs=local, start_method="spawn")
            return
    initialize_distributed(*_hosts())
    _run(args, cfg, f"cuda:{torch.cuda.current_device()}" if dist.is_initialized()
         else "cuda")


if __name__ == "__main__":
    main()
