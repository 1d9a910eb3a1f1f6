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
"""

from __future__ import annotations

import argparse
import os
import shutil

from vtaco_tpu_torch.core.config import load_config
from vtaco_tpu_torch.generate.generator import make_loop_generator
from vtaco_tpu_torch.train.loop import train

DEFAULT_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "default.yaml")


def main(argv=None):
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
    args = parser.parse_args(argv)

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

    out_dir = cfg["training"]["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    shutil.copyfile(args.config, os.path.join(out_dir, "config.yaml"))
    train(cfg, exit_after=args.exit_after, max_iters=args.max_iters,
          device="cpu" if args.cpu else "cuda", generator_factory=make_loop_generator)


if __name__ == "__main__":
    main()
