"""Generation CLI (port of vtaco_tpu/cli/generate.py):

    python -m vtaco_tpu_torch.cli.generate configs/VTacO/VTacO_YCB.yaml \\
        [--split test] [--out-dir DIR] [--max-samples N] [--checkpoint F] \\
        [--data-root D] [--mesh-root M] [--cpu] [--batched B]

Loads the checkpoint (``--checkpoint``, else ``test.model_file``; a
relative name resolves against ``training.out_dir``; the port's own or a
``model.ckpt`` that the JAX package wrote, read without JAX; an http(s)
URL is fetched once into ``training.out_dir``) and reconstructs the
object and hand meshes of every sample of the split into ``--out-dir``
(default ``<training.out_dir>/generation``), or, for a tactile depth
stack, its predicted sensor point clouds. The last line of its output is
``{"split", "n", "emd_mean", "cd_mean"}``. A missing checkpoint warns and
the run goes on from the untrained initialization. Runs on the first
CUDA device unless ``--cpu`` is given. ``--batched B`` reconstructs the
object meshes B at a time, pipelined and ungated
(``Inferencer.run_batched``: one K2 launch per flight); its last line is
``{"split", "n", "cd_mean", "batched"}``. At start it keeps large host
allocations on the heap (utils.host.enable_heap_reuse), as the JAX CLI
does.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model, load_config
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.train.trainer import check_trainer_init
from vtaco_tpu_torch.utils.host import enable_heap_reuse

DEFAULT_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "default.yaml")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Reconstruct meshes from a checkpoint.")
    ap.add_argument("config", type=str)
    ap.add_argument("--split", default="test", choices=("train", "val", "test"))
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="Run on the CPU.")
    ap.add_argument("--data-root", type=str, default=None, help="Override data.path.")
    ap.add_argument("--mesh-root", type=str, default=None,
                    help="Override data.mesh_dir/depth_origin root.")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="Override test.model_file: a port or JAX checkpoint, "
                         "or an http(s) URL.")
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="Pipelined B-object batched reconstruction "
                         "(plain occupancy decode; no tactile gating).")
    args = ap.parse_args(argv)
    enable_heap_reuse()    # recycle grid-sized host buffers (utils/host.py)

    cfg = load_config(args.config, DEFAULT_CFG)
    if args.data_root:
        cfg["data"]["path"] = args.data_root
    if args.mesh_root:
        cfg["data"]["mesh_dir"] = os.path.join(args.mesh_root, "mesh_obj")
        cfg["data"]["depth_origin"] = os.path.join(args.mesh_root, "depth_origin.txt")

    dataset = get_dataset(args.split, cfg, return_idx=True)
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu" if args.cpu else "cuda", dataset=dataset)
    check_trainer_init(model)
    loader = BatchLoader(dataset, 1, shuffle=False,
                         num_workers=cfg["training"]["n_workers_val"])

    out_dir = cfg["training"]["out_dir"]
    ckpt_file = args.checkpoint or cfg["test"]["model_file"]
    try:
        scalars = CheckpointIO(out_dir, model=model).load(ckpt_file)
        print(f"=> loaded {ckpt_file} (it={scalars.get('it')})")
    except FileNotFoundError:
        print(f"Warning: checkpoint {ckpt_file} not found; proceeding with the "
              f"untrained initialization")
    model.eval()

    generator = get_generator(model, cfg)
    inferencer = Inferencer.from_config(model, generator, cfg)
    gen_dir = args.out_dir or os.path.join(out_dir, "generation")
    if args.batched:
        results = inferencer.run_batched(model, loader, batch_size=args.batched,
                                         out_dir=gen_dir, max_samples=args.max_samples)
        print(json.dumps({"split": args.split, "n": len(results["names"]),
                          "cd_mean": results["cd_mean"], "batched": args.batched}))
        return
    results = inferencer.run(model, loader, out_dir=gen_dir,
                             max_samples=args.max_samples)
    print(json.dumps({
        "split": args.split,
        "n": len(results["names"]),
        "emd_mean": results["emd_mean"],
        "cd_mean": results["cd_mean"],
    }))


if __name__ == "__main__":
    main()
