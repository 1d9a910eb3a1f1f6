"""The port's float32-to-bfloat16 step gap at trained full-width weights,
on the card (or the CPU), from the files that
``tests/test_torch_fast_trained.py --full-width --export DIR`` writes: the
JAX package's trained weights for each seed, the config and the batch.
It imports torch and the port only, so it runs where JAX is absent:

    python tests/f5_card.py DIR [--configs tactile] [--cpu]

For each config and seed it takes one float32 ('highest') and one
bfloat16 step of the port from the same weights and batch and prints one
JSON line per config with the statistics of
tests/test_torch_fast_trained.py: the relative gaps of the loss scalars
(their root mean square and largest) and each module's gradient distance
pooled over the seeds, beside the card's name and power limit, and
whether they are within twice the JAX package's own gaps at those weights
(tests/bf16_checks.trained_bars); it exits 1 where they are not.
"""

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vtaco_tpu_torch.core.config import get_model  # noqa: E402
from vtaco_tpu_torch.train.trainer import Trainer  # noqa: E402

from bf16_checks import exact_zero, trained_bars  # noqa: E402


def step(cfg, sd, batch, dtype, device):
    """(loss scalars, {parameter: float64 gradient}) of one port step."""
    model = get_model(cfg, device=device)
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"state_dict: missing {missing}, unexpected {unexpected}")
    tr = Trainer.from_config(model, cfg, compute_dtype=dtype)
    scalars = tr.train_step(dict(batch), None)
    grads = {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in scalars.items()}, grads


def gaps(cfg, seeds, batch, device):
    loss, pooled, each = [], {}, {}
    for sd in seeds:
        s32, g32 = step(cfg, sd, batch, None, device)
        s16, g16 = step(cfg, sd, batch, "bfloat16", device)
        loss += [(s16[k] - s32[k]) / abs(s32[k]) for k in s32]
        live = sorted(k for k in set(g32) - exact_zero(g32) if np.any(g32[k]))
        for mod in sorted({k.split(".")[0] for k in live}):
            num = sum(float(np.sum(np.square(np.asarray(g16.get(k, 0.0)) - g32[k])))
                      for k in live if k.split(".")[0] == mod)
            den = sum(float(np.sum(np.square(g32[k]))) for k in live if k.split(".")[0] == mod)
            d = pooled.setdefault(mod, [0.0, 0.0])
            d[0] += num
            d[1] += den
            each.setdefault(mod, []).append(float(np.sqrt(num / den)))
    return {"loss_rms": float(np.sqrt(np.mean(np.square(loss)))),
            "loss_max": float(np.max(np.abs(loss))), "loss_each": loss,
            "grad_rel": {m: float(np.sqrt(a / b)) for m, (a, b) in pooled.items()},
            "grad_each": each}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--configs", default="tactile")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    card = "cpu"
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    failed = False
    for name in args.configs.split(","):
        with open(os.path.join(args.dir, f"{name}.json")) as f:
            cfg = json.load(f)
        with np.load(os.path.join(args.dir, f"{name}_batch.npz")) as z:
            batch = {k: z[k] for k in z.files}
        seeds = []
        for path in sorted(glob.glob(os.path.join(args.dir, f"{name}_seed*.npz"))):
            with np.load(path) as z:
                seeds.append({k: z[k] for k in z.files})
        out = gaps(cfg, seeds, batch, device)
        bars = trained_bars(name)
        within = None if bars is None else (
            out["loss_rms"] <= bars["loss_rms"] and out["loss_max"] <= bars["loss_max"]
            and set(out["grad_rel"]) == set(bars["grad_rel"])
            and all(v <= bars["grad_rel"][m] for m, v in out["grad_rel"].items()))
        print(json.dumps({"config": name, "device": card, "seeds": len(seeds), **out,
                          "bars": bars, "within_bars": within}), flush=True)
        if within is False:
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
