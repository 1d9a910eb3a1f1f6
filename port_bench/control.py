"""The control of a cell: the plain reference put in the program's place,
computed in the nearest precision below the one the configuration
states, judged as a run's outputs are. For a grasp cell (IEEE float32)
that is TF32; for a training cell (float32 with TF32 allowed) bfloat16.
It has to come out as not correct. The benchmark's runs never run it.

    python3 port_bench/control.py --workload vtaco_ycb.grasp --seeds 11 12 13

Prints one JSON line per seed: the numbers compared and their limits.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def control(bench, name, seed, device=None, config=None, traffic=None):
    """{"correct": ..., "checks": ...} of the control on ``seed``."""
    import torch

    from port_bench import run
    from port_bench.harness.device import require_cards

    cell = run._cell(bench, name)
    if device is None:
        require_cards(cell["chips"])
        device = torch.device("cuda", 0)
    config = config or run._json(BENCH_DIR, "configs", cell["config"] + ".json")
    traffic = traffic or run._json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
    ctx = run.Context(cell, config, traffic, seed, 0.0, False, device, time.perf_counter())
    if traffic["loop"] == "train":
        checks = train_control(ctx)
    else:
        checks = grasp_control(ctx)
    correct = all(v <= lim for v, lim in checks.values())
    return {"workload": name, "seed": seed, "correct": correct,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def train_control(ctx):
    """The reference's first steps in bfloat16 against its own in float32,
    on the batches the program's loader feeds."""
    from port_bench.harness import judge_train
    from port_bench.loops.train import TrainSetup

    s = TrainSetup(ctx)
    try:
        batches = [next(s.batches) for _ in range(ctx.traffic["checked_steps"])]
        s.close()
        del s.trainer, s.model
        low = judge_train.reference_steps(ctx, s.cfg, s.drawn, batches, autocast=True)
        ref = judge_train.reference_steps(ctx, s.cfg, s.drawn, batches)
    finally:
        s.close()
        s.remove()
    nums, leaves = judge_train.numbers(low[0], low[1], low[2], ref[0], ref[1], ref[2],
                                       s.drawn)
    print("control: " + json.dumps(leaves), file=sys.stderr)
    lim = judge_train.limits(ctx.cell)
    return {n: [nums[n], lim[n]] for n in judge_train.NAMES}


def grasp_control(ctx):
    """The reference with TF32 on, judged as the program's outputs."""
    from port_bench.harness import judge_grasp
    from port_bench.loops.grasp import Served, Setup

    device = ctx.device
    s = Setup(ctx)
    del s.model, s.gen
    ref = judge_grasp.reference(ctx, s.drawn)
    box = 1 + ctx.model_cfg["data"]["padding"]
    kept = {}
    judge_grasp.set_tf32(True)
    try:
        for gid in s.checked:
            c, gt, values, verts, faces = judge_grasp.reference_serve(
                ref, s.pool[gid], gid, s.nx, box, s.contact, device)
            kept[gid] = Served(verts, faces, c, gt, values)
    finally:
        judge_grasp.set_tf32(False)
    del ref
    return judge_grasp.judge(ctx, kept, s.pool, s.drawn, s.nx, s.contact)["checks"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import run

    bench = run._json(ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        print(json.dumps(control(bench, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
