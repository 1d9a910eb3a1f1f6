"""Faults planted underneath a grasp cell's timed path, to show that its
check turns ``correct`` false: each wraps what the loop takes from the
program, for the length of a ``with planted(name)`` block.

- ``vertex``: every mesh leaves the program with one vertex moved by half
  a voxel (an answer altered where it is produced).
- ``face``: every mesh loses its last face.
- ``logit``: the logit at the grid's centre is shipped one higher.
- ``gates``: the tactile gates are left out (the decode runs ungated).

Under a training cell:

- ``unchanged``: every step returns the state unchanged (the optimizer's
  step does nothing).
- ``half``: every step trains on the first half of its batch, the mean
  taken over those rows.

    python3 port_bench/faults.py --workload vtaco_ycb.grasp --fault vertex --seeds 1 2 3

runs the cell at its own size on the card with the fault planted, a
short window per seed, and prints each run's ``correct`` and checks.
"""

import argparse
import contextlib
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
GRASP_FAULTS = ("vertex", "face", "logit", "gates")
TRAIN_FAULTS = ("unchanged", "half")
FAULTS = GRASP_FAULTS + TRAIN_FAULTS


@contextlib.contextmanager
def planted(name):
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")
    with (_grasp_fault(name) if name in GRASP_FAULTS else _train_fault(name)):
        yield


@contextlib.contextmanager
def _train_fault(name):
    from port_bench.loops import train

    program = train._program

    def faulty():
        get_model, get_trainer, BatchLoader, get_dataset = program()

        def trainer(model, cfg, **kw):
            tr = get_trainer(model, cfg, **kw)
            if name == "unchanged":
                tr.optimizer.step = lambda *a, **k: None
            else:
                step = tr.train_step

                def half_step(batch, draws=None):
                    n = len(batch["points"]) // 2
                    return step({k: v[:n] for k, v in batch.items()}, draws)
                tr.train_step = half_step
            return tr

        return get_model, trainer, BatchLoader, get_dataset

    train._program = faulty
    try:
        yield
    finally:
        train._program = program


@contextlib.contextmanager
def _grasp_fault(name):
    from port_bench.loops import grasp

    program = grasp._program

    def faulty():
        get_model, get_generator, marching_cubes, tips = program()

        def mc(volume, level=None, gradient="ascent"):
            verts, faces = marching_cubes(volume, level=level, gradient=gradient)
            if name == "vertex" and len(verts):
                verts = verts.copy()
                verts[0, 0] += 0.5
            if name == "face" and len(faces):
                faces = faces[:-1]
            return verts, faces

        def generator(model, cfg, **kw):
            gen = get_generator(model, cfg, **kw)
            dense, gates = gen.eval_points_dense, gen._build_gates

            def eval_points_dense(*a, **k):
                values = dense(*a, **k)
                if name == "logit":
                    values = values.copy()
                    values[len(values) // 2] += 1.0
                return values

            def build_gates(*a, **k):
                out = gates(*a, **k)
                return ("none", None, None, None) if name == "gates" else out

            gen.eval_points_dense, gen._build_gates = eval_points_dense, build_gates
            return gen

        return get_model, generator, mc, tips

    grasp._program = faulty
    try:
        yield
    finally:
        grasp._program = program


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import run

    bench = run._json(ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        with planted(args.fault):
            line, _ = run.run_cell(bench, args.workload, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": line["correct"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
