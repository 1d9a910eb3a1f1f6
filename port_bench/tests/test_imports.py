"""The import guard: nothing the benchmark runs loads JAX, its libraries
or the JAX package (top-level names compared whole: the port,
vtaco_tpu_torch, is allowed), and the reference loads nothing of the
port. Each check runs in a fresh interpreter."""

import ast
import os
import subprocess
import sys

from port_bench.tests import tiny

REF_DIR = os.path.join(tiny.BENCH, "reference")

RUN_EVERYTHING = r"""
import glob, importlib, json, os, sys, time
sys.path.insert(0, {root!r})
import torch
from port_bench import run, control, faults
from port_bench.harness import device, grasps, judge_grasp, trace, weights, work
from port_bench.tests import tiny
for path in glob.glob(os.path.join({bench!r}, "loops", "*.py")):
    importlib.import_module("port_bench.loops." + os.path.basename(path)[:-3])
for path in glob.glob(os.path.join({bench!r}, "metrics", "*.py")):
    run.reader(os.path.basename(path)[:-3])
for path in glob.glob(os.path.join({bench!r}, "configs", "*.json")):
    json.load(open(path))
bench = tiny.benchmark()
for w in bench["workloads"]:
    cfg = tiny.config(w["config"])
    if w["traffic"] == "grasp":
        grasps.make_pool(1, tiny.traffic(w["traffic"]), cfg["config"])
    run.run_cell(bench, w["name"], 3, 0.2, False, device=torch.device("cpu"),
                 t0=time.perf_counter(), config=cfg, traffic=tiny.traffic(w["traffic"]))
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE_ALONE = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
for path in sorted(glob.glob(os.path.join({ref!r}, "*.py"))):
    importlib.import_module("port_bench.reference." + os.path.basename(path)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"vtaco_tpu_torch", "vtaco_tpu", "jax", "jaxlib", "flax"}})))
"""


def _last_line(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = RUN_EVERYTHING.format(root=tiny.ROOT, bench=tiny.BENCH)
    assert _last_line(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    assert _last_line(REFERENCE_ALONE.format(root=tiny.ROOT, ref=REF_DIR)) == "[]"


def test_the_reference_sources_import_nothing_of_the_port():
    for name in sorted(os.listdir(REF_DIR)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("vtaco_tpu_torch", "vtaco_tpu", "jax",
                                               "jaxlib", "flax"), (name, m)
