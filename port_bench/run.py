"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json at the root of the
checkout. Its configuration is ``port_bench/configs/<config>.json``, its
traffic mix ``port_bench/traffic/<traffic>.json``, whose ``loop`` names the
driver of the window (``port_bench/loops/<loop>.py``), and each metric is
read by ``port_bench/metrics/<metric>.py`` from the run's record. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (spans and the profiler on). The last
line of standard output is one JSON object; the numbers the correctness
check compared stand, each beside its limit, as the last lines of
standard error and under the line's last key, ``checks``.

The run measures only on an NVIDIA GPU: without the cards the cell asks
for it exits with code 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "vtaco_tpu")
EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


class Context:
    """What a loop gets: the cell, its configuration and traffic, the
    seed, the window's length, whether to trace, the device and the
    process's start on the host clock."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device, t0):
        self.cell = cell["name"]
        self.chips = cell["chips"]
        self.config = config
        self.model_cfg = config["config"]
        self.traffic = traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t0 = t0


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _cell(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name):
    """The ``read(record)`` of port_bench/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(bench, name, seed, seconds, trace, device=None, t0=T0, config=None,
             traffic=None):
    """(result line as a dict, the run's record). ``device`` None: the
    cards the cell asks for, which must be there. ``config`` and
    ``traffic`` replace the cell's files (the tests' tiny sizes)."""
    import torch

    from port_bench.harness import device as dev_mod

    cell = _cell(bench, name)
    if device is None:
        dev_mod.require_cards(cell["chips"])
        device = torch.device("cuda", 0)
    config = config or _json(BENCH_DIR, "configs", cell["config"] + ".json")
    traffic = traffic or _json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
    ctx = Context(cell, config, traffic, seed, seconds, trace, device, t0)
    loop = importlib.import_module("port_bench.loops." + traffic["loop"])
    out = loop.run(ctx)
    record = out["record"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not _applies(m, name):
            continue
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    correct = all(_finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    if device.type == "cuda":
        dev = dev_mod.record(cell["chips"], out["peak_bytes"], dev_mod.power_limit_w())
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    prof = record.get("profile")
    if trace and prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        line["breakdown"] = {"device_ops": prof.top_ops, "idle_gaps": prof.idle_gaps}
    line["checks"] = checks
    return line, record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        print("no BENCHMARK.json at the checkout's root", file=sys.stderr)
        return 2
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path.insert(0, ROOT)
    from port_bench.harness.device import NoCard

    bench = _json(ROOT, "BENCHMARK.json")
    try:
        line, _ = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as exc:
        print(f"no card: {exc}", file=sys.stderr)
        return EXIT_NO_CARD
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark may not import JAX or "
              "the JAX package", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
