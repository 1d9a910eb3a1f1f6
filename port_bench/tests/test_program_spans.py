"""The per-layer metrics read from the port's own spans and counters
(vtaco_tpu_torch/utils/profiling.py): None where the store is empty, and
on the card every one of them in a short traced run of each cell, at the
cell's own sizes, with the run correct."""

import math

import pytest

from port_bench import run
from port_bench.tests import tiny

PROGRAM = ("gates_host_ms.grasp", "decode_wait_ms.grasp", "transfer_bytes.grasp",
           "host_syncs.grasp", "host_syncs.train", "loader_wait_ms.train",
           "loader_empty_pct.train", "upload_ms.train", "step_wait_ms.train")
SECONDS = {"grasp": 3.0, "train": 8.0}


def _entries(cell):
    return [m for m in tiny.benchmark()["per_layer"]
            if m["name"] in PROGRAM and run._applies(m, cell)]


def test_every_program_metric_has_an_entry():
    assert {m["name"] for m in tiny.benchmark()["per_layer"]} >= set(PROGRAM)
    for w in tiny.benchmark()["workloads"]:
        assert _entries(w["name"])


@pytest.mark.parametrize("family", ["grasp", "train"])
def test_an_empty_store_reads_nothing(family):
    from vtaco_tpu_torch.utils import profiling

    profiling.reset()
    record = {"family": family, "profiled": [1, 2], "profiled_steps": 2}
    for name in PROGRAM:
        assert run.reader(name)(record) is None, name


def test_readers_take_the_block_per_request_or_step():
    import time

    import torch
    from vtaco_tpu_torch.utils import profiling

    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("gates"):
                time.sleep(0.002)
            profiling.count("decode.bytes", 100)
        with profiling.span("loader.wait"):
            profiling.count("loader.batches", 4)
            profiling.count("loader.empty", 1)
    grasp = {"family": "grasp", "profiled": [5, 6]}
    train = {"family": "train", "profiled_steps": 4}
    try:
        assert run.reader("transfer_bytes.grasp")(grasp) == 100
        assert 2.0 <= run.reader("gates_host_ms.grasp")(grasp) < 50
        assert run.reader("host_syncs.grasp")(grasp) == 0
        assert run.reader("decode_wait_ms.grasp")(grasp) is None     # no such span
        assert run.reader("loader_empty_pct.train")(train) == 25.0
        assert run.reader("transfer_bytes.grasp")(train) is None     # another family
    finally:
        profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in tiny.benchmark()["workloads"]])
def test_traced_cell_reads_every_program_metric(cuda, cell):
    from vtaco_tpu_torch.utils import profiling

    bench = tiny.benchmark()
    traffic = tiny.load(tiny.BENCH, "traffic", tiny.benchmark_cell(cell)["traffic"] + ".json")
    profiling.reset()
    line, _ = run.run_cell(bench, cell, 2 ** 33 + 17, SECONDS[traffic["loop"]], True,
                           device=cuda)
    profiling.reset()
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for m in _entries(cell):
        assert m["name"] in got, m["name"]
        assert math.isfinite(got[m["name"]]["value"]), (m["name"], got[m["name"]])
    if traffic["loop"] == "grasp":
        assert got["transfer_bytes.grasp"]["value"] == 128 ** 3 * 4
    else:
        assert 0 <= got["loader_empty_pct.train"]["value"] <= 100
    print(cell, {k: v["value"] for k, v in got.items()}, line["breakdown"]["idle_gaps"])
