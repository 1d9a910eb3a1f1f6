"""A run of a grasp cell at tiny widths on the CPU, past the harness's
look for a card: sound, its check holds; with each planted fault
underneath the timed path (port_bench/faults.py), ``correct`` comes out
false."""

import contextlib
import time

import pytest
import torch

from port_bench import faults, run
from port_bench.tests import tiny

CELLS = (("vtaco_ycb.grasp", "vtaco_ycb"), ("vtacoh_ycb.grasp", "vtacoh_ycb"))
TRAIN = ("vtacoh_ycb.train_b6", "vtacoh_ycb")


def _run(cell, config, fault=None, seed=2 ** 33 + 7):
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    mix = tiny.benchmark_cell(cell)["traffic"]
    traffic = tiny.traffic(mix)
    if mix == "grasp":
        traffic["check_grasps"] = 4
    with ctx:
        line, record = run.run_cell(tiny.benchmark(), cell, seed, 0.5, False,
                                    device=torch.device("cpu"), t0=time.perf_counter(),
                                    config=tiny.config(config), traffic=traffic)
    return line, record


@pytest.mark.parametrize("cell,config", CELLS)
def test_sound_run_is_correct(cell, config):
    line, record = _run(cell, config)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] == record["completed"] > 0
    assert set(line["metrics"]) == {"objects_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.GRASP_FAULTS)
@pytest.mark.parametrize("cell,config", CELLS)
def test_fault_turns_correct_false(cell, config, fault):
    line, _ = _run(cell, config, fault)
    assert not line["correct"], line["checks"]


def test_sound_training_run_is_correct():
    line, record = _run(*TRAIN)
    assert line["correct"], line["checks"]
    assert line["attempted"] == record["steps"] > 0
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_training_fault_turns_correct_false(fault):
    line, _ = _run(*TRAIN, fault)
    assert not line["correct"], line["checks"]


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        with faults.planted("nothing"):
            pass
