"""The port's one tracer (vtaco_tpu_torch/utils/profiling.py): off, a span
costs a check and opens no profiler range; under torch.profiler its spans
nest, carry their parent and root, and share the profiler's clock; the
counters add up; and the program's spans and counters appear where they
are opened: the loader's wait and counts, a grasp request's gates, decode,
copy and marching cubes, a train step's upload, stages and read.

This file imports neither jax nor the JAX package; the tests marked
``cuda`` (the ``sync`` counter and ``host_syncs``) run on a card:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import copy
import os
import threading
import time

import numpy as np
import pytest
import torch

from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model, load_config
from vtaco_tpu_torch.data import synthetic
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.train.trainer import Trainer
from vtaco_tpu_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _names(recs=None):
    return [r.name for r in (profiling.records() if recs is None else recs)]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.span("a.b"):
        with profiling.span("a.c"):
            profiling.count("a.n", 3)
    assert profiling.records() == [] and profiling.counters() == {}


def test_nested_spans_share_the_profilers_clock():
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("warm.up"):   # the first range's one-off cost
            pass
        with profiling.span("t.root"):
            with profiling.span("t.child"):
                with profiling.span("t.leaf"):
                    time.sleep(0.002)
            with profiling.span("t.second"):
                time.sleep(0.001)
        with profiling.span("t.other"):
            pass
    recs = {r.name: r for r in profiling.records()}
    assert _names() == ["t.leaf", "t.child", "t.second", "t.root", "t.other"]
    root, child, leaf, second, other = (recs[n] for n in
                                        ("t.root", "t.child", "t.leaf", "t.second", "t.other"))
    assert root.parent is None and root.root == root.id
    assert child.parent == root.id and child.root == root.id
    assert leaf.parent == child.id and leaf.root == root.id
    assert second.parent == root.id and second.root == root.id
    assert other.parent is None and other.root == other.id != root.id
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in recs:
            ranges[ev.name()] = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
    assert set(ranges) == set(recs)
    for name, r in recs.items():
        s, e = ranges[name]
        assert abs(r.start - s) < 100_000 and abs(r.end - e) < 100_000, (name, r, s, e)
    assert leaf.end - leaf.start >= 2_000_000


def test_counters_add_up():
    with torch.profiler.profile(activities=CPU):
        for i in range(5):
            profiling.count("c.one")
            profiling.count("c.n", i)
    profiling.count("c.one")                  # off again: not counted
    assert profiling.counters() == {"c.one": 5, "c.n": 10}


def test_spans_and_counts_on_other_threads_are_off():
    """The profiler's flag is the calling thread's: a loader's worker
    neither counts nor opens a span while the main thread profiles."""
    def work():
        profiling.count("w.n")
        with profiling.span("w.span"):
            pass
    with torch.profiler.profile(activities=CPU):
        t = threading.Thread(target=work)
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert profiling.records() == [] and profiling.counters() == {}


class _Sleepy:
    """A dataset whose every sample takes ``s`` seconds to load."""

    def __init__(self, n, s):
        self.n, self.s = n, s

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.s)
        return {"x": np.full(2, i, np.float32)}


@pytest.mark.parametrize("consumer_s,empty", [(0.0, 8), (0.1, 2)])
def test_loader_counts_its_waits(consumer_s, empty):
    """Two epochs of 4 batches: a consumer faster than the loader waits for
    every batch; one far slower waits only for each epoch's first, while
    the new producer fills its queue."""
    loader = BatchLoader(_Sleepy(8, 0.01), 2, shuffle=True, num_workers=2, seed=0)
    got = 0
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            for _batch in loader:
                got += 1
                time.sleep(consumer_s)
    assert got == 8
    assert profiling.counters() == {"loader.epochs": 2, "loader.batches": 8,
                                    "loader.empty": empty}
    # one wait per get: each batch's and each epoch's end
    assert _names() == ["loader.wait"] * 10
    assert all(r.parent is None for r in profiling.records())


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    return synthetic.generate(out, n_models=2, n_query=500, n_surface=1000, img_h=16,
                              img_w=12, seed=5, splits=(("train", 1.0), ("test", 1.0)))


def _small(path, synth):
    """A shipped configuration at small widths on the synthetic set."""
    root, mesh = synth
    cfg = load_config(path, "configs/default.yaml")
    cfg["data"].update(path=root, points_subsample=256, pointcloud_n=128, num_sample=256,
                       mesh_dir=os.path.join(mesh, "mesh_obj"),
                       depth_origin=os.path.join(mesh, "depth_origin.txt"))
    m = cfg["model"]
    m["c_dim"] = 8
    m["decoder_kwargs"]["hidden_size"] = 16
    m["encoder_kwargs"].update(hidden_dim=8, grid_resolution=8)
    m["encoder_kwargs"]["unet3d_kwargs"].update(num_levels=2, f_maps=8, in_channels=8,
                                                 out_channels=8)
    m["encoder_hand_kwargs"].update(hidden_dim=8, plane_resolution=8)
    m["encoder_hand_kwargs"]["unet_kwargs"].update(depth=2, start_filts=8)
    m["encoder_img_kwargs"]["num_classes"] = 8
    if m["encoder_t2d"]:
        t = m["encoder_t2d_kwargs"]
        t["encoder_img_kwargs"].update(start_filts=8, depth=2)
        t["encoder_hand_kwargs"].update(c_dim=8, hidden_dim=8, plane_resolution=8)
        t["encoder_hand_kwargs"]["unet_kwargs"].update(depth=2, start_filts=8)
    cfg["generation"]["resolution_0"] = 4
    cfg["training"]["n_workers"] = 1
    return cfg


@pytest.mark.parametrize("path,gates", [
    ("configs/VTacO/VTacO_YCB.yaml", ["gates.img", "gates.contact", "gates"]),
    ("configs/VTacOH/VTacOH_YCB.yaml", ["gates.img", "gates.hand", "gates"]),
])
def test_grasp_request_spans(synth, path, gates):
    """One mesh request through Generator3D on the CPU: the gates and
    their children, the decode, the copy of nx³ float32 logits and the
    two marching-cubes stages, each a root but the gates' children."""
    cfg = _small(path, synth)
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    gen = get_generator(model, cfg, transfer_dtype="float32", band_transfer=False)
    data = next(iter(BatchLoader(get_dataset("test", cfg), 1, shuffle=False, num_workers=1)))
    data["points.points_obj"] = data["points.points_obj"][:, :64]    # a quick EMD
    nx = gen.resolution0 * 4
    np.random.seed(0)
    with torch.profiler.profile(activities=CPU):
        gen.generate_obj_mesh_wnf(model, data)
    names = _names()
    assert names == gates + ["decode.trunk", "decode.copy", "mc.level", "mc.native"]
    recs = {r.name: r for r in profiling.records()}
    for name in gates[:-1]:
        assert recs[name].parent == recs["gates"].id
    assert all(recs[n].parent is None for n in names if not n.startswith("gates."))
    assert profiling.counters() == {"decode.bytes": nx ** 3 * 4}


def test_train_step_spans_and_stage_events(synth, monkeypatch):
    """A VTacOH train step on the CPU: the upload, each stage between the
    trainer's marks and the step's one read, while ``stage_events`` takes
    the same marks it took before (its CUDA events stood in for here)."""
    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass
    monkeypatch.setattr(torch.cuda, "Event", Event)
    cfg = _small("configs/VTacOH/VTacOH_YCB.yaml", synth)
    torch.manual_seed(0)
    tr = Trainer.from_config(get_model(cfg, device="cpu"), cfg)
    batch = next(iter(BatchLoader(get_dataset("train", cfg), 2, num_workers=1, seed=0)))
    tr.stage_events = []
    with torch.profiler.profile(activities=CPU):
        scalars = tr.train_step(copy.deepcopy(batch))
    assert np.isfinite(scalars["loss"])
    stages = ["encoders", "contact_labels", "decode", "backward", "optimizer"]
    assert [n for n, _ in tr.stage_events] == ["start"] + stages
    assert _names() == ["trainer.upload"] + [f"trainer.{s}" for s in stages] + ["trainer.read"]
    assert all(r.parent is None for r in profiling.records())
    tr.stage_events = None
    profiling.reset()
    tr.train_step(batch)                      # no profiler: nothing kept
    assert profiling.records() == [] and tr._stage is None


@pytest.mark.cuda
def test_sync_counter_counts_a_read(cuda):
    """An ``.item()`` inside a span counts once under ``sync`` and under
    the innermost span; the sync debug mode is back after the root."""
    x = torch.ones(4, device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    with torch.profiler.profile(activities=CPU):
        with profiling.span("s.root"):
            with profiling.span("s.inner"):
                assert x.sum().item() == 4.0
            y = x * 2                          # no sync
        x.sum().item()                         # outside any span: not counted
    assert torch.cuda.get_sync_debug_mode() == before
    assert profiling.counters() == {"sync": 1, "sync.s.inner": 1}
    del y


@pytest.mark.cuda
def test_host_syncs_lists_each_site(cuda):
    """host_syncs returns the call's result and one (file, line) per
    synchronizing call, as it did before it moved into the tracer."""
    x = torch.arange(6.0, device=cuda)

    def two_reads(t):
        a = t.sum().item()
        b = t.max().cpu()
        return a + float(b)
    before = torch.cuda.get_sync_debug_mode()
    out, sites = profiling.host_syncs(two_reads, x)
    assert out == 20.0
    assert len(sites) == 2 and all(f == __file__ for f, _ in sites)
    assert sites[0][1] < sites[1][1]
    assert profiling.host_syncs(lambda t: t + 1, x)[1] == []
    assert torch.cuda.get_sync_debug_mode() == before
    assert profiling.counters() == {}
