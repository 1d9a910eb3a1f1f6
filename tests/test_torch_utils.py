"""The port's host utilities and the loop's observability against the JAX
package's on the CPU: the jsonl and TensorBoard logger (as
tests/test_logging.py), the profiler region, debug_nans on a planted NaN,
heap reuse, utils.io, utils.icp, utils.voxels, utils.visualize, the mesh
writers and readers, and DelaunayMeshExtractor (following
tests/test_generation_utils.py).
"""

import functools
import glob
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from vtaco_tpu.generate.mise import DelaunayMeshExtractor as JDelaunay
from vtaco_tpu.train.loop import JsonlLogger as JLogger
from vtaco_tpu.utils import icp as jicp
from vtaco_tpu.utils import io as jio
from vtaco_tpu.utils import meshio as jmeshio
from vtaco_tpu.utils import voxels as jvoxels
from vtaco_tpu_torch.data.synthetic import generate
from vtaco_tpu_torch.generate.mise import DelaunayMeshExtractor
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.trainer import Trainer
from vtaco_tpu_torch.utils import icp, meshio, profiling, visualize, voxels
from vtaco_tpu_torch.utils import io as tio
from vtaco_tpu_torch.utils.host import enable_heap_reuse

from test_trainer import _small_cfg

SCALARS = (("train/loss", 0.5, 1), ("train/loss", 0.25, 2), ("val/iou", 0.75, 2))


def _scalars(logdir):
    acc = EventAccumulator(logdir)
    acc.Reload()
    return {t: [(s.step, s.value) for s in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


def test_jsonl_and_tensorboard_logger_match_jax(tmp_path):
    logs = {}
    for name, cls in (("port", loop.JsonlLogger), ("jax", JLogger)):
        path = str(tmp_path / name / "logs" / "metrics.jsonl")
        logger = cls(path, tensorboard=True)
        assert logger.tb is not None
        for tag, value, step in SCALARS:
            logger.add_scalar(tag, value, step)
        logger.close()
        with open(path) as f:
            logs[name] = ([json.loads(line) for line in f], _scalars(os.path.dirname(path)))
        assert glob.glob(os.path.join(os.path.dirname(path), "events.out.tfevents.*"))
    assert logs["port"] == logs["jax"]
    assert logs["port"][1]["train/loss"] == [(1, 0.5), (2, 0.25)]


def test_tensorboard_warning_without_tensorboardx(tmp_path, monkeypatch, capsys):
    """Where tensorboardX is missing (as on the card's machine), both
    loggers print the same warning and write the jsonl only."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    out = {}
    for name, cls in (("port", loop.JsonlLogger), ("jax", JLogger)):
        path = str(tmp_path / name / "metrics.jsonl")
        logger = cls(path, tensorboard=True)
        assert logger.tb is None
        logger.add_scalar("train/loss", 0.5, 1)
        logger.close()
        out[name] = capsys.readouterr().out
        assert os.listdir(tmp_path / name) == ["metrics.jsonl"]
    assert out["port"] == out["jax"] and "tensorboardX is not installed" in out["port"]


def test_profiled_region_writes_a_trace_after_stop_step(tmp_path):
    region = profiling.ProfiledRegion(str(tmp_path), start_step=2, stop_step=4)
    x = torch.ones(64, 64)
    for step in range(1, 8):
        region.maybe_start(step)
        with profiling.span("marked_step"):
            x = torch.tanh(x @ x)
        region.maybe_stop(step)
        files = os.listdir(tmp_path)
        assert files == ([] if step < 4 else ["trace_2_4.json"]), (step, files)
    with open(tmp_path / "trace_2_4.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "marked_step" in names and "aten::mm" in names
    with profiling.trace(str(tmp_path / "t")):
        torch.tanh(x)
    assert os.listdir(tmp_path / "t") == ["trace.json"]
    assert profiling.ProfiledRegion(None).maybe_start(100) is None   # no-op


def test_step_timer():
    timer = profiling.StepTimer(window=3)
    assert timer.steps_per_sec == 0.0
    for _ in range(5):
        timer.tick()
    assert len(timer.stamps) == 3 and timer.steps_per_sec > 0 and timer.elapsed >= 0


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("synth")), n_models=4, n_query=500,
                    n_surface=1000, img_h=16, img_w=12, seed=7)


def _loop_cfg(synth, out_dir, **training):
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    cfg["training"].update(dict(batch_size=2, n_workers=1, n_workers_val=1,
                                validate_every=-1, visualize_every=-1, print_every=1,
                                checkpoint_every=-1, backup_every=-1,
                                out_dir=str(out_dir)), **training)
    return cfg


def test_debug_nans_stops_at_a_planted_nan(synth, tmp_path, monkeypatch):
    """A NaN planted in the decoder's output bias: under debug_nans the
    loop runs in anomaly mode and raises FloatingPointError naming
    iteration 1; without it the loop runs its steps and logs the NaN loss,
    as the JAX loop without jax_debug_nans does."""
    build = loop.get_model

    def poisoned(*a, **kw):
        model, aux = build(*a, **kw)
        with torch.no_grad():
            model.decoder.fc_out.bias.fill_(float("nan"))
        return model, aux

    anomaly = []
    step = Trainer.train_step

    def spy(self, *a, **kw):
        anomaly.append(torch.is_anomaly_enabled())
        return step(self, *a, **kw)

    monkeypatch.setattr(loop, "get_model", poisoned)
    monkeypatch.setattr(Trainer, "train_step", spy)
    with pytest.raises(FloatingPointError, match="iteration 1"):
        loop.train(_loop_cfg(synth, tmp_path / "nan", debug_nans=True), max_iters=2,
                   device="cpu")
    assert anomaly == [True] and not torch.is_anomaly_enabled()
    _, it = loop.train(_loop_cfg(synth, tmp_path / "plain"), max_iters=2, device="cpu")
    assert it == 2 and anomaly[1:] == [False, False]
    with open(tmp_path / "plain" / "logs" / "metrics.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    assert len(losses) == 2 and all(np.isnan(losses))
    with pytest.raises(FloatingPointError, match="loss is inf at iteration 5"):
        profiling.check_finite({"loss": float("inf")}, 5)
    profiling.check_finite({"loss": 0.5}, 5)


def test_loop_traces_its_profile_window(synth, tmp_path, monkeypatch):
    """training.profile_dir: ProfiledRegion around the loop's steps (its
    window moved to steps 2-3 here), one trace written."""
    monkeypatch.setattr(loop, "ProfiledRegion",
                        functools.partial(profiling.ProfiledRegion, start_step=2,
                                          stop_step=3))
    prof = tmp_path / "prof"
    _, it = loop.train(_loop_cfg(synth, tmp_path / "out", profile_dir=str(prof)),
                       max_iters=3, device="cpu")
    assert it == 3 and os.listdir(prof) == ["trace_2_3.json"]


def test_enable_heap_reuse_returns_a_bool():
    assert isinstance(enable_heap_reuse(), bool)


def test_io_matches_jax(tmp_path, rng):
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    tio.export_pointcloud(pts, str(tmp_path / "p.ply"))
    jio.export_pointcloud(pts, str(tmp_path / "j.ply"))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tio.load_pointcloud(str(tmp_path / "j.ply")),
                                  jio.load_pointcloud(str(tmp_path / "p.ply")))
    with pytest.raises(ValueError, match="\\(N, 3\\)"):
        tio.export_pointcloud(pts[:, :2], str(tmp_path / "bad.ply"))
    verts, faces = meshio.icosphere(1)
    meshio.write_off(str(tmp_path / "m.off"), verts, faces)
    text = (tmp_path / "m.off").read_text()
    for got, want in zip(tio.read_off(io.StringIO(text)), jio.read_off(io.StringIO(text))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tio.read_off(str(tmp_path / "m.off")),
                         jio.read_off(str(tmp_path / "m.off"))):
        np.testing.assert_array_equal(got, want)


def test_icp_matches_jax(rng):
    from scipy.spatial.transform import Rotation

    A = rng.standard_normal((200, 3))
    R = Rotation.from_rotvec([0.05, -0.1, 0.08]).as_matrix()
    t = np.array([0.02, -0.03, 0.01])
    B = A @ R.T + t
    T, dists, its = icp.icp(A, B, max_iterations=50, tolerance=1e-9)
    jT, jdists, jits = jicp.icp(A, B, max_iterations=50, tolerance=1e-9)
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-3)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-3)
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_array_equal(dists, jdists)
    assert its == jits
    for got, want in zip(icp.best_fit_transform(A, B), jicp.best_fit_transform(A, B)):
        np.testing.assert_array_equal(got, want)


def test_voxels_match_jax(rng):
    verts, faces = meshio.icosphere(2, radius=0.3)
    vg = voxels.VoxelGrid.from_mesh(verts, faces, 24, loc=(0, 0, 0), scale=1.0)
    jg = jvoxels.VoxelGrid.from_mesh(verts, faces, 24, loc=(0, 0, 0), scale=1.0)
    np.testing.assert_array_equal(vg.data, jg.data)
    auto, jauto = voxels.VoxelGrid.from_mesh(verts, faces, 16), jvoxels.VoxelGrid.from_mesh(
        verts, faces, 16)
    np.testing.assert_array_equal(auto.data, jauto.data)
    np.testing.assert_allclose(auto.loc, jauto.loc)
    assert auto.scale == pytest.approx(jauto.scale)
    pts = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(vg.contains(pts), jg.contains(pts))
    for got, want in zip(vg.to_mesh(), jg.to_mesh()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vg.down_sample().data, jg.down_sample().data)
    for name in ("check_voxel_occupied", "check_voxel_unoccupied", "check_voxel_boundary"):
        np.testing.assert_array_equal(getattr(voxels, name)(vg.data),
                                      getattr(jvoxels, name)(jg.data))
    with pytest.raises(ValueError, match="cubic"):
        voxels.VoxelGrid(np.zeros((4, 4, 5), bool))


def test_delaunay_extractor_matches_jax(rng):
    pts = rng.uniform(-0.5, 0.5, (400, 3))
    vals = 0.3 - np.linalg.norm(pts, axis=1)
    ext, jext = DelaunayMeshExtractor(pts, vals), JDelaunay(pts, vals)
    np.testing.assert_array_equal(ext.active_simplices(), jext.active_simplices())
    for got, want in zip(ext.extract_mesh(), jext.extract_mesh()):
        np.testing.assert_array_equal(got, want)
    np.random.seed(3)
    q = ext.query(100)
    np.random.seed(3)
    np.testing.assert_array_equal(q, jext.query(100))
    qv = 0.3 - np.linalg.norm(q, axis=1)
    ext.update(q, qv)
    jext.update(q, qv)
    v, f = ext.extract_mesh()
    for got, want in zip((v, f), jext.extract_mesh()):
        np.testing.assert_array_equal(got, want)
    assert len(f) > 20 and np.abs(np.linalg.norm(v, axis=1) - 0.3).max() < 0.1


def test_mesh_writers_and_read_ply_match_jax(tmp_path):
    verts, faces = meshio.icosphere(1, radius=0.7)
    for ext in (".off", ".obj", ".ply"):
        port, jax_ = str(tmp_path / f"p{ext}"), str(tmp_path / f"j{ext}")
        meshio.write_triangle_mesh(port, verts, faces)
        jmeshio.write_triangle_mesh(jax_, verts, faces)
        with open(port, "rb") as a, open(jax_, "rb") as b:
            assert a.read() == b.read(), ext
        for got, want in zip(meshio.read_triangle_mesh(jax_),
                             jmeshio.read_triangle_mesh(port)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(meshio.read_ply(str(tmp_path / "p.ply"))[0], verts, atol=1e-6)
    meshio.write_ply(str(tmp_path / "c.ply"), verts, text=True)
    jmeshio.write_ply(str(tmp_path / "d.ply"), verts)
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "d.ply").read_bytes()
    np.testing.assert_array_equal(meshio.read_ply(str(tmp_path / "d.ply"))[0],
                                  jmeshio.read_ply(str(tmp_path / "c.ply"))[0])
    with pytest.raises(ValueError, match="unsupported"):
        meshio.write_triangle_mesh(str(tmp_path / "m.stl"), verts, faces)
    (tmp_path / "cut.ply").write_text("ply\nformat ascii 1.0\n")
    with pytest.raises(ValueError, match="end_header"):
        meshio.read_ply(str(tmp_path / "cut.ply"))


def test_visualize_writes_plots(tmp_path, rng):
    pytest.importorskip("matplotlib")
    visualize.visualize_data(rng.uniform(-0.4, 0.4, (100, 3)), "pointcloud",
                             str(tmp_path / "pc.png"))
    visualize.visualize_data(rng.random((4, 4, 4)) > 0.5, "voxels", str(tmp_path / "v.png"))
    visualize.visualize_data(None, "idx", str(tmp_path / "none.png"))
    assert sorted(os.listdir(tmp_path)) == ["pc.png", "v.png"]
    with pytest.raises(ValueError, match="Invalid data_type"):
        visualize.visualize_data(None, "mesh", None)
