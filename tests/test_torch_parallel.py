"""Parallelism of the PyTorch port (vtaco_tpu_torch/parallel) against the
JAX package on the CPU: the mesh and ``mesh_from_config``'s clamp, the
input shards, ``initialize_distributed`` (torchrun's environment as two
hosts), the data-parallel train step (VTacO and the tactile stack), the
replicated B = 1 eval step, the fused block, tensor parallelism at
(data=2, model=2), and ``loop.train`` and the train CLI at data = 2.

The sharded decodes, batched MISE and ``run_batched`` under a mesh are in
tests/test_torch_parallel_serve.py.

The port runs one process per device: each multi-rank case spawns gloo
ranks that run tests/parallel_workers.py (which imports no JAX), on the
weights of the JAX package's model (load_jax_params) with the JAX draws
fed in; the JAX package runs on its 8-device CPU mesh (tests/conftest.py).
Each spawn runs several checks; a fixture caches it per module.

Tolerances: a train step's loss scalars within 2e-5 relative of the JAX
package's mesh step and of the port's one-process step on the global
batch, the updated parameters within the JAX tests' own atol 2e-4, rtol
5e-3 (tests/test_parallel.py: sharded collectives reorder reductions and
Adam's first step normalizes the gradient); BatchNorm statistics within
1e-5 of the one-process step's, relative to each statistic's largest
entry (the tactile images' one-pass variance by assert_batch_stat's rule
against float64).
"""

import copy
import os
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vtaco_tpu.parallel.mesh import mesh_from_config as jax_mesh_from_config
from vtaco_tpu.parallel.tp import tp_spec as jax_tp_spec
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data.core import get_dataset
from vtaco_tpu_torch.parallel import multihost
from vtaco_tpu_torch.parallel.mesh import mesh_shape_from_config
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer, _minmax_norm

import parallel_workers as W
from test_parallel import _tiny_train_cfg
from test_torch_train import assert_batch_stat, jax_draws
from test_trainer import _small_cfg

PER_FINGER = 16
STEP_ATOL, STEP_RTOL = 2e-4, 5e-3


def rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def assert_scalars(got, want, tol=2e-5):
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) <= tol, (k, got[k], want[k])


def assert_params(got, want, names):
    for k in names:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=k)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the mesh, shards and initialization (no ranks)

@pytest.mark.parametrize("batch", [3, 6, 12])
def test_mesh_from_config_clamp(batch):
    """``training.mesh: {data: -1}`` on 8 devices clamps data to the
    largest count that divides the batch, as the JAX package's
    mesh_from_config on its 8-device CPU mesh; explicit axes pass, and a
    mesh of one device is None in both."""
    cfg = {"training": {"mesh": {"data": -1}}}
    want = jax_mesh_from_config(cfg, batch_size=batch)
    assert mesh_shape_from_config(cfg, batch, 8) == (want.shape["data"], want.shape["model"])
    for mesh in ({"data": 2, "model": 2}, {"data": -1, "model": 2}, {"data": 1},
                 {"data": -1}):
        cfg = {"training": {"mesh": mesh}}
        want = jax_mesh_from_config(cfg, batch_size=1 if mesh == {"data": -1} else batch)
        got = mesh_shape_from_config(cfg, 1 if mesh == {"data": -1} else batch, 8)
        assert got == (None if want is None else (want.shape["data"], want.shape["model"]))
    assert mesh_shape_from_config({"training": {}}, batch, 8) is None


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth")), n_models=4, n_query=300,
                        n_surface=400, img_h=16, img_w=12, seed=2)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_dataset_shards_match_jax(synth, n):
    """``shard=(i, n)`` keeps the JAX package's strided shards: disjoint,
    covering the model list, and equal to the JAX lists."""
    cfg = _tiny_train_cfg(*synth)
    whole = [m["model"] for m in get_dataset("train", cfg).models]
    seen = []
    for i in range(n):
        got = [m["model"] for m in get_dataset("train", cfg, shard=(i, n)).models]
        want = [m["model"] for m in jax_get_dataset("train", cfg, shard=(i, n)).models]
        assert got == want
        seen += got
    assert sorted(seen) == sorted(whole)
    with pytest.raises(ValueError):
        get_dataset("train", cfg, shard=(n, n))


def test_initialize_distributed_single_host(synth, monkeypatch):
    """Without a group: nothing to coordinate on one host is a no-op, the
    shard of the one host is (0, 1), ``shard_by_process`` keeps the whole
    split, and the explicit modes refuse what they cannot build."""
    for k in ("WORLD_SIZE", "VTACO_DISTRIBUTED", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize_distributed()
    multihost.initialize_distributed("host0:1234", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert multihost.process_shard() == (0, 1)
    cfg = _tiny_train_cfg(*synth)
    cfg["data"]["shard_by_process"] = True
    assert len(get_dataset("train", cfg)) == len(jax_get_dataset("train", cfg))
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize_distributed("host0:1234", num_processes=2)
    with pytest.raises(ValueError, match="init_method"):
        multihost.initialize_distributed(local_size=2)


def test_torchrun_hosts(synth, tmp_path):
    """Two ranks that join through torchrun's environment as two hosts
    (LOCAL_WORLD_SIZE 1): each host's shard is the JAX package's
    (i, 2) shard of the train split under ``shard_by_process`` (the val
    split stays whole), the global batch is hosts x batch_size (three
    rows each here), each rank's rows are its host's, and gathering gives
    the six rows in host order."""
    cfg = _tiny_train_cfg(*synth)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = W.spawn("hosts", 2, tmp_path, {"cfg": cfg}, torchrun_port=port)
    for r, o in enumerate(out):
        assert o["shard"] == (r, 2) and o["mesh"] == {"data": 2, "model": 1}
        want = [m["model"] for m in jax_get_dataset("train", cfg, shard=(r, 2)).models]
        assert o["train"] == want
        assert o["val"] == len(jax_get_dataset("val", cfg))
        assert o["rows"] == (3 * r, 3 * r + 3, 6, 3 * r, False)
        assert o["gathered"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]


# ---------------------------------------------------------------------------
# the data-parallel VTacO step

@pytest.fixture(scope="module")
def vtaco(synth):
    """tests/test_parallel.py's VTacO config, the JAX mesh step at data = 2
    with its draws, the port's one-process step on the same weights and
    global batch, and one B = 1 validation batch."""
    cfg = _tiny_train_cfg(*synth)
    jmodel, _ = jax_get_model(copy.deepcopy(cfg))
    np.random.seed(0)
    batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), 2, num_workers=1,
                                     seed=0)))
    np.random.seed(1)
    val = next(iter(JaxBatchLoader(jax_get_dataset("val", cfg, return_idx=True), 1,
                                   shuffle=False, num_workers=1)))
    jtr = JaxTrainer.from_config(jmodel, cfg, mesh_bank=jax_build_mesh_bank(cfg),
                                 device_mesh=jax_make_mesh(data=2),
                                 contact_per_finger=PER_FINGER)
    state0 = jtr.init_state(batch)
    params, stats = _np(state0.params), _np(state0.batch_stats)
    a = jtr.prepare_batch(batch)
    H, W_ = a["imgs"].shape[2:4]
    _, step_rng = jax.random.split(state0.rng)
    draws = jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                      np.asarray(jtr._depth_origin_for(H * W_)), a["points"].shape[1],
                      jtr.num_sample, PER_FINGER, jax.random.split(step_rng)[1])
    state1, want = jtr.train_step(state0, batch)
    jax_state = TI.export_state_dict(_np(state1.params), _np(state1.batch_stats))

    model = load_jax_params(get_model(copy.deepcopy(cfg), device="cpu"), params, stats)
    tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                             contact_per_finger=PER_FINGER)
    one = tr.train_step(batch, draws=draws)
    p = {"cfg": cfg, "params": params, "stats": stats, "per_finger": PER_FINGER,
         "batch": batch, "draws": draws, "val_batch": val,
         "ids": np.array([[0, 1], [1, 0]])}
    return {"payload": p, "jax": want, "jax_state": jax_state, "one": one,
            "one_state": W.state(model), "one_eval": tr.eval_step(val),
            "params": params, "names": [n for n, _ in model.named_parameters()]}


@pytest.fixture(scope="module")
def dp_run(vtaco, tmp_path_factory):
    return W.spawn("dp_vtaco", 2, tmp_path_factory.mktemp("dp"), vtaco["payload"])


def test_dp_step_matches_jax(vtaco, dp_run):
    """The port's 2-rank step equals the JAX package's data = 2 mesh step
    and its own one-process step on the global batch; both ranks hold the
    same parameters and BatchNorm statistics after it, those of the whole
    batch."""
    r0, r1 = dp_run
    assert r0["mesh"] == {"data": 2, "model": 1} and r0["shard"] == (0, 1)
    assert r0["scalars"] == r1["scalars"]
    assert_scalars(r0["scalars"], vtaco["jax"])
    assert_scalars(r0["scalars"], vtaco["one"])
    for k, v in r0["state"].items():
        torch.testing.assert_close(r1["state"][k], v, rtol=0, atol=0)
    assert_params(r0["state"], vtaco["jax_state"], vtaco["names"])
    assert_params(r0["state"], vtaco["one_state"], vtaco["names"])
    stats = [k for k in vtaco["one_state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        want = vtaco["one_state"][k].numpy()
        assert np.abs(r0["state"][k].numpy() - want).max() <= 1e-5 * np.abs(want).max(), k


def test_dp_eval_replicated(vtaco, dp_run):
    """A B = 1 validation batch does not divide the data axis: every rank
    evaluates it whole, to the one-process evaluation's values."""
    r0, r1 = dp_run
    assert r0["eval"] == r1["eval"]
    assert set(r0["eval"]) == set(vtaco["one_eval"]) >= {"iou", "loss"}
    for k, v in vtaco["one_eval"].items():
        assert abs(r0["eval"][k] - v) <= 1e-4 * max(abs(v), 1), (k, r0["eval"][k], v)


def test_dp_fused_block(vtaco, dp_run):
    """Two fused steps on the device-resident split under the mesh (each
    rank assembles its rows; the draws are the global batch's) equal the
    same block on one rank alone."""
    r0, r1 = dp_run
    for k, v in r0["fused_one"].items():
        assert v.shape == (2,)
        np.testing.assert_allclose(r0["fused"][k], v, rtol=2e-5, err_msg=k)
        np.testing.assert_array_equal(r0["fused"][k], r1["fused"][k])
    assert_params(r0["fused_state"], r0["fused_one_state"], vtaco["names"])


# ---------------------------------------------------------------------------
# tensor parallelism

@pytest.fixture(scope="module")
def tp_run(vtaco, tmp_path_factory):
    return W.spawn("tp_vtaco", 4, tmp_path_factory.mktemp("tp"), vtaco["payload"])


def test_tp_partitions_jax_leaves(vtaco, tp_run):
    """At (data=2, model=2) with min_shard 4 the port partitions the
    parameters that the JAX rule partitions, by export name, on each
    rank its slice; the linear and convolution layers among them compute
    column-parallel."""
    marks = jax.tree.map(
        lambda x: np.full(x.shape, float(jax_tp_spec(x.shape, 2, 4) != P()), np.float32),
        vtaco["params"])
    want = {k for k, v in TI.export_state_dict(marks, {}).items() if v.size and v.min() == 1}
    spec = tp_run[0]["spec"]
    assert set(spec) == want
    full = {k: v.shape for k, v in vtaco["one_state"].items()}
    assert sum(len(full[k]) >= 2 for k in spec) >= 5
    for r in tp_run:
        assert r["spec"] == spec
        local = {k.replace(".parametrizations.", ".").replace(".original", ""): v
                 for k, v in r["local_shapes"].items()}
        for k, ax in spec.items():
            want_shape = list(full[k])
            want_shape[ax] //= 2
            assert local[k] == tuple(want_shape), k
    assert [tuple(r["coord"]) for r in tp_run] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the layers that compute column-parallel, convolutions among them
    kinds = set(tp_run[0]["column"])
    assert {"ParametrizedLinear", "ParametrizedConv3d", "ParametrizedConv2d"} <= kinds, kinds


def test_tp_step_matches_dp(vtaco, dp_run, tp_run):
    """The (2, 2) step equals the JAX package's data = 2 mesh step and the
    port's data-parallel step, under the JAX tests' tolerances; every rank
    holds the same whole parameters after it, and Adam's moments gather
    whole."""
    for r in tp_run:
        assert_scalars(r["scalars"], vtaco["jax"])
        assert_scalars(r["scalars"], dp_run[0]["scalars"])
        for k, v in tp_run[0]["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=0)
        assert r["eval"] == tp_run[0]["eval"]
    assert_params(tp_run[0]["state"], vtaco["jax_state"], vtaco["names"])
    assert_params(tp_run[0]["state"], dp_run[0]["state"], vtaco["names"])
    assert len(tp_run[0]["moments"]) >= 5
    for k, m in tp_run[0]["moments"].items():
        assert m.shape == vtaco["one_state"][k].shape
    for k, v in dp_run[0]["eval"].items():
        assert abs(tp_run[0]["eval"][k] - v) <= 1e-4 * max(abs(v), 1), k


# ---------------------------------------------------------------------------
# the tactile stack: BatchNorm and min-max over the whole batch, loop.train

@pytest.fixture(scope="module")
def tactile(synth, tmp_path_factory):
    cfg = _small_cfg("configs/tactile/tactile_test.yaml", *synth)
    cfg["training"]["matmul_precision"] = "highest"
    jmodel, _ = jax_get_model(copy.deepcopy(cfg))
    np.random.seed(0)
    batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                     num_workers=1, seed=0)))
    # the synthetic samples share their depth range: raise the second's by
    # 1 mm, so that a min-max over one rank's rows differs from the batch's
    batch["inputs.depth"] = np.asarray(batch["inputs.depth"]).copy()
    batch["inputs.depth"][1] += 0.001
    jtr = JaxTrainer.from_config(jmodel, cfg, device_mesh=jax_make_mesh(data=2))
    state0 = jtr.init_state(batch)
    params, stats = _np(state0.params), _np(state0.batch_stats)
    state1, want = jtr.train_step(state0, batch)

    model = load_jax_params(get_model(copy.deepcopy(cfg), device="cpu"), params, stats)
    one = Trainer.from_config(model, cfg).train_step(batch)
    depths = torch.as_tensor(batch["inputs.depth"])
    model64 = load_jax_params(get_model(copy.deepcopy(cfg), device="cpu"), params, stats)
    tr64 = Trainer(model64.double().train(), train_tactile=True)
    a = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
         for k, v in tr64.prepare_batch(batch).items()}
    with torch.no_grad():
        exact = {k: float(v) for k, v in tr64._compute_loss_tactile(a)[1].items()}

    loop_cfg = copy.deepcopy(cfg)
    loop_cfg["training"].update(batch_size=2, validate_every=1, checkpoint_every=1,
                                print_every=1, visualize_every=0, n_workers=1,
                                n_workers_val=1)
    p = {"cfg": cfg, "params": params, "stats": stats, "per_finger": PER_FINGER,
         "batch": batch, "loop_cfg": loop_cfg,
         "loop_dir": str(tmp_path_factory.mktemp("loop"))}
    out = W.spawn("dp_tactile", 2, tmp_path_factory.mktemp("tactile"), p)
    return {"jax": want, "one": one, "one_state": W.state(model), "exact": exact,
            "minmax": _minmax_norm(depths).numpy(),
            "f64": {k: v.numpy() for k, v in model64.state_dict().items()},
            "jax_state": TI.export_state_dict(_np(state1.params), _np(state1.batch_stats)),
            "out": out, "loop_dir": p["loop_dir"]}


def test_tactile_dp_whole_batch_statistics(tactile):
    """The tactile step at data = 2 equals the one-process step on the
    global batch and the JAX mesh step (loss scalars and statistics by
    assert_batch_stat's rule), while each rank's rows alone, with local
    BatchNorm and min-max, give other losses and statistics; the depth
    min-max over the group equals the whole batch's on each rank's rows,
    and differs from the rows' own."""
    r0, r1 = tactile["out"]
    assert r0["scalars"] == r1["scalars"]
    for k, v in tactile["one"].items():
        assert_batch_stat(k, r0["scalars"][k], v, tactile["exact"][k])
        assert_batch_stat(k, r0["scalars"][k], tactile["jax"][k], tactile["exact"][k])
    # the mean of the ranks' local losses is the loss of local statistics
    gap = rel(r0["scalars"]["loss_depth"], tactile["one"]["loss_depth"])
    local = np.mean([r["local_scalars"]["loss_depth"] for r in (r0, r1)])
    print("loss_depth: data-parallel", gap, "local", rel(local, tactile["one"]["loss_depth"]))
    assert rel(local, tactile["one"]["loss_depth"]) > max(10 * gap, 1e-5)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["minmax"], tactile["minmax"][r["rank"]:][:1])
        assert np.abs(r["minmax_local"] - r["minmax"]).max() > 1e-3
    stats = [k for k in tactile["one_state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 6
    for k in stats:
        assert_batch_stat(k, r0["state"][k].numpy(), tactile["one_state"][k].numpy(),
                          tactile["f64"][k])
        for r in (r0, r1):
            d = np.abs(r["local_state"][k].numpy() - tactile["one_state"][k].numpy()).max()
            assert d > 1e-4 * np.abs(tactile["one_state"][k].numpy()).max(), k
    names = [k for k in tactile["one_state"] if k not in stats
             and not k.endswith("num_batches_tracked")]
    assert_params(r0["state"], tactile["jax_state"], names)
    assert_params(r0["state"], tactile["one_state"], names)


def test_loop_train_dp(tactile):
    """``loop.train`` for two steps at data = 2 with validation and a
    checkpoint at each: the mesh from training.mesh, the same parameters
    on both ranks, and rank 0 alone writes (rank 1's out_dir stays empty);
    the train CLI with --cpu inside the group trains on its mesh too,
    rank 0 alone writing."""
    r0, r1 = tactile["out"]
    assert r0["loop"]["mesh"] == {"data": 2, "model": 1}
    assert r0["loop"]["it"] == r1["loop"]["it"] == 2 and r0["loop"]["step"] == 2
    for k, v in r0["loop"]["state"].items():
        torch.testing.assert_close(r1["loop"]["state"][k], v, rtol=0, atol=0)
    d0, d1 = (os.path.join(tactile["loop_dir"], f"rank{r}") for r in (0, 1))
    assert {"model.ckpt", "model_best.ckpt", "logs"} <= set(os.listdir(d0))
    written = [f for _, _, fs in os.walk(d1) for f in fs]
    assert written == []
    with open(os.path.join(d0, "logs", "metrics.jsonl")) as f:
        tags = [line for line in f if '"val/' in line]
    assert tags
    assert {"config.yaml", "model.ckpt"} <= set(r0["cli_files"]) and r1["cli_files"] == []
