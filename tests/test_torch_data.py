"""The PyTorch port's data, checkpoint and train-loop surface against the
JAX package: the synthetic generator, mesh IO, Shapes3dDataset items and
loader order, the checkpoint round trip, the pretrained-t2d graft (alone
and against the JAX loop's), the ``exit_after`` contract and the train CLI on the CPU, then a mesh
reconstructed from the checkpoint it wrote.

Tolerances: the synthetic generator's hand vertices 1e-6 (the MANO layers
of the two packages round differently), everything else exact.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import collate_batch as jax_collate
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.utils import meshio as jax_meshio
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model
from vtaco_tpu_torch.data.core import BatchLoader, collate_batch
from vtaco_tpu_torch.data.synthetic import generate
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.trainer import Trainer
from vtaco_tpu_torch.utils import meshio

from test_trainer import _small_cfg

SYNTH = dict(n_models=4, n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The port's synthetic set (the same arrays as the JAX package's,
    test_synthetic_matches_jax)."""
    return generate(str(tmp_path_factory.mktemp("synth")), **SYNTH)


def small_cfg(synth, out_dir=None, **training):
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    cfg["training"].update(dict(batch_size=2, n_workers=1, n_workers_val=1,
                                validate_every=-1, visualize_every=-1, print_every=1),
                           **training)
    if out_dir is not None:
        cfg["training"]["out_dir"] = str(out_dir)
    return cfg


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_synthetic_matches_jax(tmp_path):
    jroot, jmesh = jax_generate(str(tmp_path / "jax"), **SYNTH)
    root, mesh = generate(str(tmp_path / "port"), **SYNTH)
    files = []
    for base, jbase in ((root, jroot), (mesh, jmesh)):
        for dirpath, _, names in os.walk(jbase):
            rel = os.path.relpath(dirpath, jbase)
            files += [(os.path.join(base, rel, n), os.path.join(dirpath, n)) for n in names]
    assert len(files) == 4 * 2 + 3 + 4 + 1
    for got, want in files:
        if got.endswith(".npz"):
            a, b = _npz(got), _npz(want)
            assert a.keys() == b.keys(), got
            for k in a:
                if k == "pc_hand":
                    np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{got}:{k}")
        else:
            with open(got) as f, open(want) as g:
                assert f.read() == g.read(), got


def test_meshio_matches_jax(tmp_path):
    for got, want in ((meshio.icosphere(2, radius=0.3), jax_meshio.icosphere(2, radius=0.3)),
                      (meshio.box((0.2, 0.4, 0.5)), jax_meshio.box((0.2, 0.4, 0.5)))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    v, f = meshio.icosphere(1, radius=0.5)
    meshio.write_off(str(tmp_path / "m.off"), v, f)
    jax_meshio.write_off(str(tmp_path / "j.off"), v, f)
    assert (tmp_path / "m.off").read_text() == (tmp_path / "j.off").read_text()
    for a, b in zip(meshio.read_triangle_mesh(str(tmp_path / "m.off")),
                    jax_meshio.read_triangle_mesh(str(tmp_path / "m.off"))):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "m.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1/1 3/3 4/4 2/2\n")
    for a, b in zip(meshio.read_triangle_mesh(str(tmp_path / "m.obj")),
                    jax_meshio.read_triangle_mesh(str(tmp_path / "m.obj"))):
        np.testing.assert_array_equal(a, b)


def _assert_same_item(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], (str, list, int)):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_item_matches_jax(synth, split):
    """Shapes3dDataset[i] key for key under the same np.random.seed (the
    subsampling, the cloud noise and the image noise draw from it), and
    the collated batch."""
    cfg = small_cfg(synth)
    ours = get_dataset(split, cfg, return_idx=split == "val")
    theirs = jax_get_dataset(split, cfg, return_idx=split == "val")
    assert len(ours) == len(theirs) > 0
    got, want = [], []
    for i in range(len(ours)):
        np.random.seed(100 + i)
        want.append(theirs[i])
        np.random.seed(100 + i)
        got.append(ours[i])
        _assert_same_item(got[-1], want[-1])
    assert got[0]["inputs.img"].shape == (5, 16, 12, 3)
    _assert_same_item(collate_batch(got), jax_collate(want))


def test_batch_loader_order_matches_jax(synth):
    """Two shuffled epochs from one seed visit the samples in the JAX
    loader's order; drop_last keeps every batch full."""
    cfg = small_cfg(synth)
    cfg["data"]["train_split"] = "test"
    ds, jds = get_dataset("val", cfg), jax_get_dataset("val", cfg)
    ds.models = jds.models = ds.models * 5
    loader = BatchLoader(ds, 2, shuffle=True, num_workers=2, seed=3)
    jloader = JaxBatchLoader(jds, 2, shuffle=True, num_workers=2, seed=3)
    assert len(loader) == len(jloader) == len(ds) // 2
    for _ in range(2):
        got = [b["points.name"] for b in loader]
        want = [b["points.name"] for b in jloader]
        assert got == want and all(len(b) == 2 for b in got)
    val = BatchLoader(get_dataset("val", cfg, return_idx=True), 1, shuffle=False,
                      num_workers=1)
    assert [b["idx"].tolist() for b in val] == [[0]]


def _trained(cfg, steps=1):
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    tr = Trainer.from_config(model, cfg, mesh_bank=loop.build_mesh_bank(cfg, "cpu"))
    batch = next(iter(BatchLoader(get_dataset("train", cfg), 2, num_workers=1, seed=0)))
    for _ in range(steps):
        tr.train_step(batch)
    return tr, batch


def test_checkpoint_round_trip(synth, tmp_path):
    """Model and Adam state and the loop's scalars survive save and load;
    the restored trainer's next step equals the original's."""
    cfg = small_cfg(synth)
    tr, batch = _trained(cfg)
    CheckpointIO(str(tmp_path), model=tr.model, optimizer=tr.optimizer).save(
        "model.ckpt", epoch_it=2, it=7, loss_val_best=0.25)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    torch.manual_seed(1)
    model = get_model(cfg, device="cpu")
    tr2 = Trainer.from_config(model, cfg, mesh_bank=tr.mesh_bank)
    ckpt = CheckpointIO(str(tmp_path))
    ckpt.register_modules(model=model, optimizer=tr2.optimizer)
    assert ckpt.load(str(tmp_path / "model.ckpt")) == {
        "epoch_it": 2, "it": 7, "loss_val_best": 0.25}
    for k, v in tr.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    a = tr.prepare_batch(batch)
    H, W = a["imgs"].shape[2:4]
    draws = C.contact_draws(a["depths"], a["touch_success"], tr._depth_origin_for(H * W),
                            a["points"].shape[1], tr.num_sample, tr.contact_per_finger,
                            torch.Generator().manual_seed(5))
    a, b = tr.train_step(batch, draws), tr2.train_step(batch, draws)
    assert a == b
    for k, v in tr.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        ckpt.load("absent.ckpt")


def test_graft_t2d(synth, tmp_path, capsys):
    """The pretrained t2d parameters come from a tactile experiment's
    encoder_hand and encoder_img; the BatchNorm running statistics and
    counters stay as built, as the JAX package grafts ``params`` only; a
    missing file warns, a structure that differs raises."""
    cfg = small_cfg(synth)
    model = get_model(cfg, device="cpu")
    before = copy.deepcopy(model.encoder_t2d.state_dict())
    params = {n for n, _ in model.encoder_t2d.named_parameters()}
    assert len(params) < len(before)          # the U-Net's statistics
    src = {f"{sub}.{k}": (v + 1.0 if v.is_floating_point() else v + 3)
           for sub in ("encoder_hand", "encoder_img")
           for k, v in getattr(model.encoder_t2d, sub).state_dict().items()}

    class Holder(torch.nn.Module):
        def __init__(self, sd):
            super().__init__()
            self.sd = sd

        def state_dict(self):
            return copy.deepcopy(self.sd)

    CheckpointIO(str(tmp_path), model=Holder(src)).save("t2d.ckpt")
    loop.graft_t2d(model, "t2d.ckpt", str(tmp_path))
    for k, v in model.encoder_t2d.state_dict().items():
        assert torch.equal(v, src[k] if k in params else before[k]), k
    assert "loaded pretrained t2d weights" in capsys.readouterr().out

    loop.graft_t2d(model, "absent.ckpt", str(tmp_path))
    assert "not found" in capsys.readouterr().out
    for fault in ("shape", "missing"):
        bad = dict(src)
        if fault == "shape":
            bad["encoder_img.conv_final.bias"] = torch.zeros(3)
        else:
            del bad["encoder_img.conv_final.bias"]
        CheckpointIO(str(tmp_path), model=Holder(bad)).save("t2d.ckpt")
        with pytest.raises(ValueError, match="conv_final.bias"):
            loop.graft_t2d(model, "t2d.ckpt", str(tmp_path))


def test_graft_t2d_matches_jax(synth, tmp_path, monkeypatch, capsys):
    """The JAX loop and the port's graft the same tactile run (random
    weights, saved in each package's checkpoint format) into the same
    VTacO weights: every encoder_t2d entry is equal afterwards, the
    tactile parameters and VTacO's own running statistics. The JAX loop
    is stopped at its first train step, where its state is taken."""
    from vtaco_tpu.core import torch_import as TI
    from vtaco_tpu.core.checkpoint import CheckpointIO as JaxCheckpointIO
    from vtaco_tpu.core.config import get_model as jax_get_model
    from vtaco_tpu.train import loop as jax_loop
    from vtaco_tpu.train.trainer import Trainer as JaxTrainer
    from vtaco_tpu_torch.core.weights import load_jax_params

    from test_torch_setup import random_tree

    def weights(cfg, seed):
        jmodel, _ = jax_get_model(cfg)
        batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), 2, num_workers=1)))
        shapes = JaxTrainer.from_config(jmodel, cfg).init_state_abstract(batch)
        rng = np.random.default_rng(seed)
        return random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)

    tac_cfg = _small_cfg("configs/tactile/tactile_test.yaml", *synth)
    tp, ts = weights(tac_cfg, 31)
    JaxCheckpointIO(str(tmp_path / "jax"), state={"params": tp, "batch_stats": ts}).save(
        "tac.ckpt")
    tac_model = get_model(tac_cfg, device="cpu")
    load_jax_params(tac_model, tp, ts)
    CheckpointIO(str(tmp_path / "port"), model=tac_model).save("tac.ckpt")

    cfg = small_cfg(synth, tmp_path / "jax")
    cfg["model"]["encoder_t2d_kwargs"]["model_file"] = "tac.ckpt"
    vp, vs = weights(cfg, 32)

    class Stop(Exception):
        pass

    def first_step(self, state, batch):
        raise Stop(state)

    monkeypatch.setattr(JaxTrainer, "init_state", lambda self, batch, rng=None:
                        self._state_from_variables({"params": vp, "batch_stats": vs}))
    monkeypatch.setattr(JaxTrainer, "train_step", first_step)
    with pytest.raises(Stop) as stop:
        jax_loop.train(cfg, max_iters=1)
    state = stop.value.args[0]
    want = {k: v for k, v in TI.export_state_dict(state.params, state.batch_stats).items()
            if k.startswith("encoder_t2d.")}

    model = get_model(cfg, device="cpu")
    load_jax_params(model, vp, vs)
    loop.graft_t2d(model, "tac.ckpt", str(tmp_path / "port"))
    out = capsys.readouterr().out
    assert out.count("loaded pretrained t2d weights") == 2
    got = {f"encoder_t2d.{k}": v for k, v in model.encoder_t2d.state_dict().items()}
    assert set(got) == set(want) | {k for k in got if k.endswith("num_batches_tracked")}
    tactile = TI.export_state_dict(tp, ts)
    own = TI.export_state_dict(vp, vs)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        # parameters from the tactile run, statistics VTacO's own
        src = own[k] if "running" in k else tactile[k[len("encoder_t2d."):]]
        np.testing.assert_array_equal(v, src, err_msg=k)
    assert any("running" in k for k in want)
    assert all(int(v) == 0 for k, v in got.items() if k.endswith("num_batches_tracked"))


def test_exit_after_preemption(synth, tmp_path):
    """exit_after: the loop saves model.ckpt and exits with code 3."""
    cfg = small_cfg(synth, tmp_path)
    with pytest.raises(SystemExit) as e:
        loop.train(cfg, exit_after=1, device="cpu")
    assert e.value.code == 3
    scalars = CheckpointIO(str(tmp_path)).load_raw("model.ckpt")[1]
    assert scalars["it"] >= 1 and scalars["epoch_it"] >= 1


def test_train_cli_then_mesh(synth, tmp_path, capsys):
    """The train CLI on --cpu for 2 steps with validation and a checkpoint;
    a resume continues from its iteration; then a mesh reconstructed in
    contact mode from the model the checkpoint restores."""
    from vtaco_tpu_torch.cli.train import main

    out_dir = tmp_path / "out"
    cfg = small_cfg(synth, out_dir, validate_every=2, checkpoint_every=2)
    # nx = 16; the 'mean' iso level, as a barely trained field's narrow
    # logit range can miss the midpoint
    cfg["generation"].update(resolution_0=4, mc_level="mean")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main([str(path), "--max-iters", "2", "--cpu"])
    for f in ("config.yaml", "model.ckpt", "model_best.ckpt"):
        assert (out_dir / f).exists(), f
    rows = [json.loads(line) for line in open(out_dir / "logs" / "metrics.jsonl")]
    tags = {r["tag"] for r in rows}
    assert {"train/loss", "train/loss_l1", "val/iou", "val/iou_fixed"} <= tags
    # (val/iou_fixed is NaN, 0/0, when neither side reaches the threshold,
    # as in the JAX package)
    assert all(np.isfinite(r["value"]) for r in rows if r["tag"].startswith("train/"))
    assert max(r["it"] for r in rows) == 2

    main([str(path), "--max-iters", "3", "--cpu"])
    assert "resumed at it=2" in capsys.readouterr().out
    assert CheckpointIO(str(out_dir)).load_raw("model.ckpt")[1]["it"] == 3

    model = get_model(cfg, device="cpu")
    CheckpointIO(str(out_dir), model=model).load("model.ckpt")
    model.eval()
    batch = next(iter(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    gen = get_generator(model, cfg)
    with torch.no_grad():
        (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
    assert gen.with_img   # contact gating
    assert len(faces) > 0 and np.isfinite(verts).all() and np.isfinite(cd)
