"""JAX checkpoints in the port, read without JAX (core/flax_msgpack.py,
core/checkpoint.py, core/weights.py:jax_checkpoint_to_torch), and the
rest of the JAX CheckpointIO: save_async/wait and URL loads.

- The msgpack reader against ``flax.serialization.msgpack_restore`` on
  files the JAX package's CheckpointIO writes: nested parameters, a
  bfloat16 leaf, numpy scalars, ``_scalars``, and arrays over flax's
  MAX_CHUNK_SIZE (monkeypatched small) written in chunks; bit for bit.
  Unknown extension types, dtypes and header bytes raise.
- A VTacO_YCB model.ckpt (tests/test_torch_train.py's small widths and
  random weights) after two JAX train steps: the port's model equal bit
  for bit to ``load_jax_params`` on the same trees, Adam's moments and
  step equal to optax's; the port's next step from it against JAX's next
  step with JAX's draws fed in: the loss scalars at the step tests'
  5e-4 relative, and every updated parameter within 1e-6 of JAX's (Adam
  moves each by about lr = 1e-4 a step; a port without the loaded
  moments would be that far off).
- The t2d graft from a JAX tactile file equal to the JAX loop's graft.
- ``cli.generate --cpu --checkpoint <JAX file>`` on a one-object split
  against the JAX CLI at float32 transfers, ungated (``with_img`` false:
  the two packages subsample a finger's contact pixels with different
  random streams): the same faces, vertices within tests/
  test_torch_generate.py's bound plus the files' rounding.
- ``save_async`` + ``wait`` writing what ``save`` writes, state copied at
  the call; the URL load through a monkeypatched urlopen (cached by base
  name; URLError with JAX's message), with no network.
"""

import copy
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.checkpoint import CheckpointIO as JaxCheckpointIO
from vtaco_tpu.data.core import Shapes3dDataset as JaxDataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core import flax_msgpack
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_generator, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data.core import Shapes3dDataset
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.utils import meshio

from test_torch_generate import _vertex_bound
from test_torch_inference import IMG_H, IMG_W, _batches, _pair
from test_torch_train import (  # noqa: F401  (fixtures)
    PER_FINGER, jax_draws, port_trainer, setup, synth)
from test_torch_setup import random_tree
from test_trainer import _small_cfg


def T(x):
    return torch.as_tensor(np.array(x))


# -- the reader -------------------------------------------------------------

def _same(got, want, path="/"):
    """The port's decoded tree equal to flax's, leaf types and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}{k}/")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _tree(rng):
    return {"params": {"dense": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                                 "bias": np.zeros(5, np.float32)},
                       "half": jnp.asarray(rng.standard_normal(9), jnp.bfloat16),
                       "big": rng.standard_normal((40, 3)).astype(np.float32)},
            "opt": {"count": np.int32(3), "flags": np.array([True, False]),
                    "i64": np.arange(4, dtype=np.int64), "f64": np.float64(0.25)},
            "step": np.uint32(7)}


@pytest.mark.parametrize("chunked", [False, True])
def test_reader_matches_flax(tmp_path, monkeypatch, rng, chunked):
    if chunked:   # "big" (480 B) and "kernel" (140 B) go in chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    JaxCheckpointIO(str(tmp_path), state=_tree(rng)).save(
        "x.ckpt", epoch_it=3, it=7, loss_val_best=0.5)
    data = (tmp_path / "x.ckpt").read_bytes()
    assert (b"__msgpack_chunked_array__" in data) == chunked
    _same(flax_msgpack.loads(data), serialization.msgpack_restore(data))
    payload, scalars = CheckpointIO(str(tmp_path)).load_raw("x.ckpt")
    assert scalars == {"epoch_it": 3, "it": 7, "loss_val_best": 0.5}
    assert isinstance(scalars["it"], int)
    assert set(payload) == {"model"}


@pytest.mark.parametrize("blob,match", [
    (b"\x81\xa1a\xd4\x09\x00", "extension type 9"),
    (b"\x81\xa1a\xc7\x0c\x01\x93\x91\x01\xa5qint8\xc4\x01\x00", "dtype 'qint8'"),
    (b"\x81\xa1a\xc1", "header byte 0xc1"),
    (b"\x82\xa1a\x01", "truncated"),
    (b"\x81\xa1a\x01\x02", "1 bytes after"),
])
def test_reader_raises_on_what_flax_does_not_write(blob, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(blob)


def test_checkpoint_format_by_first_bytes(tmp_path):
    (tmp_path / "odd.ckpt").write_bytes(b"\x80\x02junk")
    with pytest.raises(ValueError, match="neither a torch.save zip nor a flax msgpack"):
        CheckpointIO(str(tmp_path)).load_raw("odd.ckpt")
    with pytest.raises(FileNotFoundError):
        CheckpointIO(str(tmp_path)).load_raw("absent.ckpt")


# -- a JAX model.ckpt after two JAX steps ----------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(setup, tmp_path_factory):
    """tests/test_torch_train.py's VTacO weights, two JAX train steps on its
    batch, saved by the JAX CheckpointIO: (directory, the JAX state)."""
    cfg, jtr, batch, params, stats = setup
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    for _ in range(2):
        state, _ = jtr.train_step(state, batch)
    out = tmp_path_factory.mktemp("jax_ckpt")
    JaxCheckpointIO(str(out), state=state).save("model.ckpt", epoch_it=1, it=2,
                                                loss_val_best=0.25)
    return str(out), state


def test_jax_checkpoint_loads_bit_equal(setup, jax_ckpt):
    cfg = setup[0]
    out, state = jax_ckpt
    tr = port_trainer(cfg, setup[3], setup[4])     # other weights, to be replaced
    scalars = CheckpointIO(out, model=tr.model, optimizer=tr.optimizer).load("model.ckpt")
    assert scalars == {"epoch_it": 1, "it": 2, "loss_val_best": 0.25}
    ref = get_model(cfg, device="cpu")
    load_jax_params(ref, state.params, state.batch_stats)
    got, want = tr.model.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    adam = state.opt_state[0]
    mu, nu = TI.export_state_dict(adam.mu, {}), TI.export_state_dict(adam.nu, {})
    for name, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        assert torch.equal(st["exp_avg"], T(mu[name])), name
        assert torch.equal(st["exp_avg_sq"], T(nu[name])), name
        assert float(st["step"]) == int(adam.count) == 2
    assert any(float(torch.abs(s["exp_avg"]).max()) > 0 for s in tr.optimizer.state.values())
    # load_raw: the same torch-named state_dict, for partial restores
    payload, _ = CheckpointIO(out).load_raw("model.ckpt")
    assert set(payload["model"]) == set(want) - {k for k in want
                                                 if k.endswith("num_batches_tracked")}


def test_resumed_step_matches_jax(setup, jax_ckpt):
    """The port's step after loading the JAX file against JAX's next step
    from the same state (its compiled train_step), with JAX's draws."""
    cfg, jtr, batch = setup[:3]
    out, state = jax_ckpt
    new_state, want = jtr.train_step(state, batch)
    key = jax.random.split(jax.random.split(state.rng)[1])[1]   # as jax_step's
    a = jtr.prepare_batch(batch)
    H, W = a["imgs"].shape[2:4]
    draws = jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                      np.asarray(jtr._depth_origin_for(H * W)), a["points"].shape[1],
                      jtr.num_sample, PER_FINGER, key)
    tr = port_trainer(cfg, setup[3], setup[4])
    scalars = CheckpointIO(out, model=tr.model, optimizer=tr.optimizer).load("model.ckpt")
    tr.step = int(scalars["it"])
    got = tr.train_step(batch, draws=draws)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=5e-4, abs=5e-5), (k, got[k], want[k])
    new = TI.export_state_dict(new_state.params, {})
    moved = 0.0
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name], atol=1e-6, rtol=0,
                                   err_msg=name)
        moved = max(moved, float(np.abs(new[name] - TI.export_state_dict(
            state.params, {})[name]).max()))
    assert moved > 5e-5


def test_loop_resumes_jax_checkpoint(setup, jax_ckpt, tmp_path, capsys):
    """``loop.train`` resumes from the JAX model.ckpt in its out_dir (it,
    epoch_it and the best metric from its scalars, the Trainer's step),
    takes one step, and writes the rolling model.ckpt and the backup in
    the background and the final model.ckpt after them, in the port's
    format."""
    import shutil

    cfg = copy.deepcopy(setup[0])
    shutil.copy(os.path.join(jax_ckpt[0], "model.ckpt"), tmp_path / "model.ckpt")
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, n_workers=1,
                           n_workers_val=1, validate_every=-1, visualize_every=-1,
                           checkpoint_every=1, backup_every=3, print_every=1)
    trainer, it = loop.train(cfg, max_iters=3, device="cpu")
    out = capsys.readouterr().out
    assert "=> resumed at it=2" in out and it == 3 and trainer.step == 3
    for name in ("model.ckpt", "model_3.ckpt"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(4) == b"PK\x03\x04", name
        payload = torch.load(tmp_path / name, weights_only=True)
        assert payload["_scalars"]["it"] == 3 and payload["_scalars"]["epoch_it"] == 2
        assert payload["_scalars"]["loss_val_best"] == 0.25
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_committed_jax_checkpoint_matches_its_logits():
    """tests/golden/vtaco_jax.ckpt (written by tests/golden/make_jax_ckpt.py
    with the JAX package) served by the port on the CPU: eval_points and
    eval_points_dense within 1e-4 of the JAX logits beside it, the bar
    chip_smoke.py's jax_ckpt phase holds the card to."""
    golden = os.path.join(os.path.dirname(__file__), "golden")
    with open(os.path.join(golden, "vtaco_jax.yaml")) as f:
        cfg = yaml.safe_load(f)
    ref = np.load(os.path.join(golden, "vtaco_jax_logits.npz"))
    model = get_model(cfg, device="cpu")
    scalars = CheckpointIO(golden, model=model).load("vtaco_jax.ckpt")
    assert scalars["it"] == 2 and scalars["epoch_it"] == 1
    model.eval()
    gen = get_generator(model, cfg)
    with torch.no_grad():
        c = model.encode_inputs(T(ref["inputs"]))
    got_p = gen.eval_points(model, ref["points"], c, transfer_dtype=torch.float32)
    got_l = gen.eval_points_dense(model, 32, c, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got_p, ref["logits_points"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_l, ref["logits_lattice"], atol=1e-4, rtol=0)
    assert np.ptp(ref["logits_lattice"]) > 1.0


# -- the graft from a JAX tactile file -------------------------------------

def test_graft_from_jax_tactile_file_matches_jax(synth, tmp_path, monkeypatch, capsys):
    """The port grafts the JAX tactile file itself (no port copy of it):
    every encoder_t2d entry equals the JAX loop's graft of the same file,
    parameters from the tactile run, running statistics VTacO's own."""
    from vtaco_tpu.core.config import get_model as jax_get_model
    from vtaco_tpu.data import BatchLoader as JaxBatchLoader
    from vtaco_tpu.data.core import get_dataset as jax_get_dataset
    from vtaco_tpu.train import loop as jax_loop

    def weights(cfg, seed):
        jmodel, _ = jax_get_model(cfg)
        batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), 2, num_workers=1)))
        shapes = JaxTrainer.from_config(jmodel, cfg).init_state_abstract(batch)
        rng = np.random.default_rng(seed)
        return random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)

    tac_cfg = _small_cfg("configs/tactile/tactile_test.yaml", *synth)
    tp, ts = weights(tac_cfg, 41)
    JaxCheckpointIO(str(tmp_path), state={"params": tp, "batch_stats": ts}).save("tac.ckpt")
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, n_workers=1,
                           n_workers_val=1, validate_every=-1, visualize_every=-1)
    cfg["model"]["encoder_t2d_kwargs"]["model_file"] = "tac.ckpt"
    vp, vs = weights(cfg, 42)

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
    loop.graft_t2d(model, "tac.ckpt", str(tmp_path))
    assert capsys.readouterr().out.count("loaded pretrained t2d weights") == 2
    got = {f"encoder_t2d.{k}": v for k, v in model.encoder_t2d.state_dict().items()}
    tactile = TI.export_state_dict(tp, ts)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        if "running" not in k:
            np.testing.assert_array_equal(v, tactile[k[len("encoder_t2d."):]], err_msg=k)
    assert any("running" in k for k in want)


# -- the generation CLI on a JAX file --------------------------------------

def test_generate_cli_serves_jax_checkpoint(tmp_path, monkeypatch, capsys):
    """Both CLIs from the same JAX model.ckpt on a one-object test split at
    float32 transfers, ungated, each item's input drawn from its own seed:
    the same last line's split and count, the same faces, vertices within
    _vertex_bound of the two value grids' difference (plus the files'
    rounding), chamfer within 1e-5."""
    from vtaco_tpu.cli.generate import main as jax_main
    from vtaco_tpu_torch.cli.generate import main as port_main

    data = jax_generate(str(tmp_path / "synth"), n_models=4, n_query=500, n_surface=1000,
                        img_h=IMG_H, img_w=IMG_W, seed=7)
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *data)
    cfg["model"]["with_img"] = False
    cfg["generation"].update(resolution_0=4, transfer_dtype="float32")
    jmodel, state, tmodel = _pair(cfg, seed=23)
    first = _batches(cfg, "train")[0]
    full = JaxTrainer.from_config(jmodel, cfg).init_state_abstract(first)
    JaxCheckpointIO(str(tmp_path), state=full.replace(
        params=state.params, batch_stats=state.batch_stats)).save("model.ckpt")
    for cls in (JaxDataset, Shapes3dDataset):
        def seeded(self, idx, _orig=cls.__getitem__):
            np.random.seed(100 + idx)
            return _orig(self, idx)

        monkeypatch.setattr(cls, "__getitem__", seeded)
    ckpt = str(tmp_path / "model.ckpt")
    lines = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        c = copy.deepcopy(cfg)
        c["training"].update(out_dir=str(tmp_path / pkg), n_workers_val=1)
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(c))
        capsys.readouterr()
        main([str(path), "--cpu", "--checkpoint", ckpt])
        out = capsys.readouterr().out
        lines[pkg] = json.loads(out.strip().splitlines()[-1])
        if pkg == "port":
            assert "=> loaded" in out and "(it=None)" in out
    got, want = lines["port"], lines["jax"]
    assert (got["split"], got["n"]) == (want["split"], want["n"]) == ("test", 1)
    assert abs(got["cd_mean"] - want["cd_mean"]) <= 1e-5
    name = _batches(cfg, "test")[0]["points.name"][0]
    tv, tf = meshio.read_off(str(tmp_path / "port" / "generation" / f"{name}_obj.off"))
    jv, jf = meshio.read_off(str(tmp_path / "jax" / "generation" / f"{name}_obj.off"))
    assert len(tf) > 20
    np.testing.assert_array_equal(tf, jf)
    # the value grids behind them, from the same weights and input
    nx, box = 16, 1 + cfg["data"]["padding"]
    inputs = np.asarray(_batches(cfg, "test")[0]["inputs"])
    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, transfer_dtype="float32")
    tgen = get_generator(tmodel, cfg)
    jc = jgen._apply(state, jmodel.encode_inputs, jnp.asarray(inputs), train=False)
    with torch.no_grad():
        tc = tmodel.encode_inputs(T(inputs))
    j = np.asarray(jgen.eval_points_dense(state, nx, jc, transfer_dtype=jnp.float32))
    t = tgen.eval_points_dense(tmodel, nx, tc, transfer_dtype=torch.float32)
    bound = _vertex_bound(jv * nx / box + nx / 2, j.reshape(nx, nx, nx),
                          float(np.abs(t - j).max()))
    assert (np.abs(tv - jv).max(axis=1) <= bound * box / nx + 1e-6).all()


# -- save_async and URLs ---------------------------------------------------

def test_save_async_writes_what_save_writes(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    io = CheckpointIO(str(tmp_path), model=model, optimizer=opt)
    io.save("sync.ckpt", it=5, loss_val_best=0.5)
    futs = [io.save_async("async.ckpt", it=5, loss_val_best=0.5),
            io.save_async("backup.ckpt", it=5, loss_val_best=0.5)]
    with torch.no_grad():          # the state was copied at the call
        model.weight.add_(1.0)
    io.wait()
    assert all(f.done() for f in futs)
    a = torch.load(tmp_path / "sync.ckpt", weights_only=True)
    for name in ("async.ckpt", "backup.ckpt"):
        b = torch.load(tmp_path / name, weights_only=True)
        assert b["_scalars"] == a["_scalars"] == {"it": 5, "loss_val_best": 0.5}
        for k in a["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), k
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        for i, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    io.wait()                       # nothing pending: returns at once


class _Response:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def read(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_url_load_downloads_once(tmp_path, monkeypatch, rng):
    """An http(s) file name is fetched into the checkpoint directory under
    its base name, then loaded like a local file (a JAX file here); a
    second load reads the cached copy."""
    src = tmp_path / "src"
    JaxCheckpointIO(str(src), state=_tree(rng)).save("remote.ckpt", it=4)
    blob = (src / "remote.ckpt").read_bytes()
    calls = []

    def urlopen(url, timeout=None):
        calls.append(url)
        return _Response(blob)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    io = CheckpointIO(str(tmp_path / "ck"))
    url = "https://example.invalid/runs/remote.ckpt?download=1"
    for _ in range(2):
        _, scalars = io.load_raw(url)
        assert scalars == {"it": 4}
    assert calls == [url]
    assert (tmp_path / "ck" / "remote.ckpt").read_bytes() == blob


def test_url_load_without_network_raises(tmp_path, monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.URLError("no route")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    with pytest.raises(urllib.error.URLError, match="checkpoint download failed for "
                                                    "'http://example.invalid/m.ckpt'"):
        CheckpointIO(str(tmp_path)).load("http://example.invalid/m.ckpt")
    assert not os.path.exists(tmp_path / "m.ckpt")
