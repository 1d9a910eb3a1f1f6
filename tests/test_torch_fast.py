"""The ``*_fast`` training configs in the PyTorch port (vtaco_tpu_torch)
against the JAX package, on the CPU at small widths: the device-resident
dataset and its id stream, the norms under bfloat16, selective mixed
precision (a bfloat16 step against JAX's), rematerialization (the
trainer's and UNet3D's), K steps per call and whole-split validation on a
device-resident split, the fused loop's cadences and resume, and each
``*_fast`` config through the train CLI.

Weights carry across through core/weights.load_jax_params; torch cannot
replay jax.random, so the JAX package's draws are fed to the port.

Tolerances: the device sample's gathers exactly, its noise and scaling
within 1e-6; float32 steps as tests/test_torch_train.py (loss scalars
5e-4 relative); a bfloat16 step: the port's float32-to-bfloat16 gap at
most twice the JAX package's own gap (root mean square of the scalars'
relative gaps over three random weight sets, which steadies a statistic
of rounding noise), the port's bfloat16 step within that bar of JAX's, and
each module's gradient cosine to the float32 step at least 1 - 2 (1 -
JAX's), a bar that is below 0, and holds nothing, for the modules whose
gradient the step's rounding scrambles (tests/test_torch_fast_modules.py
holds each module alone against JAX's, and tests/test_torch_fast_trained.py
the step at trained weights); a rematerialized step and a plain step: equal to 1e-6, their
BatchNorm buffers equal; K fused steps and K single steps: equal to
1e-6, and both within the float32 step bars of JAX's make_fused_train_fn
(parameters after the K Adam steps within 5e-3 relative and 5e-4, JAX's
own bar between its fused and single steps).
This file holds the device-resident dataset, the norms and casts of mixed
precision and rematerialization; the bfloat16 steps are in
tests/test_torch_fast_bf16.py (VTacO) and tests/test_torch_fast_bf16_vtacoh.py
(VTacOH and the tactile stack), K steps per call and whole-split
validation in tests/test_torch_fast_fused.py, the fused loop in
tests/test_torch_fast_loop.py and the CLI in tests/test_torch_fast_cli.py.
They import the helpers here.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.device_data import DeviceBatchLoader as JaxDeviceBatchLoader
from vtaco_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.train import contact as JC
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.data.device_data import DeviceBatchLoader, DeviceDataset
from vtaco_tpu_torch.models.layers import BatchNorm2d, frozen_batch_stats
from vtaco_tpu_torch.models.unet3d import GroupNorm, build_unet3d
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_setup import random_tree
from test_torch_tips import jax_tip_draws
from test_torch_train import PER_FINGER, jax_draws
from test_trainer import _small_cfg

CONFIGS = {"vtaco": "configs/VTacO/VTacO_YCB.yaml", "vtacoh": "configs/VTacOH/VTacOH_YCB.yaml",
           "tactile": "configs/tactile/tactile_test.yaml"}
FAST = {"vtaco": "configs/VTacO/VTacO_YCB_fast.yaml",
        "vtacoh": "configs/VTacOH/VTacOH_YCB_fast.yaml",
        "tactile": "configs/tactile/tactile_test_fast.yaml"}
N_POINTS, N_CLOUD = 64, 32


def T(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    """Under pytest-xdist each worker takes its share of the cores for
    torch's intra-op threads while a module of this family runs: with the
    workers' thread pools oversubscribing the cores, the bfloat16 CPU steps
    (oneDNN off) ran 5 to 20 times slower. The checks are unchanged."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Six models, four in the train split and two in val (the port's
    synthetic set is the JAX package's, test_torch_data.py)."""
    return jax_generate(str(tmp_path_factory.mktemp("synth_fast")), n_models=6,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7,
                        splits=(("train", 0.67), ("val", 0.33)))


def small(name, synth, **training):
    cfg = _small_cfg(CONFIGS[name], *synth)
    cfg["training"].update(matmul_precision="highest", **training)
    return cfg


def trainer_kw(name):
    return {"contact_per_finger": PER_FINGER} if name == "vtaco" else {}


def port_trainer(cfg, params, stats, name, **kw):
    model = get_model(cfg, device="cpu")
    load_jax_params(model, params, stats)
    bank = build_mesh_bank(cfg, "cpu") if name == "vtaco" else None
    return Trainer.from_config(model, cfg, mesh_bank=bank, **trainer_kw(name), **kw)


def jax_sample_draws(key, dds, B):
    """The draws DeviceDataset._sample makes from ``key``, in the port's
    form."""
    r_pts, r_pc, r_pcn, r_img = jax.random.split(key, 4)
    d = dds.data
    return {"idx": T(jax.random.randint(r_pts, (B, N_POINTS), 0, d["points"].shape[1])),
            "cidx": T(jax.random.randint(r_pc, (B, N_CLOUD), 0, d["pc_points"].shape[1])),
            "noise_pc": T(jax.random.normal(r_pcn, (B, N_CLOUD, 3))),
            "noise_img": T(jax.random.normal(r_img, (B,) + d["img"].shape[1:]))}


# ---------------------------------------------------------------------------
# the device-resident dataset

def test_device_sample_matches_jax(synth):
    """The stacked split equals the JAX package's; one sample with JAX's
    draws: the gathers exactly, the cloud noise and the image noise and
    scaling within 1e-6; the port's own draws: shapes, dtypes, the legacy
    [0, 1/255] range, and the same batch from the same seed."""
    cfg = small("vtaco", synth)
    ds = get_dataset("train", cfg)
    jd = JaxDeviceDataset(jax_get_dataset("train", cfg),
                          pointcloud_noise=cfg["data"]["pointcloud_noise"])
    d = DeviceDataset(ds, pointcloud_noise=cfg["data"]["pointcloud_noise"], device="cpu")
    assert d.names == jd.names and d.n_models == jd.n_models == 4
    assert d.nbytes() == jd.nbytes() and d.data["img"].dtype == torch.uint8
    for k, v in jd.data.items():
        np.testing.assert_array_equal(d.data[k].numpy(), np.asarray(v), err_msg=k)
    key, ids = jax.random.PRNGKey(5), np.array([0, 3])
    want = jd.sample_batch(key, ids, N_POINTS, N_CLOUD)
    got = d.sample_batch(ids, N_POINTS, N_CLOUD, draws=jax_sample_draws(key, jd, 2))
    assert set(got) == set(want) and got["points.name"] == want["points.name"]
    for k in want:
        if k == "points.name":
            continue
        w = np.asarray(want[k])
        if k == "inputs":
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6, rtol=0)
        elif k == "inputs.img":
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6 / 255, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    own = d.sample_batch(ids, N_POINTS, N_CLOUD, torch.Generator().manual_seed(0))
    again = d.sample_batch(ids, N_POINTS, N_CLOUD, torch.Generator().manual_seed(0))
    assert own["points"].shape == (2, N_POINTS, 3) and own["inputs"].shape == (2, N_CLOUD, 3)
    assert own["inputs.touch_success"].dtype == torch.bool
    assert 0 <= float(own["inputs.img"].min()) and float(own["inputs.img"].max()) <= 1 / 255 + 1e-9
    for k in own:
        if k != "points.name":
            assert torch.equal(own[k], again[k]), k


def test_take_ids_matches_jax(synth):
    """The epoch order and the fused steps' id stream equal the JAX
    loader's for the same seed (numpy's default_rng), and the first
    epoch's ids cover the split."""
    cfg = small("vtaco", synth)
    jd = JaxDeviceDataset(jax_get_dataset("train", cfg))
    d = DeviceDataset(get_dataset("train", cfg), device="cpu")
    for seed in (0, 3):
        jl = JaxDeviceBatchLoader(jd, 2, N_POINTS, N_CLOUD, seed=seed)
        pl = DeviceBatchLoader(d, 2, N_POINTS, N_CLOUD, seed=seed)
        assert len(pl) == len(jl) == 2
        assert ([b["points.name"] for b in pl] == [b["points.name"] for b in jl])
        for k in (3, 1, 5):
            ids = pl.take_ids(k)
            assert ids.dtype == np.int32 and ids.shape == (k, 2)
            np.testing.assert_array_equal(ids, jl.take_ids(k))
    fresh = DeviceBatchLoader(d, 2, N_POINTS, N_CLOUD, seed=1).take_ids(4)
    assert sorted(fresh.ravel()[:4].tolist()) == list(range(4))
    assert isinstance(pl.next_key(), torch.Generator)


# ---------------------------------------------------------------------------
# norms and mixed precision

def test_norms_reduce_in_float32():
    """flax's BatchNorm and GroupNorm (force_float32_reductions): a
    bfloat16 input is reduced and normalized in float32 and returned in
    bfloat16. The port's BatchNorm2d equals its float32 evaluation cast to
    bfloat16, keeps float32 running statistics equal to the float32 run's,
    and inside frozen_batch_stats moves nothing; on the CPU torch's
    GroupNorm on bfloat16, and the port's (models.unet3d.GroupNorm, which
    normalizes in float32 on the card too, where torch's kernel rounds on
    the way: chip_smoke.py), are within one rounding of the float32
    evaluation."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((6, 8, 5, 4), generator=g) * 3 + 1).bfloat16()
    bn16, bn32 = BatchNorm2d(8), BatchNorm2d(8)
    with torch.no_grad():
        for bn in (bn16, bn32):
            bn.weight.copy_(torch.linspace(0.5, 2, 8))
            bn.bias.copy_(torch.linspace(-1, 1, 8))
    y16 = bn16(x)
    y32 = bn32(x.float())
    assert y16.dtype == torch.bfloat16 and bn16.running_mean.dtype == torch.float32
    assert torch.equal(y16, y32.bfloat16())
    for k, v in bn32.state_dict().items():
        assert torch.equal(bn16.state_dict()[k], v), k
    before = copy.deepcopy(bn16.state_dict())
    with frozen_batch_stats():
        assert torch.equal(bn16(x), y16)
    assert all(torch.equal(v, before[k]) for k, v in bn16.state_dict().items())
    bn16.eval()
    assert bn16(x).dtype == torch.bfloat16

    w, b = torch.linspace(0.5, 2, 8).bfloat16(), torch.linspace(-1, 1, 8).bfloat16()
    v = (torch.randn((2, 8, 6, 6, 6), generator=g) * 3 + 1).bfloat16()
    want = torch.nn.functional.group_norm(v.float(), 4, w.float(), b.float(), 1e-5)
    norm = GroupNorm(4, 8)
    with torch.no_grad():
        norm.weight.copy_(w.float())
        norm.bias.copy_(b.float())
    for got in (torch.nn.functional.group_norm(v, 4, w, b, 1e-5), norm(v)):
        assert got.dtype == torch.bfloat16
        # within one bfloat16 rounding of the float32 result (2^-8 relative)
        assert bool(((got.float() - want).abs() <= 2.0 ** -8 * want.abs()).all())
    assert torch.equal(norm(v.float()), want)


def test_cast_params_and_keep_f32_modules(synth):
    """The selective cast (tests/test_trainer.py:188-222): decoder entries
    stay float32, the rest become bfloat16, differentiably; a bare
    ``keep_f32_modules`` string is one module name, not its characters;
    without compute_dtype the parameters pass as they are."""
    cfg = small("vtaco", synth)
    model = get_model(cfg, device="cpu")
    tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                             compute_dtype="bfloat16")
    assert tr.compute_dtype == "bfloat16" and tr.keep_f32_modules == ("decoder",)
    w = torch.ones(2, requires_grad=True)
    cast = tr._cast_params({"decoder.w": torch.ones(2), "encoder.w": w,
                            "encoder.n": torch.ones(2, dtype=torch.int64)})
    assert cast["decoder.w"].dtype == torch.float32
    assert cast["encoder.w"].dtype == torch.bfloat16
    assert cast["encoder.n"].dtype == torch.int64
    cast["encoder.w"].float().sum().backward()
    assert w.grad.dtype == torch.float32 and torch.equal(w.grad, torch.ones(2))
    bare = Trainer.from_config(model, cfg, mesh_bank=tr.mesh_bank, compute_dtype="bfloat16",
                               keep_f32_modules="encoder_img")
    assert bare.keep_f32_modules == ("encoder_img",)
    cfg["training"]["keep_f32_modules"] = ["decoder", "encoder_hand"]
    assert Trainer.from_config(model, cfg, mesh_bank=tr.mesh_bank).keep_f32_modules == (
        "decoder", "encoder_hand")
    plain = Trainer.from_config(model, cfg, mesh_bank=tr.mesh_bank)
    params = {"encoder.w": w}
    assert plain.compute_dtype is None and plain._cast_params(params) is params
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer.from_config(model, cfg, mesh_bank=tr.mesh_bank, compute_dtype="int8")


# ---------------------------------------------------------------------------
# rematerialization

@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", ["vtaco", "vtacoh", "tactile"])
def test_remat_step_equals_plain(synth, name, compute_dtype):
    """training.remat recomputes every encoder and decoder call in the
    backward pass: two steps give the same loss scalars and gradients as
    plain steps (within 1e-6), and the BatchNorm buffers (ResNet-18, the
    t2d stack's and TactileUNet's, num_batches_tracked among them) are
    equal: the recomputation does not move them a second time."""
    cfg = small(name, synth, compute_dtype=compute_dtype)
    batch = next(iter(BatchLoader(get_dataset("train", cfg), 2, num_workers=1,
                                       seed=0)))
    torch.manual_seed(0)
    base = get_model(cfg, device="cpu").state_dict()
    out = {}
    for remat in (False, True):
        model = get_model(cfg, device="cpu")
        model.load_state_dict(base)
        tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                                 remat=remat, **trainer_kw(name))
        assert tr.remat is remat
        sc = [tr.train_step(batch) for _ in range(2)]
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        out[remat] = sc, grads, model.state_dict()
    (sc0, g0, sd0), (sc1, g1, sd1) = out[False], out[True]
    for a, b in zip(sc0, sc1):
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-6, abs=1e-7), k
    assert g0.keys() == g1.keys() and g0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)
    buffers = [k for k in sd0 if "running" in k or "num_batches" in k]
    assert buffers
    for k in buffers:
        assert torch.equal(sd0[k], sd1[k]), k


@pytest.mark.parametrize("remat", [True, "finest"])
def test_unet3d_remat_modes(remat):
    """unet3d_kwargs.remat: True recomputes every level, 'finest' the first
    encoder and the last decoder level; both give the plain network's
    output and gradients, under the same parameter names. Another value
    raises, and so does the residual basic module (ROADMAP item 11)."""
    kw = dict(num_levels=3, f_maps=8, in_channels=8, out_channels=8)
    torch.manual_seed(0)
    plain = build_unet3d(kw)
    other = build_unet3d(dict(kw, remat=remat))
    other.load_state_dict(plain.state_dict())
    assert list(dict(plain.named_parameters())) == list(dict(other.named_parameters()))
    levels = [lv.remat for lv in list(other.encoders) + list(other.decoders)]
    assert levels == ([True] * 5 if remat is True else [True, False, False, False, True])
    x = torch.randn(2, 8, 8, 8, 8, generator=torch.Generator().manual_seed(1))
    outs = []
    for net in (plain, other):
        xi = x.clone().requires_grad_()
        y = net(xi)
        (y * y).sum().backward()
        outs.append((y.detach(), xi.grad, [p.grad for p in net.parameters()]))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-7)
    for a, b in zip(outs[1][2], outs[0][2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        build_unet3d(dict(kw, remat="all"))
