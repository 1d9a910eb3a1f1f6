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


_JAX_GRADS = {}


def jax_step(jtr, state, a):
    """JAX's Trainer._train_step without the update: (scalars, gradients
    as a state_dict, the decode sample's key). One compiled function per
    trainer."""
    _, step_rng = jax.random.split(state.rng)
    if id(jtr) not in _JAX_GRADS:
        def loss_fn(params, batch_stats, rng, a_c):
            with jax.default_matmul_precision(jtr.matmul_precision):
                loss, aux = jtr._compute_loss(jtr._cast_params(params), batch_stats, rng, a_c)
                return loss.astype(jnp.float32), aux

        _JAX_GRADS[id(jtr)] = jtr, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (scalars, _)), grads = _JAX_GRADS[id(jtr)][1](
        state.params, state.batch_stats, step_rng, jtr._cast_batch(a))
    return ({k: float(v) for k, v in scalars.items()}, TI.export_state_dict(grads, {}),
            jax.random.split(step_rng)[1])


def step_draws(name, jtr, params, stats, a, key):
    """The decode sample's draws of one JAX step: the t2d contact sample's,
    or the fingertip sample's from the fingertips of the step's own
    precision (the hand encoder's parameters cast as the step casts them)."""
    if name == "vtaco":
        H, W = a["imgs"].shape[2:4]
        return jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                         np.asarray(jtr._depth_origin_for(H * W)), a["points"].shape[1],
                         jtr.num_sample, PER_FINGER, key)
    if name == "vtacoh":
        m = jtr.model
        v = {"params": jtr._cast_params(params), "batch_stats": stats}
        c_hand = m.apply(v, jtr._cast_batch(a)["inputs"], train=False,
                         method=m.encode_hand_inputs)
        tips = np.asarray(JC.tips_in_object_frame(c_hand["mano_joints"], a["mano"][:, :3],
                                                  a["wrist"], a["pc_ply"]))
        return jax_tip_draws(np.asarray(a["points"]), tips, np.asarray(a["touch_success"]),
                             jtr.num_sample, jtr.tips_per_finger, key)
    return None


def module_cosines(grads, ref):
    """Each top-level module's gradient cosine, over the modules the loss
    reaches."""
    out = {}
    for mod in {k.split(".")[0] for k in ref}:
        keys = [k for k in ref if k.split(".")[0] == mod]
        a = np.concatenate([np.ravel(grads[k]) for k in keys]).astype(np.float64)
        b = np.concatenate([np.ravel(ref[k]) for k in keys]).astype(np.float64)
        if np.linalg.norm(b) > 0:
            out[mod] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


def rms(values):
    return float(np.sqrt(np.mean(np.square(values))))


@pytest.mark.parametrize("name", ["vtaco", "vtacoh", "tactile"])
def test_bf16_step_matches_jax(synth, name):
    """One bfloat16 step (keep_f32_modules: the decoder) of each path
    against the JAX package's on the same weights, batch and draws, for
    three random weight sets. On the loader's [0, 1/255] images train-mode
    BatchNorm's one-pass variance is mostly bfloat16 rounding in both
    packages (the modules' outputs differ from float32 by up to 40 % on
    random weights), so each scalar's gap is noise: the bar is on the root
    mean square of the relative gaps, the port's float32-to-bfloat16 gap
    at most twice the JAX package's, and the port's bfloat16 step within
    twice JAX's gap of JAX's bfloat16 step. Each module's gradient cosine
    between the bfloat16 and float32 steps is at least 1 - 2 (1 - JAX's
    cosine). The float32 steps agree as in test_torch_train.py."""
    cfg = small(name, synth)
    jmodel, _ = jax_get_model(cfg)
    jbank = jax_build_mesh_bank(cfg) if name == "vtaco" else None
    jtrs = {dt: JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, compute_dtype=dt,
                                       **trainer_kw(name)) for dt in (None, "bfloat16")}
    np.random.seed(0)   # the items' subsampling and noise draw from it
    batch = dict(next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                          num_workers=1, seed=0))))
    shapes = jtrs[None].init_state_abstract(batch)
    gap_jax, gap_port, to_jax = [], [], []
    for seed in (21, 22, 23):
        rng = np.random.default_rng(seed)
        params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
        state = jtrs[None]._state_from_variables({"params": params, "batch_stats": stats})
        run = {}
        for dt, jtr in jtrs.items():
            a = jtr.prepare_batch(batch)
            want, jgrads, key = jax_step(jtr, state, a)
            tr = port_trainer(cfg, params, stats, name, compute_dtype=dt)
            got = tr.train_step(batch, step_draws(name, jtr, params, stats, a, key))
            grads = {n: (np.zeros(p.shape) if p.grad is None else p.grad.numpy())
                     for n, p in tr.model.named_parameters()}
            assert set(got) == set(want)
            assert all(p.dtype == torch.float32 for p in tr.model.parameters())
            run[dt] = want, got, jgrads, grads
        (j32, p32, jg32, pg32), (j16, p16, jg16, pg16) = run[None], run["bfloat16"]
        for k in j32:
            assert p32[k] == pytest.approx(j32[k], rel=5e-4, abs=5e-5), (k, p32[k], j32[k])
            gap_jax.append((j16[k] - j32[k]) / abs(j32[k]))
            gap_port.append((p16[k] - p32[k]) / abs(p32[k]))
            to_jax.append((p16[k] - j16[k]) / abs(j16[k]))
        cos_jax, cos_port = module_cosines(jg16, jg32), module_cosines(pg16, pg32)
        assert set(cos_port) == set(cos_jax) and cos_jax
        for mod, c in cos_jax.items():
            assert cos_port[mod] >= 1 - 2 * (1 - c), (seed, mod, cos_port, cos_jax)
    bar = 2 * rms(gap_jax)
    assert rms(gap_port) <= bar and rms(to_jax) <= bar, (rms(gap_port), rms(to_jax), bar)


@pytest.mark.parametrize("name", ["vtaco", "vtacoh", "tactile"])
def test_bf16_training_keeps_f32_state(synth, name):
    """Eight bfloat16 steps on one batch (tests/test_trainer.py:188-222):
    finite, the loss falls (min of steps 5-8 below step 1), and every
    parameter, BatchNorm buffer and Adam moment stays float32."""
    cfg = small(name, synth, compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                             **trainer_kw(name))
    batch = next(iter(BatchLoader(get_dataset("train", cfg), 2, num_workers=1,
                                       seed=0)))
    losses = [tr.train_step(batch)["loss"] for _ in range(8)]
    assert all(np.isfinite(losses)) and min(losses[4:]) < losses[0], losses
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
    moments = [v for st in tr.optimizer.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(v.dtype == torch.float32 for v in moments)


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
    with pytest.raises(NotImplementedError, match="item 11"):
        build_unet3d(dict(kw, basic_module="ext_resnet"))


# ---------------------------------------------------------------------------
# K steps per call, and validation, on a device-resident split

def jax_fused_draws(jtr, jd, state, rng, ids, name):
    """The draws of JAX's make_fused_train_fn(state, rng, ids): step j's
    sample from split(rng, K)[j], its decode sample from the state's key
    chain (split(state.rng) per step)."""
    out = []
    state_rng = state.rng
    for j, key in enumerate(jax.random.split(rng, ids.shape[0])):
        sample = jax_sample_draws(key, jd, ids.shape[1])
        state_rng, step_rng = jax.random.split(state_rng)
        step = None
        if name == "vtaco":
            b = jd._sample(key, jnp.asarray(ids[j]), N_POINTS, N_CLOUD)
            H, W = b["inputs.img"].shape[2:4]
            step = jax_draws(np.asarray(b["inputs.depth"]), np.asarray(b["inputs.touch_success"]),
                             np.asarray(jtr._depth_origin_for(H * W)), N_POINTS,
                             jtr.num_sample, PER_FINGER, jax.random.split(step_rng)[1])
        out.append({"sample": sample, "step": step})
    return out


@pytest.mark.parametrize("name", ["vtaco", "tactile"])
def test_fused_steps_match_sequential_and_jax(synth, name):
    """make_fused_train_fn: K = 3 steps in one call equal 3 train_step
    calls on the same device batches and draws (loss scalars and
    parameters within 1e-6), and both equal the JAX package's
    make_fused_train_fn with the same ids and draws (loss scalars 5e-4
    relative; parameters after the three Adam steps within JAX's own bar
    between its fused and single steps, 5e-3 relative and 5e-4: Adam
    moves a parameter whose gradient is rounding noise, such as the
    tactile U-Net's first bias ahead of a BatchNorm, by about lr per
    step whatever the noise)."""
    cfg = small(name, synth)
    jmodel, _ = jax_get_model(cfg)
    jbank = jax_build_mesh_bank(cfg) if name == "vtaco" else None
    jtr = JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, **trainer_kw(name))
    jd = JaxDeviceDataset(jax_get_dataset("train", cfg))
    ids = np.array([[0, 1], [2, 3], [3, 0]], np.int32)
    rng = jax.random.PRNGKey(7)
    shapes = jtr.init_state_abstract(jd.sample_batch(rng, ids[0], N_POINTS, N_CLOUD))
    prng = np.random.default_rng(31)
    params, stats = random_tree(shapes.params, prng), random_tree(shapes.batch_stats, prng)
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    draws = jax_fused_draws(jtr, jd, state, rng, ids, name)
    j_state, j_sc = jtr.make_fused_train_fn(jd, N_POINTS, N_CLOUD)(state, rng,
                                                                   jnp.asarray(ids))

    d = DeviceDataset(get_dataset("train", cfg), device="cpu")
    fused_tr = port_trainer(cfg, params, stats, name)
    got = fused_tr.make_fused_train_fn(d, N_POINTS, N_CLOUD)(ids, draws=draws)
    assert set(got) == set(j_sc) and all(v.shape == (3,) for v in got.values())
    seq_tr = port_trainer(cfg, params, stats, name)
    seq = [seq_tr.train_step(d.sample_batch(ids[j], N_POINTS, N_CLOUD,
                                            draws=draws[j]["sample"]), draws[j]["step"])
           for j in range(3)]
    assert fused_tr.step == seq_tr.step == 3
    for k in got:
        np.testing.assert_allclose(got[k], [s[k] for s in seq], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[k], np.asarray(j_sc[k]), rtol=5e-4, atol=5e-5)
    want = TI.export_state_dict(j_state.params, {})
    seq_params = dict(seq_tr.model.named_parameters())
    for n, p in fused_tr.model.named_parameters():
        torch.testing.assert_close(p, seq_params[n], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=5e-3, atol=5e-4,
                                   err_msg=n)


def test_fused_steps_match_sequential_own_draws(synth):
    """VTacOH (whose fingertip draws follow the model's own fingertips,
    step by step): K fused steps from a generator equal K train_step calls
    on the batches that generator gives, the trainers' generators seeded
    alike."""
    cfg = small("vtacoh", synth)
    d = DeviceDataset(get_dataset("train", cfg), device="cpu")
    torch.manual_seed(0)
    base = get_model(cfg, device="cpu").state_dict()
    ids = np.array([[0, 1], [2, 3], [1, 2]])
    trs = []
    for _ in range(2):
        model = get_model(cfg, device="cpu")
        model.load_state_dict(base)
        trs.append(Trainer.from_config(model, cfg, seed=4))
    got = trs[0].make_fused_train_fn(d, N_POINTS, N_CLOUD)(
        ids, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    seq = [trs[1].train_step(d.sample_batch(r, N_POINTS, N_CLOUD, g)) for r in ids]
    for k in got:
        np.testing.assert_allclose(got[k], [s[k] for s in seq], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["vtaco", "vtacoh", "tactile"])
def test_fused_eval_matches_eval_step(synth, name):
    """make_fused_eval_fn and evaluate_device on the val split: the same
    metrics on every call (each model's draws come from its id alone), each
    model's equal to eval_step on the same device batch with the same
    generator, and their mean what evaluate_device returns."""
    cfg = small(name, synth)
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                             **trainer_kw(name))
    d = DeviceDataset(get_dataset("val", cfg, return_idx=True), device="cpu")
    assert d.n_models == 2
    fn = tr.make_fused_eval_fn(d, N_POINTS, N_CLOUD)
    out = fn(np.arange(2)[:, None])
    again = fn(np.arange(2)[:, None])
    keys = {"loss", "iou", "iou_fixed"} if name != "tactile" else {"loss", "loss_depth"}
    assert keys <= set(out)
    for k in out:
        np.testing.assert_array_equal(out[k], again[k])
    per_model = []
    for i in range(2):
        g = tr._eval_generator(i)
        batch = d.sample_batch([i], N_POINTS, N_CLOUD, g)
        batch["points_iou"], batch["points_iou.occ"] = d.data["points"][[i]], d.data["occ"][[i]]
        per_model.append(tr.eval_step(batch, generator=g))
    for k in out:
        np.testing.assert_allclose(out[k], [m[k] for m in per_model], rtol=1e-6, atol=1e-7)
    mean = tr.evaluate_device(fn, d.n_models)
    assert set(mean) == set(out)
    for k, v in mean.items():
        assert v == pytest.approx(float(np.mean([m[k] for m in per_model])), rel=1e-6,
                                  abs=1e-7, nan_ok=True), k


def test_fast_config_reaches_trainer(synth):
    """tests/test_trainer.py's test_fast_config_reaches_trainer: the three
    *_fast configs' options reach the port's Trainer."""
    cfg = _small_cfg(FAST["vtaco"], *synth)
    assert cfg["data"]["on_device"] is True and cfg["training"]["steps_per_dispatch"] == 8
    bank = build_mesh_bank(cfg, "cpu")
    tr = Trainer.from_config(get_model(cfg, device="cpu"), cfg, mesh_bank=bank)
    assert tr.compute_dtype == "bfloat16" and tr.skip_unused_t2d is True
    assert tr.keep_f32_modules == ("decoder",) and tr.remat is False
    cfgh = _small_cfg(FAST["vtacoh"], *synth)
    assert cfgh["data"]["on_device"] is True and cfgh["training"]["steps_per_dispatch"] == 8
    trh = Trainer.from_config(get_model(cfgh, device="cpu"), cfgh)
    assert trh.compute_dtype == "bfloat16" and trh.keep_f32_modules == ("decoder",)
    cfgt = _small_cfg(FAST["tactile"], *synth)
    assert cfgt["data"]["on_device"] is True
    trt = Trainer.from_config(get_model(cfgt, device="cpu"), cfgt)
    assert trt.train_tactile and trt.compute_dtype == "bfloat16"


# ---------------------------------------------------------------------------
# the loop and the CLI

def _loss_its(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["it"] for r in recs if r["tag"] == "train/loss"], recs


def test_fused_loop_end_to_end(synth, tmp_path, monkeypatch):
    """tests/test_device_data.py's test_fused_loop_end_to_end: train() with
    the split on the device and 4 steps per block, validation every 4,
    a checkpoint every 5, 7 steps: blocks of 4, 1, 1 and 1 steps, so that
    every cadence fires at its iteration; fused validation at 4 picks a
    best model; each iteration is logged once."""
    cfg = small("vtaco", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=4,
                           validate_every=4, visualize_every=0, checkpoint_every=5,
                           backup_every=0, print_every=2)
    blocks = []
    make = Trainer.make_fused_train_fn

    def spy(self, *a, **kw):
        fn = make(self, *a, **kw)

        def run(ids, *r, **k):
            blocks.append(len(ids))
            return fn(ids, *r, **k)
        return run

    monkeypatch.setattr(Trainer, "make_fused_train_fn", spy)
    trainer, it = loop.train(cfg, max_iters=7, device="cpu")
    assert it == 7 and trainer.step == 7 and blocks == [4, 1, 1, 1]
    for f in ("model.ckpt", "model_best.ckpt"):
        assert os.path.exists(tmp_path / f)
    its, recs = _loss_its(str(tmp_path))
    assert its == list(range(1, 8))
    assert [r["it"] for r in recs if r["tag"] == "val/iou"] == [4]
    assert CheckpointIO(str(tmp_path)).load_raw("model_best.ckpt")[1]["it"] == 4


def test_on_device_loop_one_step_per_call(synth, tmp_path, monkeypatch):
    """data.on_device with one step per call (steps_per_dispatch 1): the
    loop takes the resident split's batches one by one through
    train_step, as the JAX loop does, and still validates through
    evaluate_device."""
    cfg = small("vtacoh", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=1,
                           validate_every=2, checkpoint_every=0, backup_every=0,
                           visualize_every=0, print_every=1)
    calls = []
    monkeypatch.setattr(Trainer, "make_fused_train_fn", lambda *a, **k: calls.append(a))
    evaluate_device = Trainer.evaluate_device
    monkeypatch.setattr(Trainer, "evaluate_device",
                        lambda self, *a: calls.append("eval") or evaluate_device(self, *a))
    trainer, it = loop.train(cfg, max_iters=3, device="cpu")
    assert it == 3 and trainer.step == 3 and calls == ["eval"]
    its, recs = _loss_its(str(tmp_path))
    assert its == [1, 2, 3] and [r["it"] for r in recs if r["tag"] == "val/iou"] == [2]


def test_fused_dispatch_resumes(synth, tmp_path, capsys):
    """tests/test_resume.py's test_fused_dispatch_resumes: a fused run
    stopped at 4 resumes at the saved iteration and logs 1..8 once."""
    cfg = small("vtaco", synth)
    cfg["data"]["on_device"] = True
    cfg["training"].update(out_dir=str(tmp_path), batch_size=2, steps_per_dispatch=2,
                           validate_every=4, checkpoint_every=4, backup_every=0,
                           visualize_every=0, print_every=1)
    _, it1 = loop.train(cfg, max_iters=4, device="cpu")
    assert it1 == 4 and CheckpointIO(str(tmp_path)).load_raw("model.ckpt")[1]["it"] == 4
    capsys.readouterr()
    trainer, it2 = loop.train(cfg, max_iters=8, device="cpu")
    assert "resumed at it=4" in capsys.readouterr().out
    assert it2 == 8 and trainer.step == 8
    assert sorted(_loss_its(str(tmp_path))[0]) == list(range(1, 9))


@pytest.mark.parametrize("name", ["vtaco", "vtacoh", "tactile"])
def test_fast_config_trains_through_cli(synth, tmp_path, capsys, name):
    """python -m vtaco_tpu_torch.cli.train on each *_fast config (at small
    widths, --cpu): 2K + 3 = 19 steps at its 8 steps per block, so that
    blocks of 8 and of 1 run, fused validation, a checkpoint, the resident
    split's size printed, and every parameter float32 in the
    checkpoint."""
    from vtaco_tpu_torch.cli.train import main

    cfg = _small_cfg(FAST[name], *synth)
    out = tmp_path / "out"
    cfg["training"].update(out_dir=str(out), batch_size=2, validate_every=19,
                           checkpoint_every=19, backup_every=0, visualize_every=0,
                           print_every=1, n_workers=1, n_workers_val=1)
    if name == "vtaco":   # no pretrained stack here: the graft warns and goes on
        cfg["model"]["encoder_t2d_kwargs"]["model_file"] = str(tmp_path / "none.ckpt")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main([str(path), "--max-iters", "19", "--cpu"])
    text = capsys.readouterr().out
    assert "device-resident dataset: 4 models" in text and "Validation metric" in text
    its, recs = _loss_its(str(out))
    assert its == list(range(1, 20))
    # iou_fixed is NaN (0/0) when neither labels nor logits reach the
    # threshold, in both packages (ROADMAP.md §3)
    assert all(np.isfinite(r["value"]) for r in recs if r["tag"] != "val/iou_fixed")
    payload, scalars = CheckpointIO(str(out)).load_raw("model.ckpt")
    assert scalars["it"] == 19
    assert all(v.dtype == torch.float32 for v in payload["model"].values()
               if v.is_floating_point())
