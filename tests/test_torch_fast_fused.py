"""K steps per call and whole-split validation on a device-resident split
in the PyTorch port, against sequential steps and the JAX package's
make_fused_train_fn, on the CPU at small widths (tests/test_torch_fast.py
states the tolerances), and the ``*_fast`` configs' options reaching the
Trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.data.device_data import DeviceDataset
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_setup import random_tree
from test_torch_train import PER_FINGER, jax_draws
from test_trainer import _small_cfg
from test_torch_fast import (  # noqa: F401
    share_cores, CONFIGS, FAST, N_CLOUD, N_POINTS, T, jax_sample_draws, port_trainer, small,
    synth, trainer_kw)


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
