"""One VTacO_YCB train step and one eval step of the PyTorch port
(vtaco_tpu_torch) against the JAX package on the same weights, batch and
random draws, skip_unused_t2d, and the TF32 flags that
training.matmul_precision sets; the fixtures, helpers and tolerances are
tests/test_torch_train.py's (train step: loss scalars 5e-4 relative,
per-module gradient cosine >= 0.999 with norms within 2 %, BatchNorm
statistics by assert_batch_stat; eval step: IoU 1e-6).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.train.trainer import Trainer as JaxTrainer

from test_torch_train import (  # noqa: F401
    PER_FINGER, assert_batch_stat, batch_stats_f64, jax_draws, jax_step, module_grads,
    port_trainer, setup, synth)


@pytest.mark.parametrize("pretrained", [True, False])
def test_train_step_matches_jax(setup, pretrained):
    """One VTacO_YCB t2d_img step. Shipped (pretrained t2d, ground-truth
    depths): the t2d forward runs without a graph, only its BatchNorm
    statistics move, and its parameters get no gradient (optax's update
    of a zero gradient is zero). With a t2d in training, loss_depth and
    loss_digit join the loss and the t2d gets gradients."""
    cfg, jtr, batch, params, stats = setup
    cfg = copy.deepcopy(cfg)
    cfg["model"]["encoder_t2d_kwargs"]["pretrained"] = pretrained
    jtr = JaxTrainer.from_config(jtr.model, cfg, mesh_bank=jtr.mesh_bank,
                                 contact_per_finger=PER_FINGER)
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    want, jgrads, new_state, key, a = jax_step(jtr, state, batch)
    H, W = a["imgs"].shape[2:4]
    draws = jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                      np.asarray(jtr._depth_origin_for(H * W)), a["points"].shape[1],
                      jtr.num_sample, PER_FINGER, key)

    tr = port_trainer(cfg, params, stats)
    got = tr.train_step(batch, draws=draws)
    assert set(got) == set(want)
    if not pretrained:
        assert {"loss_depth", "loss_digit"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=5e-4, abs=5e-5), (k, got[k], want[k])

    jg = TI.export_state_dict(jgrads, {})
    report = {}
    for mod, grads in module_grads(tr.model).items():
        # a parameter the loss does not reach (the shipped path's t2d, the
        # decoder's fc_p beside fc_p_img) has no gradient here and a zero
        # one in the JAX package
        unused = [k for k, g in grads.items() if g is None]
        assert all(np.abs(jg[k]).max() == 0 for k in unused), mod
        if mod == "encoder_t2d" and pretrained:
            assert len(unused) == len(grads)
            continue
        ours = np.concatenate([np.zeros(jg[k].size) if g is None else g.numpy().ravel()
                               for k, g in grads.items()]).astype(np.float64)
        ref = np.concatenate([jg[k].ravel() for k in grads]).astype(np.float64)
        no, nr = np.linalg.norm(ours), np.linalg.norm(ref)
        report[mod] = cos = float(ours @ ref / (no * nr))
        assert cos >= 0.999 and 0.98 < no / nr < 1.02, (mod, cos, no, nr, report)
    assert set(report) >= {"encoder", "encoder_hand", "encoder_img", "decoder"}

    # BatchNorm statistics after the step (the t2d's and ResNet-18's)
    sd_want = TI.export_state_dict({}, new_state.batch_stats)
    own = tr.model.state_dict()
    assert len(sd_want) > 40
    f64 = batch_stats_f64(cfg, params, stats, batch)
    for k, v in sd_want.items():
        assert_batch_stat(k, own[k].numpy(), v, f64[k])


def test_skip_unused_t2d(setup):
    """skip_unused_t2d drops the shipped path's t2d forward: the loss
    scalars stay, the t2d's statistics do not move."""
    cfg, jtr, batch, params, stats = setup
    a = jtr.prepare_batch(batch)
    H, W = a["imgs"].shape[2:4]
    draws = jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                      np.asarray(jtr._depth_origin_for(H * W)), a["points"].shape[1],
                      jtr.num_sample, PER_FINGER, jax.random.PRNGKey(11))
    ref, skip = port_trainer(cfg, params, stats), port_trainer(
        cfg, params, stats, skip_unused_t2d=True)
    before = copy.deepcopy(skip.model.encoder_t2d.state_dict())
    sc_ref, sc_skip = ref.train_step(batch, draws), skip.train_step(batch, draws)
    for k in sc_ref:
        assert sc_skip[k] == pytest.approx(sc_ref[k], rel=1e-6, abs=1e-7)
    for k, v in skip.model.encoder_t2d.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("precision,tf32", [("default", True), ("high", True),
                                             ("highest", False)])
def test_matmul_precision_sets_tf32_flags(setup, precision, tf32):
    """training.matmul_precision decides the card's TF32 flags for the
    train and eval steps, as JAX maps the name on a GPU, and the process's
    own flags come back after each step; an unknown name raises."""
    cfg, _, batch, params, stats = setup
    cfg = copy.deepcopy(cfg)
    cfg["training"]["matmul_precision"] = precision
    tr = port_trainer(cfg, params, stats)
    seen = []
    tr.model.encoder.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not tf32
        tr.train_step(batch)
        tr.eval_step(batch)
        assert seen and set(seen) == {(tf32, tf32)}
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (not tf32, not tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    cfg["training"]["matmul_precision"] = "bf16"
    with pytest.raises(ValueError, match="matmul_precision"):
        port_trainer(cfg, params, stats)


def test_eval_step_matches_jax(setup):
    """Eval mode (running statistics), the contact samples of the JAX eval
    keys (the loss's from split(fold_in(rng, 12345))[1], the IoU's from
    fold_in(rng, 12345)): the loss scalars, the quirk ``iou`` (mean
    threshold) and the value-space ``iou_fixed``."""
    cfg, jtr, batch, params, stats = setup
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    vb = next(iter(JaxBatchLoader(jax_get_dataset("val", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    want = jtr.eval_step(state, vb)
    a = jtr.prepare_batch(vb)
    H, W = a["imgs"].shape[2:4]
    key = jax.random.fold_in(state.rng, 12345)
    draws = [jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                       np.asarray(jtr._depth_origin_for(H * W)), a["points"].shape[1],
                       jtr.num_sample, PER_FINGER, k)
             for k in (jax.random.split(key)[1], key)]
    got = port_trainer(cfg, params, stats).eval_step(vb, *draws)
    assert set(got) == set(want)
    for k in ("iou", "iou_fixed"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for k in ("loss", "loss_l1", "loss_mano", "loss_pc"):
        assert got[k] == pytest.approx(want[k], rel=5e-4, abs=5e-5), k
