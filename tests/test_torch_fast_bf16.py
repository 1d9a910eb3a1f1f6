"""The bfloat16 step of the ``*_fast`` configs in the PyTorch port against
the JAX package, on the CPU at small widths (tests/test_torch_fast.py
states the tolerances): VTacO_YCB_fast here, VTacOH_YCB_fast and
tactile_test_fast in tests/test_torch_fast_bf16_vtacoh.py and
tests/test_torch_fast_bf16_tactile.py, which run the same checks
(``check_bf16_step``, ``check_f32_state``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.train import contact as JC
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_setup import random_tree
from test_torch_tips import jax_tip_draws
from test_torch_train import PER_FINGER, jax_draws
from test_torch_fast import (  # noqa: F401
    share_cores, CONFIGS, FAST, N_CLOUD, N_POINTS, T, jax_sample_draws, port_trainer, small,
    synth, trainer_kw)


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


def check_bf16_step(synth, name):
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




def check_f32_state(synth, name):
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




@pytest.mark.parametrize("name", ["vtaco"])
def test_bf16_step_matches_jax(synth, name):
    check_bf16_step(synth, name)


@pytest.mark.parametrize("name", ["vtaco"])
def test_bf16_training_keeps_f32_state(synth, name):
    check_f32_state(synth, name)
