"""A bfloat16 train step of the PyTorch port (vtaco_tpu_torch) at trained
weights, against the JAX package's, on the CPU at small widths: for each
loss path (VTacO_YCB, VTacOH_YCB, tactile_test) and three random weight
sets, the JAX package's float32 trainer takes 19 steps (the fused loop's
2K + 3 at K = 8) on the loader's batches, and from the weights it reaches
both packages take one bfloat16 step (keep_f32_modules: the decoder) and
one float32 step on the same batch and draws.

The reference is the JAX step compiled with XLA's
``xla_allow_excess_precision`` off. With it on (XLA's default, the JAX
package's own setting) XLA keeps a fusion's intermediate bfloat16 values
in float32, so that JAX's bfloat16 step rounds less often than its
program says, and less often than PyTorch, which rounds every operation's
output: at these weights its tactile depth-loss gap to float32 is
2.35e-4, 1.15e-4 and 8.56e-4 with excess precision, 1.78e-3, 3.38e-4 and
2.45e-3 without, and the port's 1.44e-3, 1.03e-4 and 2.42e-3 (the
readings of `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_fast_trained.py`, which prints both references, at the
random weights too: chip_smoke.py's bars, tests/fast_bars.py, come from
them).

With ``--full-width`` the same script trains at the configs' shipped
widths on a 320x240 synthetic set (F5: JAX's own gap at trained full-width
weights; ``--configs``, ``--seeds``), and ``--export DIR`` writes the trained
weights, config and batch that tests/f5_card.py runs on the card.

Bars: the port's float32-to-bfloat16 gap at most twice the reference's,
on the root mean square of the loss scalars' relative gaps over the
three sets, and for each module on its gradient's distance, pooled over
the sets (tests/test_torch_fast_modules.py leaves out the same zero
gradients); the float32 steps agree as in tests/test_torch_train.py."""

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer

from bf16_checks import exact_zero
from test_torch_fast import CONFIGS, port_trainer, share_cores, small, trainer_kw  # noqa: F401
from test_torch_fast_bf16 import rms, step_draws
from test_torch_fast_modules import make_synth
from test_torch_setup import random_tree

SEEDS = (21, 22, 23)
TRAIN_STEPS = 19
FAITHFUL = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synth(str(tmp_path_factory.mktemp("synth_fast_trained")))


def jax_grad_fn(jtr, options):
    """JAX's Trainer._train_step without the update, compiled with XLA
    ``options``: (state, prepared batch) → (scalars, gradients, the
    decode sample's key)."""
    def loss_fn(params, batch_stats, rng, a_c):
        with jax.default_matmul_precision(jtr.matmul_precision):
            loss, aux = jtr._compute_loss(jtr._cast_params(params), batch_stats, rng, a_c)
            return loss.astype(jnp.float32), aux

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), compiler_options=options)

    def run(state, a):
        _, step_rng = jax.random.split(state.rng)
        (_, (scalars, _)), grads = fn(state.params, state.batch_stats, step_rng,
                                      jtr._cast_batch(a))
        return ({k: float(v) for k, v in scalars.items()}, TI.export_state_dict(grads, {}),
                jax.random.split(step_rng)[1])
    return run


def full_width(name, synth):
    """Config ``name`` at its shipped widths and data sizes on the synthetic
    set ``synth`` (its paths only replaced), at 'highest'."""
    from vtaco_tpu.core.config import load_config

    root, mesh_root = synth
    cfg = load_config(CONFIGS[name], "configs/default.yaml")
    cfg["data"].update(path=root, mesh_dir=os.path.join(mesh_root, "mesh_obj"),
                       depth_origin=os.path.join(mesh_root, "depth_origin.txt"))
    cfg["training"].update(matmul_precision="highest")
    return cfg


def export_trained(out_dir, name, cfg, seed, params, stats, batch):
    """The trained weights (the port's state_dict names), the config and
    the step's batch, for tests/f5_card.py on a machine without JAX."""
    from vtaco_tpu_torch.core.weights import export_state_dict

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    np.savez(os.path.join(out_dir, f"{name}_batch.npz"),
             **{k: v for k, v in batch.items() if isinstance(v, np.ndarray)
                and v.dtype.kind in "fiub"})
    np.savez(os.path.join(out_dir, f"{name}_seed{seed}.npz"),
             **export_state_dict(params, stats))


def trained_gaps(name, synth, references=(("faithful", FAITHFUL),), train_steps=TRAIN_STEPS,
                 make_cfg=small, export=None, seeds=SEEDS):
    """After ``train_steps`` float32 JAX steps from each weight set, for
    each reference (XLA options) and the port: the relative gaps of
    the loss scalars between the bfloat16 and float32 steps, and each
    module's squared gradient distance and squared float32 norm, by
    weight set (the tensors that the reference's float32 step moves, less
    exact_zero's); and the float32 steps' largest relative
    disagreement. ``make_cfg``: small (the tests' widths) or full_width;
    ``export``: a directory for export_trained; ``seeds``: the weight
    sets."""
    cfg = make_cfg(name, synth)
    jmodel, _ = jax_get_model(cfg)
    jbank = jax_build_mesh_bank(cfg) if name == "vtaco" else None
    jtrs = {dt: JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, compute_dtype=dt,
                                       **trainer_kw(name)) for dt in (None, "bfloat16")}
    np.random.seed(0)   # the items' subsampling and noise draw from it
    loader = JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2, num_workers=1, seed=0)
    batches = [dict(b) for b, _ in zip(loader, range(2))]
    shapes = jtrs[None].init_state_abstract(batches[0])
    fns = {(ref, dt): jax_grad_fn(jtr, opts) for ref, opts in references
           for dt, jtr in jtrs.items()}
    out = {ref: {"loss": [], "grad": {}} for ref, _ in references + (("port", None),)}
    f32_err = 0.0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
        state = jtrs[None]._state_from_variables({"params": params, "batch_stats": stats})
        for i in range(train_steps):
            state, _ = jtrs[None].train_step(state, batches[i % 2])
        params = jax.tree.map(np.asarray, state.params)
        stats = jax.tree.map(np.asarray, state.batch_stats)
        batch = batches[0]
        if export:
            export_trained(export, name, cfg, seed, params, stats, batch)
        runs = {}
        for ref, _ in references:
            for dt, jtr in jtrs.items():
                runs[ref, dt] = fns[ref, dt](state, jtr.prepare_batch(batch))
        for dt, jtr in jtrs.items():
            a = jtr.prepare_batch(batch)
            key = runs[references[0][0], dt][2]
            tr = port_trainer(cfg, params, stats, name, compute_dtype=dt)
            got = tr.train_step(batch, step_draws(name, jtr, params, stats, a, key))
            runs["port", dt] = got, {n: p.grad.numpy() for n, p in tr.model.named_parameters()
                                     if p.grad is not None}, key
        ref32 = runs[references[0][0], None]
        for k, v in ref32[0].items():
            f32_err = max(f32_err, abs(runs["port", None][0][k] - v) / abs(v))
        live = sorted(k for k in set(ref32[1]) - exact_zero(ref32[1]) if np.any(ref32[1][k]))
        for ref in out:
            (s16, g16, _), (s32, g32, _) = runs[ref, "bfloat16"], runs[ref, None]
            out[ref]["loss"] += [(s16[k] - s32[k]) / abs(s32[k]) for k in s32]
            for mod in sorted({k.split(".")[0] for k in live}):
                keys = [k for k in live if k.split(".")[0] == mod]
                d = out[ref]["grad"].setdefault(mod, [0.0, 0.0])
                num = den = 0.0
                for k in keys:
                    a, b = (np.asarray(g.get(k, 0.0), np.float64) for g in (g16, g32))
                    num += float(np.sum(np.square(a - b)))
                    den += float(np.sum(np.square(b)))
                d[0] += num
                d[1] += den
                out[ref].setdefault("grad_each", {}).setdefault(mod, []).append(
                    float(np.sqrt(num / den)))
    summary = {ref: {"loss_rms": rms(v["loss"]), "loss_max": float(np.max(np.abs(v["loss"]))),
                     "loss_each": v["loss"], "grad_each": v["grad_each"],
                     "grad_rel": {m: float(np.sqrt(a / b)) for m, (a, b) in v["grad"].items()}}
               for ref, v in out.items()}
    return summary, f32_err


def check_trained_step(synth, name):
    """At trained weights the port's bfloat16-to-float32 gap is at most
    twice the faithfully rounded JAX step's: the loss scalars' root mean
    square and each module's pooled gradient distance."""
    s, f32_err = trained_gaps(name, synth)
    assert f32_err <= 5e-4, f32_err
    port, ref = s["port"], s["faithful"]
    assert port["loss_rms"] <= 2 * ref["loss_rms"], s
    assert set(port["grad_rel"]) == set(ref["grad_rel"]) and port["grad_rel"], s
    for mod, v in port["grad_rel"].items():
        assert v <= 2 * ref["grad_rel"][mod], (mod, s)


@pytest.mark.parametrize("name", ["vtacoh", "tactile"])
def test_bf16_step_at_trained_weights(synth, name):
    check_trained_step(synth, name)


if __name__ == "__main__":
    # JAX's float32-to-bfloat16 gaps (and the port's on the CPU) behind
    # tests/bf16_checks.py: at the tests' small widths on 16x12 images by
    # default; with --full-width at the configs' shipped widths and data
    # sizes on a synthetic set of 6 models with 320x240 images (the card's
    # pipeline set's image size), after TRAIN_STEPS float32 steps only.
    import tempfile

    from vtaco_tpu.data.synthetic import generate as jax_generate

    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--configs", default="vtaco,vtacoh,tactile")
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--export", default=None,
                    help="write each config's trained weights, config and batch here "
                         "(tests/f5_card.py reads them)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.full_width:
        root = jax_generate(tempfile.mkdtemp(), n_models=6, n_query=100_000,
                            n_surface=20_000, img_h=320, img_w=240, seed=7,
                            splits=(("train", 0.67), ("val", 0.33)))
    else:
        root = make_synth(tempfile.mkdtemp())
    for steps in (TRAIN_STEPS,) if args.full_width else (0, TRAIN_STEPS):
        for n in args.configs.split(","):
            t0 = time.perf_counter()
            s, err = trained_gaps(n, root, (("faithful", FAITHFUL), ("xla_default", {})), steps,
                                  full_width if args.full_width else small,
                                  args.export if steps else None,
                                  tuple(int(x) for x in args.seeds.split(",")))
            print(json.dumps({"config": n, "train_steps": steps, "full_width": args.full_width,
                              "seconds": time.perf_counter() - t0, "float32_rel_err": err,
                              **s}), flush=True)
