"""Regenerate the committed JAX checkpoint that the port loads without JAX
(requires jax, flax and optax; runs on the CPU in about a minute):

    JAX_PLATFORMS=cpu python tests/golden/make_jax_ckpt.py

Writes, beside this script:
  vtaco_jax.yaml        the configuration: VTacO_YCB narrowed as
                        tests/test_golden_parity.py:golden_cfg(8) narrows
                        it (no ResNet-18, so no image features:
                        ``with_img`` false), but with the object decoder at
                        hidden = C = 32 (c_dim 32, the UNet3D's 32 output
                        channels), the widths of the port's tile-chain
                        kernels
  vtaco_jax.ckpt        the JAX package's CheckpointIO.save of the
                        TrainState after two JAX train steps (Adam) on a
                        synthetic set (vtaco_tpu.data.synthetic, seed 7,
                        32 x 24 images), with its _scalars
  vtaco_jax_logits.npz  the object decoder's logits from those weights,
                        through the JAX Generator3D at float32 transfers:
                        ``inputs`` (1, 256, 3) a seeded input cloud,
                        ``points`` (2048, 3) seeded query points and
                        ``logits_points`` their eval_points logits,
                        ``logits_lattice`` the eval_points_dense logits of
                        the 32^3 lattice (x slowest)

The port reads them in tests/test_torch_checkpoint.py and in
chip_smoke.py's jax_ckpt phase (on a machine with neither JAX nor
msgpack).
"""

import copy
import os
import sys
import tempfile

import numpy as np
import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.chdir(REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from vtaco_tpu.core.checkpoint import CheckpointIO  # noqa: E402
from vtaco_tpu.core.config import get_model  # noqa: E402
from vtaco_tpu.data import BatchLoader  # noqa: E402
from vtaco_tpu.data.core import get_dataset  # noqa: E402
from vtaco_tpu.data.synthetic import generate  # noqa: E402
from vtaco_tpu.generate.generator import Generator3D  # noqa: E402
from vtaco_tpu.train.loop import build_mesh_bank  # noqa: E402
from vtaco_tpu.train.trainer import Trainer  # noqa: E402

from test_golden_parity import golden_cfg  # noqa: E402

CONFIG = os.path.join(HERE, "vtaco_jax.yaml")
CKPT = os.path.join(HERE, "vtaco_jax.ckpt")
LOGITS = os.path.join(HERE, "vtaco_jax_logits.npz")
SYNTH = dict(n_models=4, n_query=500, n_surface=1000, img_h=32, img_w=24, seed=7)
WIDTH = 32     # the object decoder's hidden = C
N_POINTS, NX = 2048, 32


def jax_ckpt_cfg():
    """golden_cfg(8) with the object decoder at hidden = C = WIDTH, the
    synthetic set's sizes (points_subsample 256, pointcloud_n 128,
    num_sample 256) and a batch of 2."""
    cfg = golden_cfg(8)
    m = cfg["model"]
    m["with_img"] = False     # golden_cfg drops ResNet-18, the image features' source
    m["c_dim"] = WIDTH
    m["encoder_kwargs"]["unet3d_kwargs"]["out_channels"] = WIDTH
    m["decoder_kwargs"]["hidden_size"] = WIDTH
    cfg["data"].update(points_subsample=256, pointcloud_n=128, num_sample=256)
    cfg["training"].update(batch_size=2, n_workers=1, n_workers_val=1,
                           matmul_precision="highest")
    return cfg


def with_data(cfg, root, mesh_root):
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(path=root, mesh_dir=os.path.join(mesh_root, "mesh_obj"),
                       depth_origin=os.path.join(mesh_root, "depth_origin.txt"))
    return cfg


def main():
    base = jax_ckpt_cfg()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = with_data(base, *generate(os.path.join(tmp, "synth"), **SYNTH))
        model, _ = get_model(copy.deepcopy(cfg))
        trainer = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(
            cfg, get_dataset("train", cfg)))
        np.random.seed(0)
        loader = BatchLoader(get_dataset("train", cfg), batch_size=2, num_workers=1,
                             shuffle=True, seed=0)
        batches = iter(loader)
        first = next(batches)
        state = trainer.init_state(first)
        losses = []
        for batch in (first, next(batches, first)):
            state, scalars = trainer.train_step(state, batch)
            losses.append(scalars["loss"])
        CheckpointIO(HERE, state=state).save(CKPT, epoch_it=1, it=2,
                                             loss_val_best=float(losses[-1]))

        rng = np.random.default_rng(11)
        inputs = rng.uniform(-0.4, 0.4, (1, 256, 3)).astype(np.float32)
        points = rng.uniform(-0.55, 0.55, (N_POINTS, 3)).astype(np.float32)
        gen = Generator3D.from_config(model, cfg, band_transfer=False,
                                      transfer_dtype="float32")
        c = gen._apply(state, model.encode_inputs, jnp.asarray(inputs), train=False)
        np.savez_compressed(
            LOGITS, inputs=inputs, points=points,
            logits_points=np.asarray(gen.eval_points(state, points, c,
                                                     transfer_dtype=jnp.float32)),
            logits_lattice=np.asarray(gen.eval_points_dense(
                state, NX, c, transfer_dtype=jnp.float32)))
    with open(CONFIG, "w") as f:
        yaml.safe_dump(base, f)
    for path in (CONFIG, CKPT, LOGITS):
        print(f"wrote {os.path.relpath(path, REPO)}: {os.path.getsize(path):,} B")
    print(f"losses after the two steps: {[float(x) for x in losses]}")


if __name__ == "__main__":
    main()
