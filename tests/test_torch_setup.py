"""Shared builders for the parity tests of the PyTorch port
(vtaco_tpu_torch) against the JAX package, plus the port's import guard
and its config/factory surface.

The parity model is the flagship VTacO_YCB config at the widths of
``golden_cfg(8)`` (tests/test_golden_parity.py) with the ResNet-18 tactile
encoder restored. Parameters are drawn with numpy from a seed (fan-in
scaled kernels, nonzero biases and BatchNorm statistics, so no layer is
an identity) and handed to both packages.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_golden_parity import golden_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H_IMG, W_IMG = 32, 24
CONTACTS_PER_FINGER = 16


def port_cfg(width=8):
    cfg = golden_cfg(width)
    cfg["model"]["encoder_img"] = "Resnet18"
    # fc_p_img takes [p, c_img]: the tactile feature width is c_dim
    cfg["model"]["encoder_img_kwargs"] = {"num_classes": width}
    return cfg


def random_tree(shapes, rng):
    """Numpy leaves for a tree of ShapeDtypeStructs, by leaf name."""
    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(model, cfg, seed=0):
    """Random (params, batch_stats) for every method the serving path and
    the init of the JAX trainer touch (vtaco_tpu/train/trainer.py:236)."""
    pts = jnp.zeros((1, 64, 3))
    imgs = jnp.zeros((1, 5, H_IMG, W_IMG, 3))
    p = jnp.zeros((1, 8, 3))
    c_dim = cfg["model"]["c_dim"]

    def init_fn(mm):
        c = mm.encode_inputs(pts, train=False)
        mm.encode_hand_inputs(pts, train=False)
        mm.encode_img_inputs(imgs, train=False)
        mm.encode_t2d(pts, imgs, train=False)
        mm.decode(p, c)
        mm.decode_img(p, c, jnp.zeros((1, 8, c_dim)))

    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               method=init_fn))
    rng = np.random.default_rng(seed)
    params = random_tree(shapes["params"], rng)
    stats = random_tree(shapes["batch_stats"], rng)
    return params, stats


def build_pair(width=8, seed=0):
    """(cfg, JAX model, JAX variables, port model on CPU with the same
    weights)."""
    from vtaco_tpu.core.config import get_model as jax_get_model
    from vtaco_tpu_torch.core.config import get_model
    from vtaco_tpu_torch.core.weights import load_jax_params

    cfg = port_cfg(width)
    jmodel, _ = jax_get_model(cfg)
    params, stats = jax_variables(jmodel, cfg, seed)
    tmodel = get_model(cfg, device="cpu")
    load_jax_params(tmodel, params, stats)
    return cfg, jmodel, {"params": params, "batch_stats": stats}, tmodel


def make_batch(rng, n_touch=CONTACTS_PER_FINGER):
    """A B=1 loader batch: an ellipsoid object cloud, five tactile images,
    depth maps where each touching finger presses at most ``n_touch``
    pixels (so the contact set needs no random subsampling), camera poses
    that put the contacts inside the query box."""
    u = rng.standard_normal((300, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    obj = (u * np.array([0.35, 0.25, 0.3])).astype(np.float32)
    depth = np.full((1, 5, H_IMG * W_IMG), 0.0215, np.float32)
    for f in range(5):
        pix = rng.choice(H_IMG * W_IMG, n_touch, replace=False)
        depth[0, f, pix] = 0.0195
    touch = np.array([[1, 1, 0, 1, 1]], np.float32)
    # world-frame scan: the object scaled to ~0.04 so that the sensor's
    # few-millimetre contact patch spans a visible part of the unit box
    pc_ply = (obj * 0.12)[None]
    cam_pos = (obj[rng.choice(len(obj), 5)] * 0.12)[None].astype(np.float32)
    return {
        "inputs": obj[None],
        "inputs.img": (rng.random((1, 5, H_IMG, W_IMG, 3)) / 255.0).astype(np.float32),
        "inputs.depth": depth,
        "inputs.touch_success": touch,
        "inputs.pc_ply": pc_ply.astype(np.float32),
        "points.points_obj": (u[:1000] * np.array([0.35, 0.25, 0.3]))[None].astype(np.float32),
        "points.mano": np.zeros((1, 51), np.float32),
        "points.wrist": np.zeros((1, 3), np.float32),
        "points.cam_pos": cam_pos,
        "points.cam_rot": rng.uniform(-np.pi, np.pi, (1, 5, 3)).astype(np.float32),
    }


def test_import_guard():
    """Every module of the port (the generation CLI, the Inferencer, the
    device-resident dataset and the parallel modules among them),
    chip_smoke.py and the parallel tests' worker module, which spawned
    ranks import, import without jax and without vtaco_tpu; and reading
    the committed JAX checkpoint (tests/golden/vtaco_jax.ckpt) imports
    neither those, flax nor msgpack."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vtaco_tpu_torch\n"
        "for m in pkgutil.walk_packages(vtaco_tpu_torch.__path__, 'vtaco_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tests')\n"
        "import parallel_workers\n"
        "from vtaco_tpu_torch.core.checkpoint import CheckpointIO\n"
        "payload, scalars = CheckpointIO('tests/golden').load_raw('vtaco_jax.ckpt')\n"
        "assert scalars['it'] == 2 and len(payload['model']) > 100, scalars\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'msgpack', 'vtaco_tpu')]\n"
        "assert not bad, bad\n"
        "assert {'vtaco_tpu_torch.cli.generate', 'vtaco_tpu_torch.generate.inferencer',\n"
        "        'vtaco_tpu_torch.data.device_data', 'vtaco_tpu_torch.parallel.mesh',\n"
        "        'vtaco_tpu_torch.parallel.tp', 'vtaco_tpu_torch.parallel.multihost',\n"
        "        'vtaco_tpu_torch.core.flax_msgpack', 'parallel_workers'} <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('vtaco_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", [
    "configs/VTacO/VTacO_YCB.yaml", "configs/VTacO/VTacO_YCB_fast.yaml",
    "configs/VTacOH/VTacOH_YCB.yaml", "configs/tactile/tactile_test.yaml",
    "configs/crop/scene_crop.yaml",
])
def test_load_config_matches_jax(path):
    from vtaco_tpu.core.config import load_config as jax_load
    from vtaco_tpu_torch.core.config import load_config

    assert load_config(path, "configs/default.yaml") == jax_load(
        path, "configs/default.yaml")


def test_full_width_model_loads_jax_tree():
    """VTacO_YCB at full width: a JAX tree of the flagship's shapes loads
    strictly into the port, every submodule (the hand encoder and the
    nested t2d model included) with nothing skipped."""
    from vtaco_tpu.core.config import get_model as jax_get_model
    from vtaco_tpu.core.config import load_config
    from vtaco_tpu_torch.core.config import get_model
    from vtaco_tpu_torch.core.weights import load_jax_params

    cfg = load_config("configs/VTacO/VTacO_YCB.yaml", "configs/default.yaml")
    jmodel, _ = jax_get_model(cfg)
    params, stats = jax_variables(jmodel, cfg)
    tmodel = get_model(cfg, device="cpu")
    load_jax_params(tmodel, params, stats)
    assert set(params) == {"encoder", "encoder_hand", "encoder_img", "encoder_t2d",
                           "decoder"}
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in tmodel.parameters())
    w = params["decoder"]["block4"]["fc_1"]["kernel"]
    np.testing.assert_array_equal(
        tmodel.decoder.blocks[4].fc_1.weight.detach().numpy(), w.T)
