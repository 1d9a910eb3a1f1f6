"""ResNet-34 and ResNet-50, the other tactile image encoders, in the
PyTorch port (vtaco_tpu_torch) against the JAX package on the CPU.

The encoders alone on 2 x 3 x 64 x 64 images in train mode (outputs and
every BatchNorm's moved statistics) and in eval mode, in float64 and
float32 at tests/families.py's ``assert_matches_jax`` tolerances; then
VTacO_YCB with each as ``encoder_img`` (tests/families.py, small widths):
the factory builds both, and fam_r50's t2d_img train step (losses, every
gradient) and eval step match the JAX trainer's, with its contact draws,
at the tolerances tests/families.py states.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.models import layers as JL
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.models import layers as TL

from families import (assert_matches_jax, check_steps, family_cfg, jax_f64, jax_state,
                      loaders, trainers)
from test_torch_fast import share_cores  # noqa: F401
from test_torch_setup import random_tree


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth_resnet")), n_models=4,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


@pytest.mark.parametrize("name", ["Resnet34", "Resnet50"])
@pytest.mark.parametrize("train", [True, False])
def test_resnet_matches_jax(name, train):
    """Outputs, and in train mode every moved BatchNorm statistic, at
    'highest' precision on both sides and in float64 (train-mode BatchNorm
    over a batch of two amplifies float32 rounding through the deep
    stacks, in both packages)."""
    import jax

    jnet = getattr(JL, name)(num_classes=8)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              train=False))
    params = random_tree(shapes["params"], rng)
    stats = random_tree(shapes["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    net = load_jax_params(getattr(TL, name)(num_classes=8), params, stats).train(train)
    exact = copy.deepcopy(net).double()
    assert isinstance(getattr(net.layer1[0], "conv3", None), torch.nn.Conv2d) == (
        name == "Resnet50")
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    def run(v, x):
        if train:
            return jnet.apply(v, x, train=True, mutable=["batch_stats"])
        return jnet.apply(v, x, train=False), {"batch_stats": {}}

    with jax.default_matmul_precision("highest"):
        want, mut = run(variables, jnp.asarray(x))
    want64, mut64 = jax_f64(run, variables, x)
    with torch.no_grad():
        got = net(xt).numpy()
        ex = exact(xt.double()).numpy()
    assert_matches_jax("out", got, np.asarray(want), ex, want64)
    if train:
        moved = TI.export_state_dict({}, mut["batch_stats"])
        moved64 = TI.export_state_dict({}, mut64["batch_stats"])
        sd, sd64 = net.state_dict(), exact.state_dict()
        assert set(moved) <= set(sd)
        for k, v in moved.items():
            assert_matches_jax(k, sd[k].numpy(), np.asarray(v), sd64[k].numpy(), moved64[k])


@pytest.mark.parametrize("fam", ["r34", "r50"])
def test_factory_builds_family(synth, fam):
    model = get_model(family_cfg(synth, fam), device="cpu")
    blocks = {"r50": TL.Bottleneck, "r34": TL.BasicBlock}[fam]
    assert isinstance(model.encoder_img.layer3[5], blocks)
    assert model.encoder_img.linear.in_features == 512 * blocks.expansion


def test_r50_steps_match_jax(synth):
    """fam_r50's t2d_img train and eval steps. ResNet-50's train-mode
    BatchNorm over this batch's ten 16 x 12 images amplifies float32
    rounding: its image features stray 5.0e-4 from a float64 evaluation in
    the JAX package (the port's 2.5e-4) and its gradients 8.2 % (the
    port's 1.6 %; ``python tests/families.py``), so the gradients are held
    to the JAX package's in float64 (tests/families.py)."""
    check_steps(family_cfg(synth, "r50"))


def test_legacy_scale_features(synth):
    """fam_r50's train-mode image features on the loader's batch, at
    assert_matches_jax's tolerances."""
    import jax

    cfg = family_cfg(synth, "r50")
    jtr, _ = trainers(cfg)
    batch = loaders(cfg, "train", 2, seed=0)
    params, stats, _ = jax_state(jtr, batch)
    imgs = jtr.prepare_batch(batch)["imgs"]
    def run(v, imgs):
        return jtr.model.apply(v, imgs, method=jtr.model.encode_img_inputs, train=True,
                               mutable=["batch_stats"])[0]

    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        want = run(variables, imgs)
    want64 = jax_f64(run, variables, imgs)
    model = load_jax_params(get_model(cfg, device="cpu"), params, stats).train()
    exact = copy.deepcopy(model).double()
    x = torch.as_tensor(np.asarray(imgs))
    with torch.no_grad():
        got = model.encode_img_inputs(x).numpy()
        ex = exact.encode_img_inputs(x.double()).numpy()
    assert_matches_jax("c_img", got, np.asarray(want), ex, want64)
