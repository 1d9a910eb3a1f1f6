"""Port models against the JAX package on the same weights and inputs:
the object encoder's grid (LocalPoolPointnet + UNet3D), the ResNet-18
tactile features, the decoder heads, and the committed reference goldens.

Tolerances: the grid 1e-4 (3D convolutions sum in another order), the
ResNet features 1e-4 (likewise, through 17 conv layers), the decoder
logits 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.ops import fast_trunk as FT

from test_golden_parity import GOLDEN_WIDTHS, _golden_path, golden_cfg, golden_inputs
from test_torch_setup import H_IMG, W_IMG, build_pair


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, v, tmodel = build_pair()
    rng = np.random.default_rng(5)
    u = rng.standard_normal((256, 3))
    pts = (0.3 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    pts[:40] = pts[0] + 0.001 * rng.standard_normal((40, 3))  # shared cells
    jc = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                           method=jmodel.encode_inputs))(
        v, jnp.asarray(pts[None]))
    with torch.no_grad():
        tc = tmodel.encode_inputs(torch.as_tensor(pts[None]))
    return cfg, jmodel, v, tmodel, jc, tc


def test_encode_inputs_grid(pair):
    _, _, _, _, jc, tc = pair
    assert set(tc) == {"grid"} and tc["grid"].shape == jc["grid"].shape
    np.testing.assert_allclose(tc["grid"].numpy(), np.asarray(jc["grid"]),
                               atol=1e-4, rtol=0)


def test_encode_img_inputs(pair):
    _, jmodel, v, tmodel, _, _ = pair
    imgs = np.random.default_rng(6).random((1, 5, H_IMG, W_IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                             method=jmodel.encode_img_inputs))(
        v, jnp.asarray(imgs))
    with torch.no_grad():
        got = tmodel.encode_img_inputs(torch.as_tensor(imgs))
    assert got.shape == want.shape == (1, 5, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_decode_logits(pair):
    """decode / decode_img on the same feature grid (the JAX one, so only
    the decoder is compared), with query points past the box edge."""
    _, jmodel, v, tmodel, jc, _ = pair
    rng = np.random.default_rng(7)
    p = rng.uniform(-0.6, 0.6, (1, 300, 3)).astype(np.float32)
    c_img = rng.standard_normal((1, 300, 8)).astype(np.float32)
    grid = {"grid": torch.as_tensor(np.asarray(jc["grid"]))}
    want = jmodel.apply(v, jnp.asarray(p), jc, method=jmodel.decode)
    want_i = jmodel.apply(v, jnp.asarray(p), jc, jnp.asarray(c_img),
                          method=jmodel.decode_img)
    with torch.no_grad():
        got = tmodel.decode(torch.as_tensor(p), grid)
        got_i = tmodel.decode_img(torch.as_tensor(p), grid, torch.as_tensor(c_img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-5, rtol=0)


def test_feats_heads_match_channels_first_trunk(pair):
    """forward_feats / forward_img_feats (module layout) equal trunk_cn
    (channels-first) on the same pre-interpolated features."""
    _, _, _, tmodel, _, _ = pair
    rng = np.random.default_rng(8)
    p = torch.as_tensor(rng.uniform(-0.5, 0.5, (1, 100, 3)).astype(np.float32))
    c = torch.as_tensor(rng.standard_normal((1, 100, 8)).astype(np.float32))
    ci = torch.as_tensor(rng.standard_normal((1, 100, 8)).astype(np.float32))
    dec = tmodel.decoder
    with torch.no_grad():
        plain = FT.trunk_cn(FT.extract_trunk_params(dec, False), p[0].T, c[0].T)
        gated = FT.trunk_cn(FT.extract_trunk_params(dec, True), p[0].T, c[0].T, ci[0].T)
        np.testing.assert_allclose(plain.numpy(), dec.forward_feats(p, c)[0].numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(gated.numpy(),
                                   dec.forward_img_feats(p, c, ci)[0].numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("width", GOLDEN_WIDTHS)
def test_reference_goldens(width):
    """The committed reference activations (tests/golden/, captured from the
    original PyTorch implementation) at the golden test's tolerances: the
    port loads the golden's imported weights and reproduces the grid and
    both logit heads."""
    path = _golden_path(width)
    data = dict(np.load(path))
    params = traverse_util.unflatten_dict(
        {tuple(k[len("param/"):].split("/")): v
         for k, v in data.items() if k.startswith("param/")})
    stats = traverse_util.unflatten_dict(
        {tuple(k[len("stat/"):].split("/")): v
         for k, v in data.items() if k.startswith("stat/")})
    model = get_model(golden_cfg(width), device="cpu")
    load_jax_params(model, params, stats)
    pts, _, p, c_img = golden_inputs(np.random.default_rng(1), width)
    with torch.no_grad():
        c = model.encode_inputs(torch.as_tensor(pts))
        logits = model.decode(torch.as_tensor(p), c)
        logits_i = model.decode_img(torch.as_tensor(p), c, torch.as_tensor(c_img))
    np.testing.assert_allclose(c["grid"].numpy(), data["ref/grid"], atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(logits.numpy(), data["ref/logits"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(logits_i.numpy(), data["ref/logits_img"],
                               atol=2e-4, rtol=2e-4)
    assert os.path.basename(path).startswith("vtaco_golden")
