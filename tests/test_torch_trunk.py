"""The port's plain trunk versions against the JAX package's Pallas kernels
(run in interpret mode, as tests/test_fast_decode.py:125-245 runs them),
at atol 1e-5, with that file's cases: c_img rows, odd N, invalid contact
rows, all contacts invalid, clustered contacts and bf16 storage.

Contact gating compares an expanded squared distance with r²; the two
packages round it differently, so points with |d2 - r²| < 1e-6 for some
valid contact may flip and are excluded from the comparison (their count
is asserted small). The CUDA kernels themselves run only on the card, in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.models.conv_onet import ConvOccupancyNetwork
from vtaco_tpu.models.decoder import LocalDecoder as JDecoder
from vtaco_tpu.ops import fast_trunk as JFT
from vtaco_tpu.ops.pallas.decode import (
    fused_trunk_cn as j_fused_trunk_cn,
    fused_trunk_gated_cn as j_fused_trunk_gated_cn,
    pack_trunk_params as j_pack,
)
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.models.decoder import LocalDecoder
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import decode as K

from test_torch_setup import random_tree

C, HID, NB = 8, 16, 3


def _decoders(c_dim=C, hidden=HID, n_blocks=NB, seed=0):
    jdec = JDecoder(c_dim=c_dim, hidden_size=hidden, n_blocks=n_blocks)
    model = ConvOccupancyNetwork(decoder=jdec)
    p = jnp.zeros((1, 4, 3))

    def initp(m):
        m.decoder.forward_feats(p, jnp.zeros((1, 4, c_dim)))
        m.decoder.forward_img_feats(p, jnp.zeros((1, 4, c_dim)),
                                    jnp.zeros((1, 4, c_dim)))

    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), method=initp))
    params = random_tree(shapes["params"], np.random.default_rng(seed))["decoder"]
    tdec = LocalDecoder(c_dim=c_dim, hidden_size=hidden, n_blocks=n_blocks)
    load_jax_params(tdec, params, {})
    return params, tdec


@pytest.fixture(scope="module")
def dec():
    return _decoders()


def _tp(dec, with_img):
    params, tdec = dec
    return (JFT.extract_trunk_params(params, NB, with_img=with_img),
            FT.extract_trunk_params(tdec, with_img=with_img))


def _inputs(rng, N):
    p = rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
    f = rng.standard_normal((C, N)).astype(np.float32)
    return p, f


def T(x):
    return torch.as_tensor(np.array(x))


def _near_radius(p, gate_pts, gate_valid, radius):
    d2 = FT.contact_sq_dist(T(p), T(gate_pts), T(gate_valid)).numpy()
    return (np.abs(d2 - radius * radius) < 1e-6).any(axis=0)


@pytest.mark.parametrize("N", [512, 593, 9 ** 3, 37])
@pytest.mark.parametrize("with_img", [False, True])
def test_trunk_matches_pallas(rng, dec, N, with_img):
    jtp, ttp = _tp(dec, with_img)
    p, f = _inputs(rng, N)
    ci = rng.standard_normal((C, N)).astype(np.float32) if with_img else None
    want = j_fused_trunk_cn(j_pack(jtp, with_img=with_img), jnp.asarray(p),
                            jnp.asarray(f), None if ci is None else jnp.asarray(ci),
                            tile=128, interpret=True)
    with torch.no_grad():
        got = FT.trunk_cn(ttp, T(p), T(f), None if ci is None else T(ci))
        wrapped = K.fused_trunk_cn(ttp, T(p), T(f), None if ci is None else T(ci))
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    assert K.fused_trunk_cn.launches == 0  # CPU tensors never launch


def test_trunk_bf16_storage_matches_pallas(rng, dec):
    jtp, ttp = _tp(dec, False)
    p, f = _inputs(rng, 729)
    want = j_fused_trunk_cn(j_pack(jtp, with_img=False), jnp.asarray(p),
                            jnp.asarray(f), tile=128, store_dtype=jnp.bfloat16,
                            interpret=True)
    with torch.no_grad():
        got = K.fused_trunk_cn(ttp, T(p), T(f), store_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _gate_cases(rng, K_):
    wide = rng.uniform(-0.4, 0.4, (5, K_, 3)).astype(np.float32)
    valid = rng.random((5, K_)) > 0.3
    tight = (0.31 + 0.02 * rng.standard_normal((5, K_, 3))).astype(np.float32)
    return {
        # overlapping shells of several fingers: the overwrite order matters
        "invalid_rows": (wide, valid, 0.25),
        "all_invalid": (wide, np.zeros((5, K_), bool), 0.25),
        "clustered": (tight, valid, 0.03),
    }


@pytest.mark.parametrize("case", ["invalid_rows", "all_invalid", "clustered"])
@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_gated_trunk_matches_pallas(rng, dec, case, store):
    N, K_ = 593, 16
    jtp, ttp = _tp(dec, True)
    p, f = _inputs(rng, N)
    gate_feat = rng.standard_normal((5, C)).astype(np.float32)
    gate_pts, gate_valid, radius = _gate_cases(rng, K_)[case]
    want = j_fused_trunk_gated_cn(
        j_pack(jtp, with_img=True), jnp.asarray(p), jnp.asarray(f),
        jnp.asarray(gate_pts), jnp.asarray(gate_feat), jnp.asarray(gate_valid),
        radius=radius, tile=128, interpret=True,
        store_dtype=None if store is None else jnp.bfloat16)
    tdt = None if store is None else torch.bfloat16
    with torch.no_grad():
        p_seen = K._stored(T(p), tdt)
        c_img = FT.gate_contact_cn(p_seen, T(gate_pts), T(gate_feat),
                                   T(gate_valid), radius)
        got = FT.trunk_cn(ttp, p_seen, K._stored(T(f), tdt), c_img)
        wrapped = K.fused_trunk_gated_cn(ttp, T(p), T(f), T(gate_pts),
                                         T(gate_feat), T(gate_valid),
                                         radius=radius, store_dtype=tdt)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    if case != "all_invalid":
        assert torch.any(c_img != 0)
    near = _near_radius(p_seen.numpy(), gate_pts, gate_valid, radius)
    assert near.sum() <= 3, near.sum()
    np.testing.assert_allclose(got.numpy()[~near], np.asarray(want)[~near],
                               atol=1e-5, rtol=0)
    assert K.fused_trunk_gated_cn.launches == 0


def test_gate_contact_last_finger_wins():
    p = np.zeros((3, 2), np.float32)
    p[0, 1] = 0.5                                    # second point: no contact
    gate_pts = np.zeros((5, 2, 3), np.float32)
    gate_pts[:, :, 0] = 1.0                          # all far ...
    gate_pts[1, 0, 0] = gate_pts[3, 1, 0] = 0.005    # ... but fingers 1 and 3
    valid = np.ones((5, 2), bool)
    feat = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    got = FT.gate_contact_cn(T(p), T(gate_pts), T(feat), T(valid))
    np.testing.assert_array_equal(got[:, 0].numpy(), feat[3])
    np.testing.assert_array_equal(got[:, 1].numpy(), np.zeros(4))
    valid[3, 1] = False                              # invalid rows never gate
    got = FT.gate_contact_cn(T(p), T(gate_pts), T(feat), T(valid))
    np.testing.assert_array_equal(got[:, 0].numpy(), feat[1])
