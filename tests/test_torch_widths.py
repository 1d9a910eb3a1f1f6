"""The trunk kernels' plain versions at every decoder width the generic
CUDA kernel (csrc/trunk_any.cu) serves on the card, against the JAX
package's Pallas kernels in interpret mode, which read their widths from
the operands: (hidden, C, n_blocks) of chip_smoke.py's widths phase, K2
with coords, c_img rows of Ci = C + 5 inputs, bf16 storage and an object
axis, K1, and K3/K4 on points sorted by super-cell; then Generator3D's
dense decode at width 16 against JAX's. ``any_tile`` picks the generic
kernel's tile from the widths and raises, naming them and the bytes,
where even its smallest tile exceeds shared memory.

Tolerances: 1e-5 on logits of order 1, as tests/test_torch_trunk.py,
widened to 5e-5 at hidden 256, C 512 (sums of 512 terms per layer: the
two packages' float32 sums in different orders differ by a few 1e-6
there). Gates: points within 1e-6 of r² for some valid contact are left
out, as in tests/test_torch_trunk.py. The CUDA kernels themselves run on
the card, in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.models.conv_onet import ConvOccupancyNetwork as JNet
from vtaco_tpu.models.decoder import LocalDecoder as JDecoder
from vtaco_tpu.ops import dense_decode as JD
from vtaco_tpu.ops.pallas.decode import (
    fused_trunk_cn as j_fused_trunk_cn,
    fused_trunk_gated_cn as j_fused_trunk_gated_cn,
    fused_trunk_window_cn as j_window,
    pack_trunk_params as j_pack,
)
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork as TNet
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import decode as K

from test_torch_trunk import _decoders

# chip_smoke.py's WIDTH_CASES
WIDTH_CASES = [(16, 16, 5), (64, 32, 3), (32, 128, 5), (256, 512, 5)]
PADDING, RADIUS = 0.1, 0.05


def T(x):
    return torch.as_tensor(np.array(x))


def _atol(H, C):
    return 5e-5 if H * C > 10_000 else 1e-5


def _weights(H, C, NB, Ci, seed):
    """(JAX tp, port tp) on the same random weights: fc_p, fc_p_img over
    3 + Ci inputs, NB blocks; kernels (in, out) for JAX, (out, in) here."""
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return ((rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32),
                (0.1 * rng.standard_normal(o)).astype(np.float32))

    t = {"fc_p": lin(H, 3), "fc_p_img": lin(H, 3 + Ci),
         "fc_c": [lin(H, C) for _ in range(NB)],
         "blocks": [lin(H, H) + lin(H, H) for _ in range(NB)], "fc_out": lin(1, H)}
    j = {"fc_p": (t["fc_p"][0].T, t["fc_p"][1]),
         "fc_p_img": (t["fc_p_img"][0].T, t["fc_p_img"][1]),
         "fc_c": [(w.T, b) for w, b in t["fc_c"]],
         "blocks": [(w0.T, b0, w1.T, b1) for w0, b0, w1, b1 in t["blocks"]],
         "fc_out": (t["fc_out"][0].T, t["fc_out"][1])}
    tt = {k: (tuple(T(x) for x in v) if isinstance(v, tuple)
              else [tuple(T(x) for x in e) for e in v]) for k, v in t.items()}
    return j, tt


def _n(H, C):
    return 512 if H * C > 10_000 else 2048


@pytest.mark.parametrize("widths", WIDTH_CASES)
@pytest.mark.parametrize("variant", ["coords", "c_img", "bf16", "batched"])
def test_trunk_widths_match_pallas(rng, widths, variant):
    H, C, NB = widths
    N, Ci = _n(H, C) + 3, C + 5
    jtp, ttp = _weights(H, C, NB, Ci, seed=1)
    p = rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32)
    f = rng.standard_normal((C, N)).astype(np.float32)
    ci = rng.standard_normal((Ci, N)).astype(np.float32) if variant == "c_img" else None
    store = jnp.bfloat16 if variant == "bf16" else None
    jkw = dict(tile=128, interpret=True, store_dtype=store)
    packed = j_pack(jtp, with_img=ci is not None)
    want = j_fused_trunk_cn(packed, jnp.asarray(p), jnp.asarray(f),
                            None if ci is None else jnp.asarray(ci), **jkw)
    tdt = torch.bfloat16 if variant == "bf16" else None
    with torch.no_grad():
        if variant == "batched":
            f2 = np.stack([f, -f])
            got = K.fused_trunk_cn_batched(ttp, T(p), T(f2))
            want = np.stack([np.asarray(want), np.asarray(j_fused_trunk_cn(
                packed, jnp.asarray(p), jnp.asarray(-f), **jkw))])
        else:
            got = K.fused_trunk_cn(ttp, T(p), T(f), None if ci is None else T(ci),
                                   store_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_atol(H, C), rtol=0)
    assert K.fused_trunk_cn.launches_generic == 0     # CPU tensors never launch
    assert K.fused_trunk_cn_batched.launches_generic == 0


def _contacts(rng, C, K_=16):
    q = rng.uniform(-0.4, 0.4, (5, K_, 3)).astype(np.float32)
    feat = rng.standard_normal((5, C)).astype(np.float32)
    valid = rng.random((5, K_)) > 0.3
    return q, feat, valid


def _near(p, q, valid):
    d2 = FT.contact_sq_dist(T(p), T(q), T(valid)).numpy()
    return (np.abs(d2 - RADIUS * RADIUS) < 1e-6).any(axis=0)


@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_gated_trunk_widths_match_pallas(rng, widths):
    H, C, NB = widths
    N = _n(H, C) + 3
    jtp, ttp = _weights(H, C, NB, C, seed=2)
    p = rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32)
    f = rng.standard_normal((C, N)).astype(np.float32)
    q, feat, valid = _contacts(rng, C)
    want = j_fused_trunk_gated_cn(
        j_pack(jtp, with_img=True), jnp.asarray(p), jnp.asarray(f), jnp.asarray(q),
        jnp.asarray(feat), jnp.asarray(valid), radius=RADIUS, tile=128, interpret=True)
    with torch.no_grad():
        got = K.fused_trunk_gated_cn(ttp, T(p), T(f), T(q), T(feat), T(valid),
                                     radius=RADIUS)
        gated = FT.gate_contact_cn(T(p), T(q), T(feat), T(valid), RADIUS)
    assert int(torch.any(gated != 0, dim=0).sum()) > N // 100
    keep = ~_near(p, q, valid)
    assert (~keep).sum() <= 3
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               atol=_atol(H, C), rtol=0)
    assert K.fused_trunk_gated_cn.launches_generic == 0


@pytest.mark.parametrize("widths", WIDTH_CASES)
@pytest.mark.parametrize("variant", ["coords", "c_img", "gated"])
def test_window_trunk_widths_match_pallas(rng, widths, variant):
    """K3 (coords, c_img rows of Ci = C + 5) and K4 at each width: the
    logits, the overflow count and the keys against the Pallas kernel's."""
    H, C, NB = widths
    R, L, S, tile = 9, 1, 512, 256
    N = _n(H, C)
    Ci = C + 5 if variant == "c_img" else C
    jtp, ttp = _weights(H, C, NB, Ci, seed=3)
    g = rng.standard_normal((R, R, R, C)).astype(np.float32)
    p = rng.uniform(-0.62, 0.62, (3, N)).astype(np.float32)
    p = p[:, np.argsort(np.asarray(JD.supercell_keys(jnp.asarray(p), R, PADDING, L)),
                        kind="stable")]
    vol, n1 = JD.supercell_packed_volume(jnp.asarray(g), S, L)
    kw = dict(reso=R, padding=PADDING, L=L, S=S, tile=tile)
    jkw, tkw, keep = {}, {}, np.ones(N, bool)
    if variant == "c_img":
        ci = rng.standard_normal((Ci, N)).astype(np.float32)
        jkw, tkw = dict(c_img_cn=jnp.asarray(ci)), dict(c_img_cn=T(ci))
    elif variant == "gated":
        q, feat, valid = _contacts(rng, C)
        jkw = dict(gate_pts=jnp.asarray(q), gate_feat=jnp.asarray(feat),
                   gate_valid=jnp.asarray(valid), radius=RADIUS)
        tkw = dict(gate_pts=T(q), gate_feat=T(feat), gate_valid=T(valid), radius=RADIUS)
        keep = ~_near(p, q, valid)
        assert (~keep).sum() <= 3
    want, j_over = j_window(j_pack(jtp, with_img=variant != "coords"), vol,
                            jnp.asarray(p), n1=n1, interpret=True, **kw, **jkw)
    keys = torch.empty(N, dtype=torch.int32)
    with torch.no_grad():
        got, t_over = K.fused_trunk_window_cn(ttp, T(g), T(p), keys_out=keys, **kw, **tkw)
    assert int(t_over) == int(j_over) == 0
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(JD.supercell_keys(jnp.asarray(p), R, PADDING, L)))
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               atol=_atol(H, C), rtol=0)
    assert K.fused_trunk_window_cn.launches_generic == 0
    assert K.fused_trunk_window_cn.launches_generic_gated == 0


@pytest.mark.parametrize("mode", ["none", "contact"])
def test_dense_decode_width16_matches_jax(rng, mode):
    """Generator3D.eval_points_dense on a decoder of hidden = C = 16 (the
    generic kernel's width on the card) against the JAX Generator3D's, at
    float32 transfers, ungated and contact-gated."""
    W, NB, R, nx = 16, 5, 9, 12
    params, tdec = _decoders(c_dim=W, hidden=W, n_blocks=NB, seed=4)
    jmodel = JNet(decoder=JDecoder(c_dim=W, hidden_size=W, n_blocks=NB))

    class State:
        batch_stats = {}

    State.params = {"decoder": params}
    tmodel = TNet(decoder=tdec)
    jgen, tgen = JGen(jmodel, padding=PADDING), TGen(tmodel, padding=PADDING)
    grid = rng.standard_normal((1, R, R, R, W)).astype(np.float32)
    jg, tg = (), ()
    if mode == "contact":
        q, feat, valid = _contacts(rng, W)
        jg = ("contact", jnp.asarray(q), jnp.asarray(feat), jnp.asarray(valid))
        tg = ("contact", T(q), T(feat), T(valid))
    want = jgen.eval_points_dense(State(), nx, {"grid": jnp.asarray(grid)}, *jg,
                                  transfer_dtype=jnp.float32)
    got = tgen.eval_points_dense(tmodel, nx, {"grid": T(grid)}, *tg,
                                 transfer_dtype=torch.float32)
    assert got.shape == (nx ** 3,)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("widths,Ci,tile", [
    ((32, 32, 5), 0, 128), ((16, 16, 5), 0, 128), ((64, 32, 3), 40, 128),
    ((32, 128, 5), 136, 128), ((256, 512, 5), 0, 32), ((256, 512, 5), 520, 32)])
def test_generic_tile_from_widths(widths, Ci, tile):
    """The generic kernel's tile: the largest of 128, 64, 32 points whose
    net, h, features (or c_img rows) and per-point words fit 232,448 B;
    the route: the tile chain at hidden = C = 32 only."""
    H, C, NB = widths
    assert K.any_tile(H, C, Ci) == tile
    assert K.any_smem_bytes(H, C, Ci, tile) <= K.SMEM_LIMIT
    tp = {"fc_out": (torch.zeros(1, H), None), "blocks": [None] * NB}
    assert K._tile_chain(tp, C) == ((H, C) == (32, 32))
    assert not K._tile_chain({"fc_out": (torch.zeros(1, 32), None),
                              "blocks": [None] * 7}, 32)      # 7 blocks exceed it


def test_generic_tile_raises_past_shared_memory():
    with pytest.raises(ValueError, match=r"hidden=1024, C=2048, Ci=0: .* 525312 B of "
                                         r"shared memory, a block has 232448"):
        K.any_tile(1024, 2048)
