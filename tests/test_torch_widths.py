"""The trunk kernels' plain versions at every decoder width the generic
CUDA kernel (csrc/trunk_any.cu) serves on the card, against the JAX
package's Pallas kernels in interpret mode, which read their widths from
the operands: (hidden, C, n_blocks) of chip_smoke.py's widths phase, K2
with coords, c_img rows of Ci = C + 5 inputs, bf16 storage and an object
axis, K1, and K3/K4 on points sorted by super-cell; then Generator3D's
dense decode at width 16 against JAX's. ``any_tile`` picks the generic
kernel's tile from hidden alone and raises past the widest hidden layer
its smallest tile holds, naming that limit. The generic kernel's
arithmetic (3xTF32 products from the padded blob, k-slice by k-slice) is
emulated on the CPU and held against the plain trunk in every mode, at
the widths phase's cases, the two widest (hidden 1,024 and C 1,024) and
an odd width.

Tolerances: 1e-5 on logits of order 1, as tests/test_torch_trunk.py,
widened to 5e-5 at hidden 256, C 512 (sums of 512 terms per layer: the
two packages' float32 sums in different orders differ by a few 1e-6
there). Gates: points within 1e-6 of r² for some valid contact are left
out, as in tests/test_torch_trunk.py. The CUDA kernels themselves run on
the card, in tests/test_torch_cuda.py.
"""

import os

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
from vtaco_tpu_torch.ops.dense_decode import scattered_grid_features_cn

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
    ((32, 32, 5), 0, 256), ((16, 16, 5), 0, 256), ((64, 32, 3), 40, 256),
    ((32, 128, 5), 136, 256), ((256, 512, 5), 0, 64), ((256, 512, 5), 520, 64),
    ((512, 1024, 3), 1029, 32), ((1024, 32, 5), 37, 16), ((1024, 2048, 1), 2053, 16)])
def test_generic_tile_from_widths(widths, Ci, tile):
    """The generic kernel's tile from hidden alone (eight warps tile the T
    x hidden output; net and h stay resident, C and Ci stream through
    k-slices), so (1024, 2048) and (1024, 32) plan the same tile; the
    padded blob's size; the route: the tile chain at hidden = C = 32
    only."""
    H, C, NB = widths
    assert K.any_tile(H) == tile
    T, KS, MT, WO, chunk, smem = K.any_plan(H)
    assert smem == K.any_smem_bytes(H) <= K.SMEM_LIMIT
    assert (8 // WO) * MT * 16 == T and KS in (8, 16, 32)
    Hp, Cp, Cip = (-(-x // 8) * 8 for x in (H, C, Ci))
    assert chunk >= min(Hp, 1024)
    tp = {"fc_p": (torch.ones(H, 3), torch.ones(H)), "fc_p_img": (torch.ones(H, 3 + Ci),
                                                                   torch.ones(H)),
          "fc_c": [(torch.ones(H, C), torch.ones(H))] * NB,
          "blocks": [(torch.ones(H, H), torch.ones(H))* 2] * NB,
          "fc_out": (torch.ones(1, H), torch.ones(1))}
    base = 4 * Hp + NB * (Hp * Cp + Hp + 2 * (Hp * Hp + Hp)) + Hp + 8
    assert K.pack_any_params(tp, 0).numel() == base
    assert K.pack_any_params(tp, 1).numel() == base + Hp * Cip
    assert K.pack_any_params(tp, 2, torch.ones(5, Ci)).numel() == base + 5 * Hp
    assert K._tile_chain(tp, C) == ((H, C) == (32, 32))
    assert not K._tile_chain({"fc_out": (torch.zeros(1, 32), None),
                              "blocks": [None] * 7}, 32)      # 7 blocks exceed it


def test_generic_tile_raises_past_shared_memory():
    """Every hidden width up to ANY_MAX_HIDDEN (1,280: net and h of 16
    points beside one weight slice) plans a tile; past it the planner
    raises, naming the limit."""
    assert K.ANY_MAX_HIDDEN == 1280
    assert all(K.any_plan(H) is not None for H in range(1, K.ANY_MAX_HIDDEN + 1))
    assert K.any_plan(K.ANY_MAX_HIDDEN + 1) is None
    with pytest.raises(ValueError, match=r"hidden widths up to 1280, got hidden=1288: "
                                         r".* 232448 B of shared memory"):
        K.any_tile(1288)


# -- the generic kernel's arithmetic, emulated -------------------------------

NEW_WIDTHS = [(1024, 32, 5), (512, 1024, 3)]     # chip_smoke.py's WIDTH_CASES
EMULATED_CASES = WIDTH_CASES + NEW_WIDTHS + [(20, 12, 2)]


def _split(x):
    hi = K.tf32_rna(x)
    return hi, K.tf32_rna(x - hi)


def _pad8(x):
    return -(-x // 8) * 8


def _any_product(x, W, bias, KS):
    """bias + x W^T as csrc/trunk_any.cu forms it: each k-slice of KS input
    channels accumulates from zero the terms lo.hi, hi.lo and hi.hi of the
    TF32 splits of x (relu'd activations or streamed rows) and of W's
    staged rows (zeros past the last input channel), small terms first
    (the two as one sum of 2 KS products), and is added to the product's
    accumulator, which starts at the bias."""
    (N, K), H = x.shape, W.shape[0]
    ns = -(-K // KS)
    xs = torch.nn.functional.pad(x, (0, ns * KS - K)).reshape(N, ns, KS).transpose(0, 1)
    ws = torch.nn.functional.pad(W, (0, ns * KS - K)).reshape(H, ns, KS).permute(1, 2, 0)
    (a_hi, a_lo), (b_hi, b_lo) = _split(xs), _split(ws)
    a_small = torch.cat([a_lo, a_hi], dim=2).contiguous()     # (ns, N, 2 KS)
    b_small = torch.cat([b_hi, b_lo], dim=1).contiguous()     # (ns, 2 KS, H)
    a_hi, b_hi = a_hi.contiguous(), b_hi.contiguous()
    acc = torch.zeros(N, H) if bias is None else bias.expand(N, -1).clone()
    for s in range(ns):
        acc += torch.mm(a_small[s], b_small[s]).add_(torch.mm(a_hi[s], b_hi[s]))
    return acc


def _emulated_any(blob, H, C, NB, p_cn, f_cn, c_img_cn=None, finger=None):
    """The logits csrc/trunk_any.cu computes from pack_any_params's padded
    blob, its order of operations included: the input projection as FMAs
    on the CUDA cores (float64, rounded once), the gated finger's row W_img
    g_f (``finger`` (N,), -1 for none) or the c_img product, then each
    block's three products (``_any_product``) added to net, and the head."""
    Hp, Cp = _pad8(H), _pad8(C)
    KS = K.any_plan(H)[1]
    o = 0

    def take(n, *shape):
        nonlocal o
        o += n
        return blob[o - n:o].reshape(*shape) if shape else blob[o - n:o]

    wp, b_in = take(3 * Hp, Hp, 3), take(Hp)
    blocks = [(take(Hp * Cp, Hp, Cp), take(Hp), take(Hp * Hp, Hp, Hp), take(Hp),
               take(Hp * Hp, Hp, Hp), take(Hp)) for _ in range(NB)]
    w_out, b_out = take(Hp), take(8)[0]
    N = p_cn.shape[1]
    net = (p_cn.T.double() @ wp.T.double()).float() + b_in
    if finger is not None:
        gproj = blob[o:].reshape(-1, Hp)
        net = net + torch.where(finger[:, None] >= 0, gproj[finger.clamp(min=0)], 0.0)
    if c_img_cn is not None:
        Cip = _pad8(c_img_cn.shape[0])
        ci = torch.zeros(N, Cip)
        ci[:, :c_img_cn.shape[0]] = c_img_cn.T
        net = net + _any_product(ci, blob[o:].reshape(Hp, Cip), None, KS)
    f = torch.zeros(N, Cp)
    f[:, :C] = f_cn.T
    for wc, bc, w0, b0, w1, b1 in blocks:
        net = net + _any_product(f, wc, bc, KS)
        h = _any_product(torch.relu(net), w0, b0, KS)
        net = net + _any_product(torch.relu(h), w1, b1, KS)
    return torch.relu(net) @ w_out + b_out


def _last_finger(p, q, valid, radius):
    """The gated finger of each point (the last finger with a valid contact
    within radius, by the expanded distance), -1 for none."""
    d2 = FT.contact_sq_dist(p, q, valid)
    within = torch.any((d2 < radius * radius).reshape(q.shape[0], q.shape[1], -1), dim=1)
    last = (q.shape[0] - 1) - torch.argmax(within.flip(0).to(torch.uint8), dim=0)
    return torch.where(torch.any(within, dim=0), last, -1)


@pytest.fixture
def share_cores():
    """Under pytest-xdist each worker takes its share of the cores for
    torch's intra-op threads (as tests/test_torch_fast.py's fixture): the
    emulation's many small products ran 20-30 times slower when six
    workers' thread pools oversubscribed the cores."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


@pytest.mark.usefixtures("share_cores")
@pytest.mark.parametrize("widths", EMULATED_CASES)
@pytest.mark.parametrize("mode", ["K2", "K2:c_img", "K2:bf16", "K1", "K3", "K4"])
def test_generic_kernel_arithmetic(widths, mode):
    """The generic kernel's 3xTF32 chain, emulated from the padded blob in
    the kernel's order, against the IEEE f32 plain trunk in each mode: K2
    (coords, c_img rows of Ci = C + 5, bf16 storage), K1, and K3/K4 on the
    trilinear features of a grid; at chip_smoke.py's widths, the two
    widest and an odd width, on 300 points. Tolerances as the file's (1e-5,
    5e-5 from 256 wide); gated points within 1e-6 of r² left out."""
    H, C, NB = widths
    N, Ci, R = 300, C + 5, 9
    rng = np.random.default_rng(7)
    _, tp = _weights(H, C, NB, Ci if mode == "K2:c_img" else C, seed=5)
    p = T(rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32))
    f = T(rng.standard_normal((C, N)).astype(np.float32))
    if mode in ("K3", "K4"):
        grid = T(rng.standard_normal((R, R, R, C)).astype(np.float32))
        f = scattered_grid_features_cn(grid, p, PADDING)
    if mode == "K2:bf16":
        p, f = K._stored(p, torch.bfloat16), K._stored(f, torch.bfloat16)
    keep = torch.ones(N, dtype=torch.bool)
    with torch.no_grad():
        if mode == "K2:c_img":
            ci = T(rng.standard_normal((Ci, N)).astype(np.float32))
            got = _emulated_any(K.pack_any_params(tp, 1), H, C, NB, p, f, c_img_cn=ci)
            want = FT.trunk_cn(tp, p, f, ci)
        elif mode in ("K1", "K4"):
            q, feat, valid = (T(x) for x in _contacts(rng, C))
            finger = _last_finger(p, q, valid, RADIUS)
            assert int((finger >= 0).sum()) > N // 100
            got = _emulated_any(K.pack_any_params(tp, 2, feat), H, C, NB, p, f,
                                finger=finger)
            want = FT.trunk_cn(tp, p, f, FT.gate_contact_cn(p, q, feat, valid, RADIUS))
            keep = T(~_near(p.numpy(), q.numpy(), valid.numpy()))
        else:
            got = _emulated_any(K.pack_any_params(tp, 0), H, C, NB, p, f)
            want = FT.trunk_cn(tp, p, f)
    assert float(want.abs().max()) > 0.5          # logits of order one
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), atol=_atol(H, C),
                               rtol=0)


@pytest.mark.parametrize("widths", NEW_WIDTHS)
@pytest.mark.parametrize("variant", ["K2", "K1"])
def test_new_widths_match_pallas(rng, widths, variant):
    """K2 (coords) and K1's plain versions at the two widest cases against
    the Pallas kernels in interpret mode, on 125 points."""
    H, C, NB = widths
    N = 125
    jtp, ttp = _weights(H, C, NB, C, seed=6)
    p = rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32)
    f = rng.standard_normal((C, N)).astype(np.float32)
    keep = np.ones(N, bool)
    with torch.no_grad():
        if variant == "K2":
            want = j_fused_trunk_cn(j_pack(jtp, with_img=False), jnp.asarray(p),
                                    jnp.asarray(f), tile=128, interpret=True)
            got = K.fused_trunk_cn(ttp, T(p), T(f))
        else:
            q, feat, valid = _contacts(rng, C)
            q[:, :4] = p.T[None, :4] + 0.01      # some points of the set are gated
            want = j_fused_trunk_gated_cn(
                j_pack(jtp, with_img=True), jnp.asarray(p), jnp.asarray(f),
                jnp.asarray(q), jnp.asarray(feat), jnp.asarray(valid), radius=RADIUS,
                tile=128, interpret=True)
            got = K.fused_trunk_gated_cn(ttp, T(p), T(f), T(q), T(feat), T(valid),
                                         radius=RADIUS)
            gated = FT.gate_contact_cn(T(p), T(q), T(feat), T(valid), RADIUS)
            assert int(torch.any(gated != 0, dim=0).sum()) >= 2
            keep = ~_near(p, q, valid)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               atol=_atol(H, C), rtol=0)
