"""The tile kernels' design (csrc/trunk.cu, csrc/window.cu on the chain of
csrc/tile_chain.cuh) on the CPU, where the kernels themselves cannot run:

- ``pack_window_params``: the chain evaluated in plain torch through the
  packed blob, the way the kernel evaluates it (B-fragment order undone,
  every operand split into TF32 hi/lo parts by round-to-nearest-away on
  the 13 low mantissa bits, lo.hi + hi.lo + hi.hi per product), against
  the port's ``trunk_cn`` and the JAX package's at the flagship widths
  (hidden = C = 32, 5 blocks) within 1e-5: a tenfold margin under the
  card's 1e-4 check; ``_window_operands`` and ``_trunk_operands``, what
  the wrappers hand the kernels in each mode, and K1/K2's operands
  (c_img rows, bf16 storage, contact gating) through the emulated chain
  against both packages' trunks, the JAX one its Pallas kernel in
  interpret mode.
- ``window_gate_candidates``, the plain version of K1's and K4's per-tile
  contact culling: restricting each tile's gate to its candidates changes
  no decision, on sorted and unsorted points and on the rows of the mesh
  lattice; contacts at r (1 +- 1e-6) from a tile's box and at its corners
  are kept (and the card checks' set ``window_box_edge_contacts``); ragged
  tiles and N < T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.ops import fast_trunk as JFT
from vtaco_tpu.ops.pallas.decode import (
    fused_trunk_cn as j_fused_trunk_cn,
    fused_trunk_gated_cn as j_fused_trunk_gated_cn,
    pack_trunk_params as j_pack,
)
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import decode as K
from vtaco_tpu_torch.ops.dense_decode import dense_query_grid_cn, supercell_keys

from test_torch_trunk import T, _decoders

W, NBLK = 32, 5          # the flagship widths, the only ones window.cu takes
TILE = K.WINDOW_TILE
RADIUS = 0.015


@pytest.fixture(scope="module")
def flagship():
    return _decoders(c_dim=W, hidden=W, n_blocks=NBLK, seed=1)


# -- the packer --------------------------------------------------------------

def _unpack(prods):
    """(P, 2048) packed products → their hi and lo parts, (P, 32, 32) each
    (out, in): part, k8 step jk, core matrix (nb, kb), row r, element e hold
    W[8nb + r][8jk + 2e + kb]."""
    P = prods.shape[0]
    x = prods.reshape(P, 2, 4, 4, 2, 8, 4).permute(0, 1, 3, 5, 2, 6, 4)
    x = x.reshape(P, 2, W, W)
    return x[:, 0], x[:, 1]


def _split(x):
    hi = K.tf32_rna(x)
    return hi, K.tf32_rna(x - hi)


def _product(x, w_hi, w_lo):
    """x (N, 32) @ W.T as the kernel forms it: 3xTF32, small terms first."""
    hi, lo = _split(x)
    return (lo @ w_hi.T + hi @ w_lo.T) + hi @ w_hi.T


def _emulated_chain(blob, p_cn, f_cn, c_img_cn=None, sel=None):
    """The logits the tile kernels compute from ``blob``, their order of
    operations included, with numpy-exact TF32 splits in place of cvt.rna:
    with ``c_img_cn`` the blob's c_img product (mode 1), with ``sel`` (N,)
    the gated finger per point or -1, whose row W_img g_f of the blob's
    tail is added to the input projection (mode 2)."""
    n_frag = 3 * NBLK * 2048
    w_hi, w_lo = _unpack(blob[:n_frag].reshape(3 * NBLK, 2048))
    o = n_frag
    wp = blob[o:o + 4 * W].reshape(W, 4)
    o += 4 * W
    bc, b0, b1 = (blob[o + i * NBLK * W:o + (i + 1) * NBLK * W].reshape(NBLK, W)
                  for i in range(3))
    o += 3 * NBLK * W
    w_out, b_out = blob[o:o + W], blob[o + W]
    p, f = p_cn.T, f_cn.T
    net = p @ wp[:, :3].T + wp[:, 3]
    if sel is not None:
        gproj = blob[o + W + 4:].reshape(-1, W)
        net = net + torch.where(sel[:, None] >= 0, gproj[sel.clamp(min=0)], 0.0)
    if c_img_cn is not None:
        img_hi, img_lo = _unpack(blob[o + W + 4:].reshape(1, 2048))
        net = net + _product(c_img_cn.T, img_hi[0], img_lo[0])
    for b in range(NBLK):
        net = net + (bc[b] + _product(f, w_hi[3 * b], w_lo[3 * b]))
        h = b0[b] + _product(torch.relu(net), w_hi[3 * b + 1], w_lo[3 * b + 1])
        net = net + (b1[b] + _product(torch.relu(h), w_hi[3 * b + 2], w_lo[3 * b + 2]))
    return torch.relu(net) @ w_out + b_out


@pytest.mark.parametrize("variant", ["coords", "c_img"])
def test_packed_chain_matches_trunk(flagship, variant):
    """The 3xTF32 chain through the packed blob against the IEEE f32 trunk
    of both packages."""
    params, tdec = flagship
    with_img = variant == "c_img"
    rng = np.random.default_rng(11)
    N = 4096
    p = rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32)
    f = rng.standard_normal((W, N)).astype(np.float32)
    ci = rng.standard_normal((W, N)).astype(np.float32) if with_img else None
    tp = FT.extract_trunk_params(tdec, with_img=with_img)
    blob, w_img = K.pack_window_params(tp, with_img=with_img, img_rows=with_img)
    assert (w_img is None) != with_img
    assert blob.numel() == (3 * NBLK + with_img) * 2048 + 4 * W + 3 * NBLK * W + W + 4
    with torch.no_grad():
        got = _emulated_chain(blob, T(p), T(f), None if ci is None else T(ci))
        want = FT.trunk_cn(tp, T(p), T(f), None if ci is None else T(ci))
    jtp = JFT.extract_trunk_params(params, NBLK, with_img=with_img)
    jwant = np.asarray(JFT.trunk_cn(jtp, jnp.asarray(p), jnp.asarray(f),
                                    None if ci is None else jnp.asarray(ci)))
    assert float(want.abs().max()) > 1.0          # logits of order one
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-5, rtol=0)


def test_packed_layout(flagship):
    """Every packed value is a TF32 number (13 low mantissa bits zero), hi
    + lo gives each weight to 2^-22 of itself, the core-matrix order puts
    W[8nb + r][8jk + 2e + kb] at (part, jk, nb, kb, r, e), and the small
    section is in natural order."""
    _, tdec = flagship
    tp = FT.extract_trunk_params(tdec, with_img=False)
    blob, _ = K.pack_window_params(tp, with_img=False)
    prods = blob[:3 * NBLK * 2048].reshape(3 * NBLK, 2048)
    assert torch.all(prods.view(torch.int32) & 0x1FFF == 0)
    w = torch.stack([m for (wc, _), blk in zip(tp["fc_c"], tp["blocks"])
                     for m in (wc, blk[0], blk[2])])
    hi, lo = _unpack(prods)
    assert torch.all((hi.double() + lo.double() - w.double()).abs()
                     <= 2.0 ** -22 * w.double().abs())
    jk, nb, kb, r, e = 3, 2, 1, 5, 2
    at = (((jk * 4 + nb) * 2 + kb) * 8 + r) * 4 + e
    assert prods[4, at] == K.tf32_rna(w[4, 8 * nb + r, 8 * jk + 2 * e + kb])
    assert prods[4, 1024 + at] == K.tf32_rna(
        w[4, 8 * nb + r, 8 * jk + 2 * e + kb] - prods[4, at])
    o = 3 * NBLK * 2048
    w_in, b_in = tp["fc_p"]
    np.testing.assert_array_equal(blob[o:o + 4 * W].reshape(W, 4)[:, 3].numpy(),
                                  b_in.numpy())
    np.testing.assert_array_equal(blob[o:o + 4 * W].reshape(W, 4)[:, :3].numpy(),
                                  w_in.numpy())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_window_operands(flagship, mode):
    """What the wrapper hands window.cu in each mode, packed from inference
    tensors as eval_points makes them: the blob is pack_window_params's,
    followed in the gated mode by W_img g_f per finger; the contacts are
    the (F K, 4) rows (q, |q|²) in finger order with -1 on invalid rows."""
    _, tdec = flagship
    rng = np.random.default_rng(2)
    q = T(rng.uniform(-0.4, 0.4, (5, 8, 3)).astype(np.float32))
    feat = T(rng.standard_normal((5, W)).astype(np.float32))
    valid = T(rng.random((5, 8)) > 0.3)
    with torch.inference_mode():
        tp = FT.extract_trunk_params(tdec, with_img=mode != 0)
        blob, contacts = K._window_operands(
            tp, mode, (q.clone(), feat.clone(), valid.clone()) if mode == 2 else None)
    want, w_img = K.pack_window_params(tp, with_img=mode != 0, img_rows=mode == 1)
    assert blob.numel() % 4 == 0
    assert torch.equal(blob[:want.numel()], want)
    if mode != 2:
        assert blob.numel() == want.numel() and contacts is None
        return
    torch.testing.assert_close(blob[want.numel():].reshape(5, W), feat @ w_img.T,
                               rtol=0, atol=0)
    assert contacts.shape == (40, 4) and contacts.is_contiguous()
    assert torch.equal(contacts[:, :3], q.reshape(40, 3))
    v = valid.reshape(-1)
    assert torch.equal(contacts[v, 3], torch.sum(q.reshape(40, 3)[v] ** 2, dim=1))
    assert torch.all(contacts[~v, 3] == -1)


def _gate(rng, n_f=5, K_=8):
    q = T(rng.uniform(-0.4, 0.4, (n_f, K_, 3)).astype(np.float32))
    feat = T(rng.standard_normal((n_f, W)).astype(np.float32))
    valid = T(rng.random((n_f, K_)) > 0.3)
    return q, feat, valid


@pytest.mark.parametrize("store", [None, torch.bfloat16])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_trunk_operands(flagship, mode, store):
    """What the K1/K2 wrappers hand csrc/trunk.cu, packed from inference
    tensors as eval_points makes them: the blob and contacts of
    _window_operands in the same mode, and the coords, features and c_img
    rows contiguous in the storage type, channels first."""
    _, tdec = flagship
    rng = np.random.default_rng(3)
    N = 77
    p = T(rng.uniform(-0.55, 0.55, (3, N)).astype(np.float32))
    f = T(rng.standard_normal((N, W)).astype(np.float32)).T     # strided
    ci = T(rng.standard_normal((W, N)).astype(np.float32)) if mode == 1 else None
    gate = _gate(rng) if mode == 2 else None
    with torch.inference_mode():
        tp = FT.extract_trunk_params(tdec, with_img=mode != 0)
        blob, contacts, (x, fs, cs) = K._trunk_operands(
            tp, p.clone(), f.clone(), None if ci is None else ci.clone(),
            None if gate is None else tuple(t.clone() for t in gate),
            store_dtype=store)
    want_blob, want_contacts = K._window_operands(tp, mode, gate)
    assert torch.equal(blob, want_blob)
    assert (contacts is None) == (mode != 2)
    if mode == 2:
        assert torch.equal(contacts, want_contacts)
    assert (cs is None) == (mode != 1)
    for got, src in ((x, p), (fs, f), (cs, ci)):
        if src is None:
            continue
        assert got.dtype == (store or torch.float32) and got.is_contiguous()
        assert got.shape == src.shape and torch.equal(got.float(), K._stored(src, store))


@pytest.mark.parametrize("variant", ["coords_bf16", "c_img", "c_img_bf16", "gated"])
def test_trunk_operands_through_chain(flagship, variant):
    """K1/K2's operands through the emulated 3xTF32 chain against the port's
    trunk_cn on the stored values and the JAX package's Pallas kernel in
    interpret mode, within 1e-5; bf16 values are exact in TF32, so their
    split loses nothing. The gated case leaves out the points within 1e-6
    of r² for some contact, which the packages may round either way."""
    params, tdec = flagship
    rng = np.random.default_rng(12)
    N, radius = 1000, 0.05
    store = torch.bfloat16 if variant.endswith("bf16") else None
    with_img = variant != "coords_bf16"
    p = rng.uniform(-0.45, 0.45, (3, N)).astype(np.float32)
    f = rng.standard_normal((W, N)).astype(np.float32)
    ci = rng.standard_normal((W, N)).astype(np.float32) if variant.startswith("c_img") else None
    q, valid = _contacts_near(rng, p, K_=16, spread=0.03)
    feat = rng.standard_normal((5, W)).astype(np.float32)
    gate = (T(q), T(feat), T(valid)) if variant == "gated" else None
    tp = FT.extract_trunk_params(tdec, with_img=with_img)
    blob, _, (x, fs, cs) = K._trunk_operands(
        tp, T(p), T(f), None if ci is None else T(ci), gate, store_dtype=store)
    x, fs = x.float(), fs.float()
    cs = None if cs is None else cs.float()
    sel = None
    keep = np.ones(N, bool)
    if gate is not None:
        hit = (_kernel_d2(x.numpy(), q) < np.float32(radius * radius)).numpy()
        hit = (hit & valid.reshape(1, -1)).reshape(N, 5, -1).any(axis=2)
        last = np.where(hit.any(axis=1), 4 - np.argmax(hit[:, ::-1], axis=1), -1)
        sel = torch.as_tensor(last)
        assert (last >= 0).sum() > 50                  # many points gated
        d2 = FT.contact_sq_dist(x, T(q), T(valid)).numpy()
        keep = ~(np.abs(d2 - radius * radius) < 1e-6).any(axis=0)
        assert (~keep).sum() <= 5
    with torch.no_grad():
        got = _emulated_chain(blob, x, fs, cs, sel)
        c_img = FT.gate_contact_cn(x, *gate, radius) if gate is not None else cs
        want = FT.trunk_cn(tp, x, fs, c_img)
    jtp = JFT.extract_trunk_params(params, NBLK, with_img=with_img)
    jstore = None if store is None else jnp.bfloat16
    if gate is None:
        jwant = j_fused_trunk_cn(j_pack(jtp, with_img=with_img), jnp.asarray(p),
                                 jnp.asarray(f), None if ci is None else jnp.asarray(ci),
                                 tile=128, interpret=True, store_dtype=jstore)
    else:
        jwant = j_fused_trunk_gated_cn(
            j_pack(jtp, with_img=True), jnp.asarray(p), jnp.asarray(f),
            jnp.asarray(q), jnp.asarray(feat), jnp.asarray(valid), radius=radius,
            tile=128, interpret=True)
    assert float(want.abs().max()) > 1.0
    np.testing.assert_allclose(got.numpy()[keep], want.numpy()[keep], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(jwant)[keep], atol=1e-5,
                               rtol=0)


# -- the contact culling -----------------------------------------------------

def _points(rng, N, order):
    p = rng.uniform(-0.6, 0.6, (3, N)).astype(np.float32)
    if order == "sorted":
        keys = supercell_keys(T(p), 64, 0.1, 1).numpy()
        p = p[:, np.argsort(keys, kind="stable")]
    return np.ascontiguousarray(p)


def _contacts_near(rng, p, K_=128, spread=0.01):
    """Five fingers of K_ contacts each, most near query points (so many
    points are gated), some uniform, 30 % invalid."""
    n = p.shape[1]
    q = p[:, rng.integers(0, n, (5, K_))].transpose(1, 2, 0)
    q = q + spread * rng.standard_normal(q.shape)
    q[:, ::4] = rng.uniform(-0.4, 0.4, (5, len(range(0, K_, 4)), 3))
    valid = rng.random((5, K_)) > 0.3
    return q.astype(np.float32), valid


def _kernel_d2(p, q):
    """(N, F K) squared distances as window.cu's contact test rounds them,
    one step at a time (torch's elementwise ops round each one)."""
    p, q = T(p), T(q).reshape(-1, 3)
    p2 = (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]
    q2 = torch.sum(q * q, dim=1)
    dot = (p[0][:, None] * q[:, 0] + p[1][:, None] * q[:, 1]) + p[2][:, None] * q[:, 2]
    return (q2[None, :] + p2[:, None]) - 2.0 * dot


def _decisions_kept(p, q, valid, cand):
    """Asserts that culling loses no hit: every (point, contact) pair within
    the radius by the kernel's arithmetic is a candidate of the point's tile,
    and gate_contact_cn per tile decides the same with and without the
    restriction. Returns the number of gated points."""
    N = p.shape[1]
    tile_of = np.arange(N) // TILE
    hit = (_kernel_d2(p, q) < np.float32(RADIUS * RADIUS)).numpy() & valid.reshape(1, -1)
    assert not np.any(hit & ~cand[tile_of].reshape(N, -1).numpy())
    feat = T(np.random.default_rng(5).standard_normal((5, W)).astype(np.float32))
    gated = 0
    for s in range(0, N, TILE):
        pt = T(p[:, s:s + TILE])
        full = FT.gate_contact_cn(pt, T(q), feat, T(valid), RADIUS)
        culled = FT.gate_contact_cn(pt, T(q), feat, T(valid) & cand[s // TILE], RADIUS)
        assert torch.equal(full, culled)
        gated += int(torch.any(full != 0, dim=0).sum())
    return gated


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("spread", [0.01, 0.3])
def test_candidates_keep_every_decision(order, spread):
    rng = np.random.default_rng(3)
    p = _points(rng, 8192, order)
    q, valid = _contacts_near(rng, p, spread=spread)
    cand = K.window_gate_candidates(T(p), T(q), T(valid), RADIUS)
    assert cand.shape == (8192 // TILE, 5, 128) and cand.dtype == torch.bool
    assert not torch.any(cand & ~T(valid))
    gated = _decisions_kept(p, q, valid, cand)
    assert gated > (100 if spread < 0.1 else 0)
    per_tile = cand.sum(dim=(1, 2)).float().mean()
    if order == "sorted":      # sorted tiles are short runs of cells
        assert per_tile < 0.1 * valid.sum()
    else:                      # unsorted tiles span the box
        assert per_tile > 0.5 * valid.sum()


def test_candidates_keep_box_edge_contacts():
    """Contacts r (1 +- 1e-6) outside each face of a tile's box, r (1 +- 1e-6)
    out along the diagonal of its corners, and on its corners are kept for
    that tile; contacts 2r out are dropped."""
    rng = np.random.default_rng(4)
    p = _points(rng, 4 * TILE, "sorted")
    boxes = p.reshape(3, 4, TILE)
    lo, hi = boxes.min(axis=2).astype(np.float64), boxes.max(axis=2).astype(np.float64)
    near, far = [], []
    for ti in range(4):
        mid = (lo[:, ti] + hi[:, ti]) / 2
        for s in (1 + 1e-6, 1 - 1e-6):
            for axis in range(3):
                up, down = mid.copy(), mid.copy()
                up[axis] = hi[axis, ti] + RADIUS * s
                down[axis] = lo[axis, ti] - RADIUS * s
                near += [(ti, up), (ti, down)]
            near.append((ti, hi[:, ti] + RADIUS * s / np.sqrt(3)))
            near.append((ti, lo[:, ti] - RADIUS * s / np.sqrt(3)))
        near += [(ti, hi[:, ti]), (ti, lo[:, ti])]
        far.append((ti, hi[:, ti] + np.array([2 * RADIUS, 0, 0])))
    q = np.array([c for _, c in near + far], np.float32)
    K_ = len(q)
    q = np.tile(q[None], (5, 1, 1))
    valid = np.ones((5, K_), bool)
    cand = K.window_gate_candidates(T(p), T(q), T(valid), RADIUS).numpy()
    for k, (ti, _) in enumerate(near):
        assert cand[ti, :, k].all(), (ti, k)
    for k, (ti, _) in enumerate(far, start=len(near)):
        assert not cand[ti, :, k].any()
    _decisions_kept(p, q, valid, torch.as_tensor(cand))


@pytest.mark.parametrize("N", [1, 77, TILE, 3 * TILE + 5])
def test_candidates_ragged_and_small(N):
    """A ragged last tile (and N < T) boxes its real points only."""
    rng = np.random.default_rng(N)
    p = _points(rng, N, "sorted")
    q, valid = _contacts_near(rng, p, K_=16, spread=0.02)
    cand = K.window_gate_candidates(T(p), T(q), T(valid), RADIUS)
    n_tiles = -(-N // TILE)
    assert cand.shape == (n_tiles, 5, 16)
    last = p[:, (n_tiles - 1) * TILE:]
    want = K.window_gate_candidates(T(last), T(q), T(valid), RADIUS, tile=last.shape[1])
    assert torch.equal(cand[-1], want[0])
    _decisions_kept(p, q, valid, cand)


def test_candidates_on_mesh_lattice_rows():
    """The mesh path's own order: dense_query_grid_cn at nx = 128 makes each
    tile one x-row at fixed (y, z), a segment. With contacts clustered as a
    fingertip's, most rows keep no contact, those through the cluster keep
    a few, and no gate decision changes (two z-planes: one through the
    cluster, one far from it)."""
    nx = TILE
    grid = dense_query_grid_cn(nx, 1.1, device="cpu")
    planes = [int(np.argmin(np.abs(grid[2, ::nx * nx].numpy() - z))) for z in (0.2, -0.3)]
    p = torch.cat([grid[:, i * nx * nx:(i + 1) * nx * nx] for i in planes], dim=1)
    rows = p.reshape(3, -1, TILE)
    assert torch.all(rows[1:].amax(2) == rows[1:].amin(2))     # a tile is an x-row
    rng = np.random.default_rng(8)
    q = (0.2 + 0.05 * rng.standard_normal((5, 128, 3))).astype(np.float32)
    valid = rng.random((5, 128)) > 0.3
    cand = K.window_gate_candidates(p, T(q), T(valid), RADIUS)
    kept = cand.sum(dim=(1, 2))
    assert float((kept == 0).float().mean()) > 0.7
    assert int(kept[:nx].max()) > 0 and int(kept[nx:].max()) == 0
    assert int(kept.max()) < 0.1 * valid.sum()
    assert _decisions_kept(p.numpy(), q, valid, cand) > 0


def test_candidates_keep_box_edge_set():
    """window_box_edge_contacts, the card checks' probe of the margin: each
    contact lies r (1 +- 1e-6) from some tile's box and is kept there, and
    no gate decision changes."""
    rng = np.random.default_rng(6)
    p = _points(rng, 16 * TILE, "sorted")
    q = K.window_box_edge_contacts(T(p), seed=7, K=32, radius=RADIUS)
    assert q.shape == (5, 32, 3) and q.dtype == torch.float32
    valid = np.ones((5, 32), bool)
    cand = K.window_gate_candidates(T(p), q, T(valid), RADIUS)
    assert torch.all(cand.any(dim=0))
    _decisions_kept(p, q.numpy(), valid, cand)
