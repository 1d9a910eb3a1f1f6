"""The arbitrary-point decode of the port against the JAX package, on the
CPU: super-cell keys and scattered features (bit for bit, and to 1e-6),
the plain version of the window trunk (K3/K4) against the Pallas kernel in
interpret mode (as tests/test_fast_decode.py:922-1087 runs it), the window
plan, and ``eval_points`` / ``eval_points_fast`` on every route.

The window kernel sums the trilinear corners through hat weights, z first;
the port's plain version sums them x first, as the JAX gather route does;
the JAX package allows 2e-5 between the two (test_fast_decode.py:962), and
so do these tests. Contact gating compares an expanded squared distance
with r²; points within 1e-6 of r² for some valid contact may round to the
other side and are left out (their count is asserted small). The window
kernel itself runs only on the card (tests/test_torch_cuda.py).
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
    fused_trunk_window_cn as j_window,
    pack_trunk_params as j_pack,
)
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork as TNet
from vtaco_tpu_torch.ops import dense_decode as TD
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import decode as K

from test_torch_trunk import C, HID, NB, T, _decoders, _tp

PADDING = 0.1
ATOL = 2e-5


@pytest.fixture(scope="module")
def dec():
    return _decoders()


def _near_radius(p_cn, gate_pts, gate_valid, radius=0.015):
    d2 = FT.contact_sq_dist(T(p_cn), T(gate_pts), T(gate_valid)).numpy()
    return (np.abs(d2 - radius * radius) < 1e-6).any(axis=0)


def _contacts(rng, K_=8, spread=0.3, case="invalid_rows"):
    q = rng.uniform(-spread, spread, (5, K_, 3)).astype(np.float32)
    feat = rng.standard_normal((5, C)).astype(np.float32)
    valid = rng.random((5, K_)) > 0.3
    if case == "all_invalid":
        valid[:] = False
    return q, feat, valid


# -- keys and features ------------------------------------------------------

@pytest.mark.parametrize("L", [1, 2])
def test_supercell_keys_match_jax(rng, L):
    R = 17                                   # odd: n1 = ceil((R-1)/L)
    p = rng.uniform(-0.62, 0.62, (3, 50_000)).astype(np.float32)
    # points on cell faces and the box border, where a floor can tip over
    p[:, :64] = np.linspace(-0.55, 0.55, 64, dtype=np.float32)
    want = np.asarray(JD.supercell_keys(jnp.asarray(p), R, PADDING, L))
    got = TD.supercell_keys(T(p), R, PADDING, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(TD.supercell_base_coords(T(p), R, PADDING),
                    JD.supercell_base_coords(jnp.asarray(p), R, PADDING)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", [(17, 17, 17), (9, 11, 13)])
def test_scattered_grid_features_match_jax(rng, shape):
    g = rng.standard_normal(shape + (C,)).astype(np.float32)
    p = rng.uniform(-0.62, 0.62, (3, 20_000)).astype(np.float32)
    want = JD.scattered_grid_features_cn(jnp.asarray(g), jnp.asarray(p), PADDING)
    got = TD.scattered_grid_features_cn(T(g), T(p), PADDING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# -- the window trunk: plain version against the Pallas kernel --------------

def _sorted_points(rng, R, L, N):
    p = rng.uniform(-0.62, 0.62, (3, N)).astype(np.float32)
    keys = np.asarray(JD.supercell_keys(jnp.asarray(p), R, PADDING, L))
    return p[:, np.argsort(keys, kind="stable")]


CASES = ["coords", "c_img", "gated_invalid_rows", "gated_all_invalid",
         "gated_odd_N"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("L,S", [(1, 512), (2, 64), (1, 8)])
def test_window_trunk_matches_pallas(rng, dec, case, L, S):
    """(L, S) = (1, 512) and (2, 64) fit every tile's window; (1, 8) is
    undersized, and both count the same overflow."""
    R, tile = 17, 256
    N = 4000 if case == "gated_odd_N" else 4096
    g = rng.standard_normal((R, R, R, C)).astype(np.float32)
    p = _sorted_points(rng, R, L, N)
    gated = case.startswith("gated")
    jtp, ttp = _tp(dec, with_img=case != "coords")
    ci = rng.standard_normal((C, N)).astype(np.float32) if case == "c_img" else None
    gate = None
    if gated:
        gate = _contacts(rng, case="all_invalid" if case.endswith("all_invalid")
                         else "invalid_rows")
    # the TPU kernel takes whole tiles: pad with copies of the last point
    pad = (-N) % tile
    pj = np.concatenate([p, np.repeat(p[:, -1:], pad, axis=1)], axis=1)
    vol, n1 = JD.supercell_packed_volume(jnp.asarray(g), S, L)
    kw = dict(reso=R, padding=PADDING, L=L, S=S, tile=tile)
    jkw = {}
    if gated:
        jkw = dict(gate_pts=jnp.asarray(gate[0]), gate_feat=jnp.asarray(gate[1]),
                   gate_valid=jnp.asarray(gate[2]))
    elif ci is not None:
        jkw = dict(c_img_cn=jnp.asarray(np.concatenate(
            [ci, np.repeat(ci[:, -1:], pad, axis=1)], axis=1)))
    want, j_over = j_window(j_pack(jtp, with_img=case != "coords"), vol,
                            jnp.asarray(pj), n1=n1, interpret=True, **kw, **jkw)
    want = np.asarray(want)[:N]

    tkw = {}
    if gated:
        tkw = dict(gate_pts=T(gate[0]), gate_feat=T(gate[1]), gate_valid=T(gate[2]))
    elif ci is not None:
        tkw = dict(c_img_cn=T(ci))
    keys = torch.empty(N, dtype=torch.int32)
    with torch.no_grad():
        got, t_over = K.fused_trunk_window_cn(ttp, T(g), T(p), keys_out=keys,
                                              **kw, **tkw)
    assert got.shape == (N,) and got.dtype == torch.float32
    assert int(t_over) == int(j_over)
    assert (int(t_over) > 0) == (S == 8)
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(JD.supercell_keys(jnp.asarray(p), R, PADDING, L)))
    if S == 8:
        return                       # the TPU kernel's logits are clamped garbage
    keep = np.ones(N, bool)
    if gated:
        keep = ~_near_radius(p, *gate[::2])
        assert (~keep).sum() <= 3
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=ATOL, rtol=0)
    assert K.fused_trunk_window_cn.launches == 0
    assert K.fused_trunk_window_cn.launches_gated == 0


def test_window_overflow_pads_ragged_tile():
    """A ragged last tile counts as the JAX package's padded one."""
    keys = torch.tensor([0, 1, 2, 100, 701], dtype=torch.int32)
    assert int(TD.window_overflow(keys, 4, 128, 10)) == 0
    keys = torch.tensor([0, 1, 2, 300, 5, 5, 5, 900], dtype=torch.int32)
    assert int(TD.window_overflow(keys, 4, 128, 10)) == 2
    assert int(TD.window_overflow(keys[:7], 4, 128, 10)) == 1
    assert TD.window_blocks(17, 1, 8) == 16 ** 3 // 8
    assert TD.window_blocks(17, 2, 64) == 8 ** 3 // 64
    assert TD.window_blocks(5, 1, 128) == 2             # at least 2S columns


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("n,spread", [(1 << 18, 0.54), (100_000, 0.54),
                                      (5_000, 0.54), (20_000, 0.1)])
def test_window_plan_matches_jax(n, spread):
    """A dense, a sparse, a too-sparse and a clustered set on the 64³ grid
    plan the same (L, tile) and sort order as the JAX package, or none."""
    R = 64
    rng = np.random.default_rng(n)
    pf = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    jgen = JGen(None, padding=PADDING)
    tgen = TGen(None, padding=PADDING)
    want = jgen._window_plan(pf, R, n, ("test",))
    got = tgen._window_plan(torch.as_tensor(np.ascontiguousarray(pf.T)), R)
    if want is None:
        assert got is None
        return
    assert got is not None and got[:2] == want[:2], (got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), want[3])


def test_chip_smoke_sets_plan_as_jax():
    """chip_smoke.py's eval_points sets (a), (b) and (d) from seed 7: the
    JAX package plans (a) at L = 1, tile 256, finds no plan for (b), which
    takes the gather route, and plans (d) at L = 2, tile 256; the port
    plans them the same."""
    rng = np.random.default_rng(7)
    sets = [rng.uniform(-0.54, 0.54, (n, 3)).astype(np.float32)
            for n in (1 << 21, 100_000, 1 << 19)]
    jgen, tgen = JGen(None, padding=PADDING), TGen(None, padding=PADDING)
    plans = []
    for pf in sets:
        want = jgen._window_plan(pf, 64, len(pf), ("test",))
        got = tgen._window_plan(torch.as_tensor(np.ascontiguousarray(pf.T)), 64)
        assert (got is None) == (want is None)
        plans.append(None if got is None else got[:2])
        if got is not None:
            assert got[:2] == want[:2]
            np.testing.assert_array_equal(got[2].numpy(), want[3])
    assert plans == [(1, 256), None, (2, 256)]


# -- eval_points: every route ------------------------------------------------

R_GRID = 17


@pytest.fixture(scope="module")
def gens(dec):
    """(JAX generator, its state, port generator, port model, the grid as
    a JAX and a port field). The decoder at test_torch_trunk's widths."""
    params, tdec = dec
    jmodel = JNet(decoder=JDecoder(c_dim=C, hidden_size=HID, n_blocks=NB))

    class State:
        batch_stats = {}

    State.params = {"decoder": params}
    jgen = JGen(jmodel, padding=PADDING)
    jgen.window_interpret = True
    tmodel = TNet(decoder=tdec)
    tgen = TGen(tmodel, padding=PADDING)
    g = np.random.default_rng(3).standard_normal(
        (1, R_GRID, R_GRID, R_GRID, C)).astype(np.float32)
    return jgen, State(), tgen, tmodel, {"grid": jnp.asarray(g)}, {"grid": T(g)}


class Routes:
    """Counts the routes a port generator takes."""

    def __init__(self, gen, monkeypatch):
        self.n = {"window": 0, "gather": 0, "dense": 0}
        for name, attr in (("window", "_decode_scatter_window_impl"),
                           ("gather", "_decode_scatter_fast_impl"),
                           ("dense", "_decode_dense_fast_impl")):
            monkeypatch.setattr(gen, attr, self._count(name, getattr(gen, attr)))

    def _count(self, name, fn):
        def wrapped(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return wrapped


def _jax_window_calls(jgen, monkeypatch):
    calls = []
    orig = jgen._decode_scatter_window

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jgen, "_decode_scatter_window", spy)
    return calls


def _gates(rng, mode):
    if mode == "none":
        return "none", (None, None, None), (None, None, None)
    q, feat, valid = _contacts(rng, spread=0.3)
    return ("contact", (jnp.asarray(q), jnp.asarray(feat), jnp.asarray(valid)),
            (T(q), T(feat), T(valid)))


@pytest.mark.parametrize("mode", ["none", "contact"])
@pytest.mark.parametrize("entry", ["eval_points_fast", "eval_points",
                                   "eval_points_sliced"])
def test_eval_points_window_route_matches_jax(rng, gens, monkeypatch, mode, entry):
    """Random f32 points take the window route on both sides (the JAX one
    through its Pallas kernel in interpret mode); eval_points slices its
    input above scatter_slice_points."""
    jgen, state, tgen, tmodel, jc, tc = gens
    n = 3000
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    gating, jg, tg = _gates(rng, mode)
    routes = Routes(tgen, monkeypatch)
    jcalls = _jax_window_calls(jgen, monkeypatch)
    if entry == "eval_points_sliced":
        monkeypatch.setattr(jgen, "scatter_slice_points", 1500)
        monkeypatch.setattr(tgen, "scatter_slice_points", 1500)
    if entry == "eval_points_fast":
        want = jgen.eval_points_fast(state, pts, jc, gating, *jg,
                                     transfer_dtype=jnp.float32, use_pallas=True)
        got = tgen.eval_points_fast(tmodel, pts, tc, gating, *tg,
                                    transfer_dtype=torch.float32)
    else:
        monkeypatch.setattr(jgen, "use_pallas", True)
        want = jgen.eval_points(state, pts, jc, gating, *jg,
                                transfer_dtype=jnp.float32)
        got = tgen.eval_points(tmodel, pts, tc, gating, *tg,
                               transfer_dtype=torch.float32)
    n_calls = 2 if entry == "eval_points_sliced" else 1
    assert len(jcalls) == n_calls
    assert routes.n == {"window": n_calls, "gather": 0, "dense": 0}
    keep = np.ones(n, bool)
    if mode == "contact":
        keep = ~_near_radius(pts.T, *tg[::2])
        assert (~keep).sum() <= 3
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def _lattice_sets(rng):
    box = 1 + PADDING
    nx = 9
    c = box * (-0.5 + np.arange(nx, dtype=np.float32) / (nx - 1))
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    xmajor = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1).astype(np.float32)
    zmajor = np.stack([gz.ravel(), gy.ravel(), gx.ravel()], 1)  # x fastest
    R = 40
    lat = rng.integers(0, R + 1, (2000, 3))
    return {
        "cube_xmajor": (xmajor, {}, "dense"),
        "cube_zmajor": (zmajor.astype(np.float32), {}, "dense"),
        "lattice_f32_shuffled": (
            (box * (lat / R - 0.5)).astype(np.float32), {}, "gather"),
        "lattice_int16": (rng.integers(0, 301, (1500, 3)).astype(np.int16),
                          {"lattice_reso": 300}, "gather"),
        "coord_quant": (rng.uniform(-0.6, 0.6, (1500, 3)).astype(np.float32),
                        {"coord_quant": True}, "window"),
        "too_sparse": (rng.uniform(-0.6, 0.6, (40, 3)).astype(np.float32), {},
                       "window"),
    }


@pytest.mark.parametrize("mode", ["none", "contact"])
@pytest.mark.parametrize("name", ["cube_xmajor", "cube_zmajor",
                                  "lattice_f32_shuffled", "lattice_int16",
                                  "coord_quant"])
def test_eval_points_other_routes_match_jax(rng, gens, monkeypatch, mode, name):
    """Complete cubes (both orders), lattices (detected f32, explicit
    int16) and uint16-quantized coords, against the JAX package with its
    XLA trunk (use_pallas=False), on the route the JAX package takes with
    its kernels on."""
    jgen, state, tgen, tmodel, jc, tc = gens
    pts, kw, route = _lattice_sets(rng)[name]
    gating, jg, tg = _gates(rng, mode)
    routes = Routes(tgen, monkeypatch)
    want = jgen.eval_points_fast(state, pts, jc, gating, *jg,
                                 transfer_dtype=jnp.float32, use_pallas=False,
                                 **kw)
    got = tgen.eval_points_fast(tmodel, pts, tc, gating, *tg,
                                transfer_dtype=torch.float32, **kw)
    assert routes.n[route] == 1 and sum(routes.n.values()) == 1, routes.n
    world = pts
    if "lattice_reso" in kw:
        world = (1 + PADDING) * (pts / kw["lattice_reso"] - 0.5)
    keep = np.ones(len(pts), bool)
    if mode == "contact":
        keep = ~_near_radius(np.asarray(world, np.float32).T, *tg[::2])
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_eval_points_sparse_and_overflow_take_gather_route(rng, gens, monkeypatch):
    """A set too sparse for any window plan, and a window decode whose
    kernel reports an overflow, both end on the gather route."""
    jgen, state, tgen, tmodel, jc, tc = gens
    sparse = _lattice_sets(rng)["too_sparse"][0]
    tgen_big = TGen(tmodel, padding=PADDING)
    big = {"grid": T(np.tile(np.asarray(tc["grid"]), (1, 4, 4, 4, 1)))}
    assert tgen_big._window_plan(T(np.ascontiguousarray(sparse.T)), 68) is None
    routes = Routes(tgen_big, monkeypatch)
    tgen_big.eval_points_fast(tmodel, sparse, big, transfer_dtype=torch.float32)
    assert routes.n == {"window": 0, "gather": 1, "dense": 0}

    pts = rng.uniform(-0.6, 0.6, (3000, 3)).astype(np.float32)
    want = jgen.eval_points_fast(state, pts, jc, transfer_dtype=jnp.float32,
                                 use_pallas=False)
    orig = tgen._decode_scatter_window_impl

    def overflowing(*a, **k):
        logits, _ = orig(*a, **k)
        return logits, torch.ones((), dtype=torch.int64)

    monkeypatch.setattr(tgen, "_decode_scatter_window_impl", overflowing)
    routes = Routes(tgen, monkeypatch)
    got = tgen.eval_points_fast(tmodel, pts, tc, transfer_dtype=torch.float32)
    assert routes.n == {"window": 1, "gather": 1, "dense": 0}
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_eval_points_empty_and_unported(gens):
    """Empty query sets; and ``fast=False``, the chunked legacy decode,
    equal to the JAX package's."""
    jgen, state, tgen, tmodel, jc, tc = gens
    empty = np.zeros((0, 3), np.float32)
    assert tgen.eval_points_fast(tmodel, empty, tc).shape == (0,)
    assert tgen.eval_points(tmodel, empty, tc).shape == (0,)
    assert np.asarray(jgen.eval_points_fast(state, empty, jc,
                                            use_pallas=False)).shape == (0,)
    pts = np.random.default_rng(5).uniform(-0.6, 0.6, (10, 3)).astype(np.float32)
    want = jgen.eval_points(state, pts, jc, transfer_dtype=jnp.float32, fast=False)
    got = tgen.eval_points(tmodel, pts, tc, transfer_dtype=torch.float32, fast=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_coord_quant_config():
    from test_torch_setup import port_cfg
    from vtaco_tpu_torch.core.config import get_generator, get_model

    cfg = port_cfg()
    model = get_model(cfg, device="cpu")
    assert get_generator(model, cfg).coord_quant is False       # 'auto'
    cfg["generation"]["coord_quant"] = True
    assert get_generator(model, cfg).coord_quant is True
    cfg["generation"]["coord_quant"] = "yes"
    with pytest.raises(ValueError):
        get_generator(model, cfg)
    cfg["generation"]["coord_quant"] = "auto"
    # crop volumes: the JAX package's
    cfg["data"].update(input_type="pointcloud_crop", unit_size=0.02, query_vol_size=25)
    gen, jgen = get_generator(model, cfg), JGen.from_config(None, cfg)
    assert gen.input_type == "pointcloud_crop"
    for a, b in zip(gen.input_vol, jgen.input_vol):
        np.testing.assert_array_equal(a, b)
    # sliding_window changes nothing that the crop decode reads
    cfg["generation"]["sliding_window"] = True
    for a, b in zip(get_generator(model, cfg).input_vol,
                    JGen.from_config(None, cfg).input_vol):
        np.testing.assert_array_equal(a, b)
