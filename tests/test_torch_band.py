"""The iso-band transfer of the PyTorch port (vtaco_tpu_torch/generate/band.py
and the Generator3D's band routes) against the JAX package's and against the
port's own full float32 transfer, on the CPU at small sizes.

``band_extract``'s payload equals the JAX package's bit for bit on the same
float32 fields (those of tests/test_band.py): count, packed bits and the
active values, for the 'midpoint' and 'const' levels; a 'mean' level sums
in another order (within 2 ulp), and the payload is bit-equal at that
level. The native reconstruction and the fused band scanner equal the
numpy reference and reconstruct-plus-scan.

The port's band grids and meshes equal its full float32 transfer bit for
bit (the band carries the same logits): ungated, contact-gated and
fingertip-gated, after an overflow, batched and through ``run_batched``.
Against the JAX package's band path the two packages' logits differ by a
few 1e-6 (as in tests/test_torch_generate.py), so its decoder's feature
conditioning is damped by FEATURE_GAIN, equal occupancy is asserted first,
and then the meshes' triangles are held to 1e-4 voxel.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.generate import band as JB
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu_torch import native
from vtaco_tpu_torch.core.config import get_generator
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate import band as TB
from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.generate.marching_cubes import marching_cubes

from test_band import _field
from test_torch_generate import FEATURE_GAIN
from test_torch_setup import CONTACTS_PER_FINGER, build_pair, make_batch

NX = 16


def jax_extract(vol, nx, cap, mode, const=0.1):
    out = jax.jit(lambda lf: JB.band_extract(lf, nx, cap, mode, const))(vol.reshape(-1))
    return [np.asarray(x) for x in jax.device_get(out)]


def port_extract(vol, nx, cap, mode, const=0.1):
    return [x.numpy() for x in TB.band_extract(torch.as_tensor(vol.reshape(-1)), nx, cap,
                                               mode, const)]


def assert_payload_equal(got, want, cap):
    (tc, tl, tp, tv), (jc, jl, jp, jv) = got, want
    n = min(int(jc), cap)
    assert int(tc) == int(jc) and np.array_equal(tp, jp)
    assert np.array_equal(tv[:n], jv[:n]) and tv.shape == jv.shape == (cap,)


@pytest.mark.parametrize("kind", ["sphere", "blobs", "noise"])
@pytest.mark.parametrize("mode", ["midpoint", "mean", "const"])
def test_band_extract_matches_jax(kind, mode):
    """count, level, bits and values bit for bit ('mean': the level within
    2 ulp, then the payload at that level); the noise field overflows its
    cap, and the count still says by how much."""
    nx = 25
    vol = _field(np.random.default_rng(3), nx, kind)
    cap = 4096 if kind == "noise" else 65536
    got = port_extract(vol, nx, cap, mode)
    want = jax_extract(vol, nx, cap, mode)
    if mode == "mean":
        assert abs(float(got[1]) - float(want[1])) <= 2 * abs(np.spacing(np.float32(want[1])))
        want = jax_extract(vol, nx, cap, "const", got[1])
    assert float(got[1]) == float(want[1])
    assert_payload_equal(got, want, cap)
    assert (int(got[0]) > cap) == (kind == "noise")
    occ = np.unpackbits(got[2], bitorder="little")[:nx ** 3].astype(bool)
    assert np.array_equal(occ, vol.reshape(-1) > got[1])


def test_band_payload_round_trip():
    """band_payload's one buffer splits back into the four results, and its
    size is payload_bytes (786,440 bytes at 128³ and the default cap)."""
    nx, cap = 17, 1000
    vol = _field(np.random.default_rng(4), nx, "sphere")
    parts = TB.band_extract(torch.as_tensor(vol.reshape(-1)), nx, cap, "midpoint")
    buf = TB.band_payload(*parts).numpy()
    assert buf.dtype == np.uint8 and buf.size == TB.payload_bytes(nx, cap)
    count, level, packed, vals = TB.band_unpack(buf, nx, cap)
    assert count == int(parts[0]) and level == float(parts[1])
    assert np.array_equal(packed, parts[2].numpy()) and np.array_equal(vals, parts[3].numpy())
    assert TB.payload_bytes(128, TB.default_cap(128)) == 786_440
    assert TB.default_cap(16) == 65536 == JB.default_cap(16)
    assert TB.default_cap(128) == JB.default_cap(128)


@pytest.mark.parametrize("kind", ["sphere", "blobs"])
def test_band_reconstruct_and_scanner(kind):
    """The native grid equals the numpy reference and the full grid's mesh;
    the fused band scanner equals reconstruct-plus-scan for both gradients;
    a count the mask does not imply raises in all three."""
    nx = 33
    vol = _field(np.random.default_rng(5), nx, kind)
    count, level, packed, vals = port_extract(vol, nx, 65536, "midpoint")
    count, level = int(count), float(level)
    grid = TB.band_reconstruct(nx, level, count, packed, vals)
    assert np.array_equal(grid, TB._band_reconstruct_numpy(nx, level, count, packed, vals))
    for grad in ("ascent", "descent"):
        v1, f1 = marching_cubes(grid, level=level, gradient=grad)
        v2, f2 = TB.band_marching_cubes(nx, level, count, packed, vals, gradient=grad)
        v3, f3 = marching_cubes(vol, level=level, gradient=grad)
        assert np.array_equal(v1, v2) and np.array_equal(f1, f2)
        assert np.array_equal(v1, v3) and np.array_equal(f1, f3)
    for fn in (TB.band_reconstruct, TB._band_reconstruct_numpy, TB.band_marching_cubes):
        with pytest.raises(ValueError, match="inconsistent"):
            fn(nx, level, count - 1, packed, vals)
    with pytest.raises(ValueError, match="cannot hold"):
        native.mc.band_reconstruct(nx, level, len(vals) + 1, packed, vals)


# ---------------------------------------------------------------------------
# the generator's band routes

class State:
    def __init__(self, v):
        self.params = v["params"]
        self.batch_stats = v["batch_stats"]


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, v, tmodel = build_pair()
    dec = v["params"]["decoder"]
    for name in dec:
        if name.startswith("fc_c"):
            dec[name]["kernel"] = dec[name]["kernel"] * FEATURE_GAIN
    load_jax_params(tmodel, v["params"], v["batch_stats"])
    data = make_batch(np.random.default_rng(0))
    c = tmodel.encode_inputs(torch.as_tensor(data["inputs"]))
    return cfg, jmodel, v, tmodel, {k: x.detach() for k, x in c.items()}, data["inputs"]


def gates(kind, rng, C):
    if kind == "none":
        return "none", None, None, None
    if kind == "tips":
        return ("tips", rng.uniform(-0.4, 0.4, (5, 3)).astype(np.float32),
                rng.standard_normal((5, C)).astype(np.float32), np.array([1, 1, 0, 1, 1], bool))
    return ("contact", rng.uniform(-0.3, 0.3, (5, 8, 3)).astype(np.float32),
            rng.standard_normal((5, C)).astype(np.float32), rng.random((5, 8)) > 0.3)


def triangles(verts, faces):
    tri = verts[faces].reshape(len(faces), 9).astype(np.float64)
    return tri[np.lexsort(tri.T[::-1])]


def assert_same_mesh_as_jax(t, j, t_grid, j_grid, level):
    """Equal occupancy first (a band grid's filler keeps every vertex's
    side of the level), then the same triangles to 1e-4 voxel."""
    assert np.array_equal(t_grid > level, j_grid > level), "occupancy differs"
    assert len(t[0]) == len(j[0]) and len(t[1]) == len(j[1])
    np.testing.assert_allclose(triangles(*t), triangles(*j), atol=1e-4)


@pytest.mark.parametrize("kind", ["none", "contact", "tips"])
def test_band_grid_and_mesh_equal_full_transfer(pair, kind):
    """eval_points_dense_band: its mesh equals marching cubes of the full
    float32 transfer at the same level bit for bit, grid and mesh=True
    alike, no overflow; against the JAX package's band path: the level to
    1e-6, the same occupancy (the port's float32 grid against JAX's band
    grid) and the same triangles."""
    cfg, jmodel, v, tmodel, c, _ = pair
    C_img = tmodel.decoder.fc_p_img.weight.shape[1] - 3
    g, gp, gf, gv = gates(kind, np.random.default_rng(6), C_img)
    tg = [None if a is None else torch.as_tensor(a) for a in (gp, gf, gv)]
    gen = get_generator(tmodel, copy.deepcopy(cfg), band_transfer=True)
    full = gen.eval_points_dense(tmodel, NX, c, g, *tg,
                                 transfer_dtype=torch.float32).reshape(NX, NX, NX)
    grid, level = gen.eval_points_dense_band(tmodel, NX, c, g, *tg)
    assert level == float(np.float32((float(full.min()) + float(full.max())) / 2))
    mesh = marching_cubes(full, level=level)
    assert all(np.array_equal(a, b) for a, b in zip(marching_cubes(grid, level=level), mesh))
    verts, faces, level2 = gen.eval_points_dense_band(tmodel, NX, c, g, *tg, mesh=True)
    assert level2 == level and np.array_equal(verts, mesh[0]) and np.array_equal(faces, mesh[1])
    assert gen.band_overflows == 0

    jgen = JGen(jmodel, resolution0=4, padding=0.1, band_transfer=True)
    jc = {k: jnp.asarray(x.numpy()) for k, x in c.items()}
    jg = [None if a is None else jnp.asarray(a) for a in (gp, gf, gv)]
    j_grid, j_level = jgen.eval_points_dense_band(State(v), NX, jc, g, *jg)
    assert abs(j_level - level) <= 1e-6
    assert_same_mesh_as_jax(mesh, marching_cubes(j_grid, level=level), full, j_grid, level)


def test_band_overflow_takes_full_transfer(pair):
    """cap=1: band_overflows counts 1, the grid is the full float32
    transfer itself and mesh=True meshes it; the JAX package likewise.
    ``inputs`` in place of the fields encodes first: the same band."""
    cfg, jmodel, v, tmodel, c, inputs = pair
    gen = get_generator(tmodel, copy.deepcopy(cfg), band_transfer=True)
    for a, b in zip(gen.eval_points_dense_band(tmodel, NX, c),
                    gen.eval_points_dense_band(tmodel, NX, inputs=inputs)):
        assert np.array_equal(a, b)
    full = gen.eval_points_dense(tmodel, NX, c, transfer_dtype=torch.float32)
    grid, level = gen.eval_points_dense_band(tmodel, NX, c, cap=1)
    assert gen.band_overflows == 1 and np.array_equal(grid.reshape(-1), full)
    verts, faces, _ = gen.eval_points_dense_band(tmodel, NX, c, cap=1, mesh=True)
    want = marching_cubes(full.reshape(NX, NX, NX), level=level)
    assert gen.band_overflows == 2
    assert np.array_equal(verts, want[0]) and np.array_equal(faces, want[1])
    jgen = JGen(jmodel, resolution0=4, padding=0.1, band_transfer=True)
    j_grid, _ = jgen.eval_points_dense_band(
        State(v), NX, {k: jnp.asarray(x.numpy()) for k, x in c.items()}, cap=1)
    assert jgen.band_overflows == 1
    np.testing.assert_allclose(j_grid.reshape(-1), full, atol=1e-5)


@pytest.mark.parametrize("mode", ["none", "contact"])
def test_generate_obj_mesh_wnf_band(pair, mode):
    """generate_obj_mesh_wnf with band_transfer true: the mesh, chamfer and
    EMD of band_transfer false bit for bit, through the band route (the
    counter of _obj_mesh_band); contact-gated with the band's buffer too
    small, the full transfer and the same mesh."""
    cfg, jmodel, v, tmodel, _, _ = pair
    cfg = copy.deepcopy(cfg)
    cfg["generation"]["resolution_0"] = NX // 4
    cfg["model"]["with_img"] = mode == "contact"
    data = make_batch(np.random.default_rng(1))
    out = {}
    for band in (False, True):
        gen = get_generator(tmodel, cfg, band_transfer=band,
                            contact_per_finger=CONTACTS_PER_FINGER)
        calls = []
        dense_band = gen._dense_band
        gen._dense_band = lambda *a, **k: calls.append(1) or dense_band(*a, **k)
        np.random.seed(0)
        out[band] = gen.generate_obj_mesh_wnf(tmodel, data)
        assert len(calls) == band and gen.band_overflows == 0
    ((v0, f0), emd0, cd0), ((v1, f1), emd1, cd1) = out[False], out[True]
    assert np.array_equal(v0, v1) and np.array_equal(f0, f1) and len(f0)
    assert (emd0, cd0) == (emd1, cd1)
    if mode == "contact":
        gen = get_generator(tmodel, cfg, band_transfer=True,
                            contact_per_finger=CONTACTS_PER_FINGER)
        band = gen._obj_mesh_band
        gen._obj_mesh_band = lambda *a, **k: band(*a, cap=1)
        np.random.seed(0)
        (v2, f2), emd2, cd2 = gen.generate_obj_mesh_wnf(tmodel, data)
        assert gen.band_overflows == 1
        assert np.array_equal(v0, v2) and np.array_equal(f0, f2) and (emd0, cd0) == (emd2, cd2)


@pytest.fixture(scope="module")
def batched(pair):
    """Three objects' fields (the pair's scaled per object), the port's and
    the JAX package's band generators, and the port's float32 batched
    transfer."""
    cfg, jmodel, v, tmodel, c, _ = pair
    cB = {k: torch.cat([x * (1.0 + 0.1 * b) for b in range(3)]) for k, x in c.items()}
    gen = get_generator(tmodel, copy.deepcopy(cfg), band_transfer=True)
    full = gen.decode_dense_batched(tmodel, NX, cB, transfer_dtype=torch.float32)
    return cfg, jmodel, v, tmodel, cB, full


@pytest.mark.parametrize("form", ["blocking", "return_device"])
def test_batched_band_equals_full_transfer(batched, form):
    """decode_dense_batched_band, blocking or with return_device and
    finish_batched_band(mesh=True): each object's mesh equals the float32
    batched transfer's bit for bit; against the JAX package's batched band:
    the levels to 1e-6, the same occupancy and triangles."""
    cfg, jmodel, v, tmodel, cB, full = batched
    gen = get_generator(tmodel, copy.deepcopy(cfg), band_transfer=True)
    if form == "blocking":
        grids, levels = gen.decode_dense_batched_band(tmodel, NX, cB)
        meshes = [marching_cubes(g, level=lv) for g, lv in zip(grids, levels)]
    else:
        raw, fin = gen.decode_dense_batched_band(tmodel, NX, cB, return_device=True)
        assert raw.dtype == torch.uint8 and raw.shape == (3, TB.payload_bytes(NX, fin[1]))
        meshes, levels = gen.finish_batched_band(tmodel, raw, fin, mesh=True)
    assert gen.band_overflows == 0
    jgen = JGen(jmodel, resolution0=4, padding=0.1)
    jc = {k: jnp.asarray(x.numpy()) for k, x in cB.items()}
    j_grids, j_levels = jgen.decode_dense_batched_band(State(v), NX, jc)
    for b in range(3):
        fb = full[b].reshape(NX, NX, NX)
        assert levels[b] == float(np.float32((float(fb.min()) + float(fb.max())) / 2))
        want = marching_cubes(fb, level=levels[b])
        assert np.array_equal(meshes[b][0], want[0]) and np.array_equal(meshes[b][1], want[1])
        assert abs(j_levels[b] - levels[b]) <= 1e-6
        assert_same_mesh_as_jax(want, marching_cubes(j_grids[b], level=levels[b]), fb,
                                j_grids[b], levels[b])


def test_batched_band_overflow(batched):
    """cap=1: every object takes the full float32 transfer alone, counted
    once each, in both forms."""
    cfg, jmodel, v, tmodel, cB, full = batched
    gen = get_generator(tmodel, copy.deepcopy(cfg), band_transfer=True)
    grids, levels = gen.decode_dense_batched_band(tmodel, NX, cB, cap=1)
    assert gen.band_overflows == 3
    for b in range(3):
        np.testing.assert_array_equal(grids[b].reshape(-1), full[b])
    raw, fin = gen.decode_dense_batched_band(tmodel, NX, cB, cap=1, return_device=True)
    meshes, _ = gen.finish_batched_band(tmodel, raw, fin, mesh=True)
    assert gen.band_overflows == 6
    for b in range(3):
        want = marching_cubes(full[b].reshape(NX, NX, NX), level=levels[b])
        assert np.array_equal(meshes[b][0], want[0]) and np.array_equal(meshes[b][1], want[1])


def test_run_batched_band_equals_full_transfer(pair, monkeypatch, tmp_path):
    """Inferencer.run_batched with band_transfer true takes the band route
    and serves the chamfers and mesh files of band_transfer false at
    float32 transfers."""
    cfg, jmodel, v, tmodel, _, _ = pair
    cfg = copy.deepcopy(cfg)
    cfg["generation"]["resolution_0"] = NX // 4
    loader = []
    for i in range(3):
        batch = make_batch(np.random.default_rng(10 + i))
        batch["points.name"] = [f"obj{i}"]
        loader.append(batch)
    decode = Generator3D.decode_dense_batched
    monkeypatch.setattr(Generator3D, "decode_dense_batched",
                        lambda self, *a, **k: decode(self, *a, **dict(
                            k, transfer_dtype=torch.float32)))
    out = {}
    for band in (False, True):
        gen = get_generator(tmodel, cfg, band_transfer=band)
        assert gen._band_enabled(tmodel) == band
        inf = Inferencer.from_config(tmodel, gen, cfg)
        out[band] = inf.run_batched(tmodel, loader, batch_size=2,
                                    out_dir=str(tmp_path / str(band)))
    assert out[True] == out[False] and np.isfinite(out[True]["cd_mean"])
    for i in range(3):
        name = f"obj{i}_obj.off"
        assert (tmp_path / "True" / name).read_bytes() == (tmp_path / "False" / name).read_bytes()


def test_band_transfer_setting(pair):
    """generation.band_transfer reaches the generator through from_config:
    true turns the band on for a LocalDecoder; 'auto' and false leave it
    off; other values raise."""
    cfg, _, _, tmodel, _, _ = pair
    for value, on in (("auto", False), (False, False), (True, True)):
        cfg2 = copy.deepcopy(cfg)
        cfg2["generation"]["band_transfer"] = value
        gen = get_generator(tmodel, cfg2)
        assert gen.band_transfer == value and gen._band_enabled(tmodel) == on
    with pytest.raises(ValueError, match="band_transfer"):
        Generator3D(tmodel, band_transfer="yes")
    assert not Generator3D._fast_capable(type("M", (), {"decoder": torch.nn.Linear(1, 1)}))
