"""MISE in the PyTorch port against the JAX package on the CPU: the
bookkeeping engines (native and numpy), ``multires_decode`` with every
gating, and ``generate_obj_mesh_mise`` end to end, on the same weights
(carried across by load_jax_params) and inputs from numpy seeds.

Sizes: the parity model of tests/test_torch_setup.py (grid 16³ × 8),
res0 = 8 and two levels (a 33³ final grid). The JAX side takes its XLA
trunk (its kernels are off on the CPU), with float32 transfers. The
decoder's feature conditioning is damped by FEATURE_GAIN
(tests/test_torch_generate.py), so that the field crosses its level along
one smooth surface and MISE refines a thin shell; a random field crosses
it everywhere and MISE queries nearly the whole grid.

Tolerances: engines exact (queries, order included, and values);
``multires_decode`` on the same feature grid and gates: the same query
counts per level, levels within 1e-6, and grids within 1e-5 and occupied
alike away from the values within NEAR of the level: such a value may be
decided either way, and that changes which points the next levels decode
around it (``settled``; the count is logged, and at least 95 % of the
grid compared).
Meshes as in tests/test_torch_generate.py, after equal occupancy of the
two grids.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from vtaco_tpu.generate import mise as jmise
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu_torch.core.config import get_generator
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate import mise as tmise

from test_torch_generate import FEATURE_GAIN, MAX_TRI_BOUND, _triangles, _vertex_bound
from test_torch_setup import CONTACTS_PER_FINGER, build_pair, make_batch

RES0, STEPS = 8, 2
NEAR = 1e-5


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, v, tmodel = build_pair()
    for name, leaf in v["params"]["decoder"].items():
        if name.startswith("fc_c"):
            leaf["kernel"] = leaf["kernel"] * FEATURE_GAIN
    load_jax_params(tmodel, v["params"], v["batch_stats"])

    class State:
        params = v["params"]
        batch_stats = v["batch_stats"]

    cfg = copy.deepcopy(cfg)
    cfg["generation"]["resolution_0"] = RES0 // 4
    return cfg, jmodel, State(), tmodel


def settled(tgrid, tthr, jgrid, jthr):
    """The grid points that no undecided value can reach: a value within
    NEAR of its level in either package may be decided either way, which
    changes the active voxels around it and so which points the next
    levels decode, up to three fine voxels away. Returns (mask, count of
    undecided values)."""
    from scipy.ndimage import binary_dilation

    near = (np.abs(jgrid - jthr) < NEAR) | (np.abs(tgrid - tthr) < NEAR)
    return ~binary_dilation(near, np.ones((3, 3, 3), bool), iterations=3), int(near.sum())


def _gens(cfg, jmodel, tmodel, transfer="float32"):
    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, transfer_dtype=transfer,
                            contact_per_finger=CONTACTS_PER_FINGER)
    tgen = get_generator(tmodel, cfg, transfer_dtype=transfer,
                         contact_per_finger=CONTACTS_PER_FINGER)
    return jgen, tgen


def _field(rng, pts, reso):
    """A sphere of radius 0.38 with noise, as JAX's engine test draws it."""
    coords = pts / reso - 0.5
    base = 0.38 - np.linalg.norm(coords, axis=1)
    return (base + rng.standard_normal(len(pts)) * 0.01).astype(np.float32)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_engine_matches_jax(engine):
    """Three levels of the same value stream through the port's engine and
    the JAX package's engine of the same kind: the same queries in the
    same order, known masks and values, bit for bit; for the native
    engine also ``update_queried`` and ``query_cn`` (the pad tail repeats
    the last point), and the port's numpy engine equal to its native."""
    kind = {"native": "MultiGridExtractorNative", "numpy": "MultiGridExtractorNumpy"}[engine]
    t, j = getattr(tmise, kind)(8, 0.1, invert=False), getattr(jmise, kind)(8, 0.1,
                                                                            invert=False)
    ref = tmise.MultiGridExtractorNumpy(8, 0.1, invert=False)
    rng = np.random.default_rng(3)
    for step in range(3):
        if step:
            for e in (t, j, ref):
                e.increase_resolution()
        assert t.resolution == j.resolution == 8 << step
        pts = t.query()
        np.testing.assert_array_equal(pts, j.query())
        np.testing.assert_array_equal(pts, ref.query())
        vals = _field(rng, pts, t.resolution)
        for e in (t, j, ref):
            e.update(pts, vals)
        known = j.value_known
        np.testing.assert_array_equal(t.value_known, known)
        np.testing.assert_array_equal(np.asarray(t.values)[known],
                                      np.asarray(j.values)[known])
        np.testing.assert_array_equal(np.asarray(t.values, np.float32),
                                      np.asarray(ref.values, np.float32))
    np.testing.assert_array_equal(t.values_view, np.asarray(j.values_view))
    assert t.values_view.shape == (33, 33, 33)
    if engine == "numpy":
        return
    t2, j2 = tmise.MultiGridExtractorNative(8, 0.1, invert=False), \
        jmise.MultiGridExtractorNative(8, 0.1, invert=False)
    rng = np.random.default_rng(3)
    for step in range(3):
        if step:
            t2.increase_resolution()
            j2.increase_resolution()
        assert t2.query_count == j2.query_count
        pad = t2.query_count + 5
        cn, n = t2.query_cn(pad)
        jcn, jn = j2.query_cn(pad)
        np.testing.assert_array_equal(cn, jcn)
        assert n == jn and (cn[:, n:] == cn[:, n - 1:n]).all()
        vals = _field(rng, cn[:, :n].T.astype(np.int64), t2.resolution)
        t2.update_queried(vals)
        j2.update_queried(vals)
    np.testing.assert_array_equal(t2.values, j2.values)
    np.testing.assert_array_equal(t2.values, t.values)


def test_native_engine_raises_on_a_failed_build(monkeypatch, tmp_path):
    """No quiet numpy fallback: a g++ that fails raises, naming the
    source, and MultiGridExtractor is the native engine."""
    from vtaco_tpu_torch import native

    assert tmise.MultiGridExtractor is tmise.MultiGridExtractorNative
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda _: "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/mise.cpp"):
        native._Mise()._ensure()


def test_native_engine_rejects_bad_updates():
    """The engine writes at the nodes it is given unchecked, so the facade
    refuses nodes off the grid, mismatched lengths and a value count
    other than the pending points'."""
    mg = tmise.MultiGridExtractorNative(4, 0.0, invert=False)
    n = mg.query_count
    for pts, vals in ((np.full((1, 3), 5), np.zeros(1)), (np.full((1, 3), -1), np.zeros(1)),
                      (np.zeros((2, 3)), np.zeros(1))):
        with pytest.raises(ValueError, match="nodes of the 4³ grid"):
            mg.update(pts, vals)
    with pytest.raises(ValueError, match=f"one value per pending point \\({n}\\)"):
        mg.update_queried(np.zeros(n + 1))
    mg.update_queried(np.zeros(n))
    assert mg.value_known.all()


def _gates(rng, mode, C):
    if mode == "none":
        return ("none", None, None, None)
    feat = rng.standard_normal((5, C)).astype(np.float32)
    if mode == "tips":
        tips = rng.uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
        return ("tips", tips, feat, np.array([1, 1, 0, 1, 1], bool))
    pts = rng.uniform(-0.3, 0.3, (5, 1, 3)) + 0.05 * rng.standard_normal((5, 24, 3))
    return ("contact", pts.astype(np.float32), feat, rng.random((5, 24)) > 0.2)


@pytest.mark.parametrize("mode", ["none", "contact", "tips"])
def test_multires_decode_matches_jax(pair, mode):
    """``multires_decode`` in both packages on the same feature grid (the
    JAX encoder's) and gates, at the midpoint level: levels within 1e-6,
    the same query count per level (logged) and grids within 1e-5."""
    cfg, jmodel, state, tmodel = pair
    jgen, tgen = _gens(cfg, jmodel, tmodel)
    data = make_batch(np.random.default_rng(0))
    jc = jgen._apply(state, jmodel.encode_inputs, jnp.asarray(data["inputs"]),
                     train=False)
    gating, *g = _gates(np.random.default_rng(1), mode, cfg["model"]["c_dim"])
    jst, tst = {}, {}
    jgrid, jthr = jmise.multires_decode(
        jgen, state, jc, RES0, STEPS, "midpoint", gating,
        *(None if a is None else jnp.asarray(a) for a in g), stats=jst)
    tgrid, tthr = tmise.multires_decode(
        tgen, tmodel, {"grid": torch.as_tensor(np.array(jc["grid"]))}, RES0, STEPS,
        "midpoint", gating, *(None if a is None else torch.as_tensor(a) for a in g),
        stats=tst)
    jgrid = np.asarray(jgrid)
    print(f"{mode}: query_pts {tst['query_pts']} of {(RES0 * 2 + 1) ** 3}, "
          f"{(RES0 * 4 + 1) ** 3}; largest difference {np.abs(tgrid - jgrid).max():.3g}")
    assert abs(tthr - jthr) <= 1e-6
    assert tst["query_pts"] == jst["query_pts"]
    assert 0 < tst["query_pts"][-1] < 0.5 * (RES0 * 4 + 1) ** 3
    keep, n_near = settled(tgrid, tthr, jgrid, jthr)
    print(f"{mode}: {n_near} grid values within {NEAR} of the level")
    assert keep.mean() > 0.95
    np.testing.assert_array_equal((tgrid >= tthr)[keep], (jgrid >= jthr)[keep])
    np.testing.assert_allclose(tgrid[keep], jgrid[keep], atol=1e-5, rtol=0)
    assert set(tst) >= {"coarse_s", "decode_s", "host_s", "query_pts"}


@pytest.mark.parametrize("mode,mc_level", [("none", "midpoint"), ("contact", "mean")])
def test_generate_obj_mesh_mise_matches_jax(pair, mode, mc_level):
    """``generate_obj_mesh_mise`` from a B=1 batch in both packages (each
    its own encoder and gates): the two MISE grids occupied alike at
    their levels, then the meshes triangle for triangle as in
    tests/test_torch_generate.py, vertices in the object frame."""
    cfg, jmodel, state, tmodel = pair
    cfg = copy.deepcopy(cfg)
    cfg["model"]["with_img"] = mode == "contact"
    cfg["generation"]["mc_level"] = mc_level
    jgen, tgen = _gens(cfg, jmodel, tmodel)
    data = make_batch(np.random.default_rng(0))
    jv, jf = jgen.generate_obj_mesh_mise(state, data, upsampling_steps=STEPS)
    tst = {}
    tv, tf = tgen.generate_obj_mesh_mise(tmodel, data, upsampling_steps=STEPS, stats=tst)

    # the grids behind both meshes
    J = {k: jnp.asarray(data[k]) for k in data}
    jgates = jgen._build_gates(
        state, J["inputs"], J["inputs.img"], J["inputs.depth"],
        J["inputs.touch_success"] > 0.5, J["inputs.pc_ply"], J["points.mano"],
        J["points.wrist"], J["points.cam_pos"], J["points.cam_rot"]) \
        if mode == "contact" else ("none", None, None, None)
    jc = jgen._apply(state, jmodel.encode_inputs, J["inputs"], train=False)
    thr = None if mc_level == "mean" else "midpoint"
    jgrid, jthr = jmise.multires_decode(jgen, state, jc, RES0, STEPS, thr, *jgates)
    with torch.no_grad():
        tc, tgates = tgen._encode_sample(tmodel, data, 0, gates=mode == "contact")
        tgrid, tthr = tmise.multires_decode(tgen, tmodel, tc, RES0, STEPS, thr, *tgates)
    jgrid = np.asarray(jgrid)
    assert tgates[0] == jgates[0] == mode
    np.testing.assert_array_equal(tgrid >= tthr, jgrid >= jthr)
    reso = RES0 << STEPS
    assert len(tf) > 100 and (len(tv), len(tf)) == (len(jv), len(jf))
    assert np.abs(tv).max() <= 0.55 and tst["query_pts"][-1] > 0
    assert tst["marching_cubes_s"] > 0
    box = 1 + cfg["data"]["padding"]
    dist, idx = cKDTree(_triangles(jv, jf, reso, box)).query(
        _triangles(tv, tf, reso, box), p=np.inf)
    assert len(np.unique(idx)) == len(idx)
    dv = float(np.abs(tgrid - jgrid).max()) + abs(tthr - jthr)
    bound = _vertex_bound(jv * reso / box + reso / 2, jgrid, dv)
    tri_bound = np.minimum(bound[jf].max(axis=1)[idx], MAX_TRI_BOUND)
    print(f"{mode} {mc_level}: {len(idx)} triangles, largest distance "
          f"{dist.max():.3g} voxel, query_pts {tst['query_pts']}")
    assert (dist <= tri_bound).all(), (dist / tri_bound).max()
    assert np.median(dist) <= 1e-4
