"""The slice end to end: the port's ``generate_obj_mesh_wnf`` against the
JAX package's on the same weights (carried across by load_jax_params) and
the same B=1 batch, at nx = 32 and 64, ungated and contact-gated.

The JAX side takes its XLA trunk (``use_pallas`` 'auto' on the CPU) with
exact float32 transfers and no iso-band; the port runs its plain trunk on
the CPU. Each touching finger presses at most ``contact_per_finger``
pixels, so both sides gate with the same contact set.

Meshes are compared as sets of triangles (in voxel units, to 1e-4), and
the 2048-vertex subsample behind chamfer and EMD is compared only where
it is the whole mesh; above that, the two packages' metrics are compared
on one and the same vertex array. Both packages' marching cubes take
their native extractors, which emit the vertices in one order, and
``test_mesh_metrics_equal_jax_above_2048_vertices`` holds the metrics of
a mesh of more than 2048 vertices directly.

The two packages' value grids differ by a few 1e-6 (float32 sums in
another order, mostly in the encoder's convolutions). Equal meshes need
every grid value on the same side of the iso level in both. Fully random
weights give a noise field whose level set folds through the whole box
(about 55,000 vertices at 64³), and there some grid value always lies
within that difference of the level. So the decoder's feature
conditioning (fc_c) is scaled by FEATURE_GAIN: the field is then
dominated by its smooth response to the coordinates, as a trained
decoder's is, and each batch seed is one whose grids keep every value
clear of the level. The test asserts that precondition first. Of the
batch seeds 0, 1, 2 and 11 screened, 0 and 1 meet it in all four
settings; 2 and 11 each put one grid value (of 299,008) within 4 dv of
the level in one setting, where one cell of the two meshes may differ.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.ops import metrics as jmetrics
import torch
from vtaco_tpu_torch.core.config import get_generator
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.ops import metrics as tmetrics

from test_torch_setup import CONTACTS_PER_FINGER, build_pair, make_batch


FEATURE_GAIN = 0.05
BATCH_SEEDS = (0, 1)
MAX_TRI_BOUND = 1e-2   # voxel: the most _vertex_bound may let a triangle drift


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, v, tmodel = build_pair()
    dec = v["params"]["decoder"]
    for name in dec:
        if name.startswith("fc_c"):
            dec[name]["kernel"] = dec[name]["kernel"] * FEATURE_GAIN
    load_jax_params(tmodel, v["params"], v["batch_stats"])
    return cfg, jmodel, v, tmodel


def _triangles(verts, faces, nx, box):
    tri = (verts * nx / box)[faces].reshape(len(faces), 9)
    return tri.astype(np.float64)


def _vertex_bound(verts_vox, grid, dv):
    """How far a value error ``dv`` may move each marching-cubes vertex:
    a vertex sits at t = (level - v0) / (v1 - v0) on its grid edge, and
    errors of dv in v0, v1 and the level move t by at most about
    4 dv / |v1 - v0|. Never below 1e-4 voxel."""
    frac = np.abs(verts_vox - np.round(verts_vox))
    axis = np.argmax(frac, axis=1)
    p0 = np.clip(np.floor(verts_vox).astype(np.int64), 0, grid.shape[0] - 2)
    p1 = p0.copy()
    p1[np.arange(len(p1)), axis] += 1
    step = np.abs(grid[tuple(p1.T)] - grid[tuple(p0.T)])
    return np.maximum(1e-4, 4 * dv / np.maximum(step, 1e-12))


def _gates_np(gates):
    return [None if a is None else np.array(a) for a in gates[1:]]


@pytest.mark.parametrize("batch_seed", BATCH_SEEDS)
@pytest.mark.parametrize("mode", ["none", "contact"])
@pytest.mark.parametrize("nx", [32, 64])
def test_generate_obj_mesh_wnf_matches_jax(pair, nx, mode, batch_seed):
    """Same vertex and face counts, and the same triangles: each port
    triangle matches one JAX triangle to 1e-4 voxel, or, where an edge
    crosses the level nearly flat, to the displacement that the two
    packages' value difference can cause there (_vertex_bound), never
    more than MAX_TRI_BOUND; the median triangle to 1e-4. The value
    difference comes from the encoder grid, which agrees to the 1e-4 of
    test_torch_models (JAX's f32 grid is itself ~4e-5 from a float64
    evaluation, three times the port's distance); the decode alone, on
    the JAX grid and gates, agrees to 1e-5."""
    cfg, jmodel, v, tmodel = pair
    cfg = copy.deepcopy(cfg)
    cfg["generation"]["resolution_0"] = nx // 4
    cfg["model"]["with_img"] = mode == "contact"
    data = make_batch(np.random.default_rng(batch_seed))

    class State:
        params = v["params"]
        batch_stats = v["batch_stats"]

    jgen = JGen.from_config(jmodel, cfg, band_transfer=False,
                            transfer_dtype="float32",
                            contact_per_finger=CONTACTS_PER_FINGER)
    tgen = get_generator(tmodel, cfg,
                         contact_per_finger=CONTACTS_PER_FINGER)
    np.random.seed(0)
    (jv, jf), jemd, jcd = jgen.generate_obj_mesh_wnf(State(), data)
    np.random.seed(0)
    (tv, tf), temd, tcd = tgen.generate_obj_mesh_wnf(tmodel, data)

    # the value grids behind both meshes, and the gates that made them
    J = {k: jnp.asarray(data[k]) for k in data}
    Tt = {k: torch.as_tensor(np.array(data[k])) for k in data}
    jgates = jgen._build_gates(
        State(), J["inputs"], J["inputs.img"], J["inputs.depth"],
        J["inputs.touch_success"] > 0.5, J["inputs.pc_ply"], J["points.mano"],
        J["points.wrist"], J["points.cam_pos"], J["points.cam_rot"])
    jgrid = jgen._apply(State(), jmodel.encode_inputs, J["inputs"], train=False)
    jvals = jgen.eval_points_dense(State(), nx, jgrid, *jgates,
                                   transfer_dtype=jnp.float32)
    with torch.no_grad():
        tgates = tgen._build_gates(
            tmodel, Tt["inputs.img"], Tt["inputs.depth"],
            Tt["inputs.touch_success"] > 0.5, Tt["inputs.pc_ply"],
            Tt["points.cam_pos"], Tt["points.cam_rot"])
        tvals = tgen.eval_points_dense(
            tmodel, nx, tmodel.encode_inputs(Tt["inputs"]), *tgates,
            transfer_dtype=torch.float32)
        # the decode alone: the JAX grid and gates into the port
        tvals_j = tgen.eval_points_dense(
            tmodel, nx, {"grid": torch.as_tensor(np.array(jgrid["grid"]))},
            jgates[0], *(None if a is None else torch.as_tensor(a)
                         for a in _gates_np(jgates)),
            transfer_dtype=torch.float32)
    np.testing.assert_allclose(tvals_j, jvals, atol=1e-5, rtol=0)
    assert tgates[0] == jgates[0] == mode
    if mode == "contact":
        tp_, tf_, tvalid = _gates_np(tgates)
        jp_, jf_, jvalid = _gates_np(jgates)
        np.testing.assert_array_equal(tvalid, jvalid)
        np.testing.assert_allclose(tf_, jf_, atol=1e-4, rtol=0)
        for f in range(5):   # same contact sets, drawn in another order
            a, b = tp_[f][tvalid[f]], jp_[f][jvalid[f]]
            np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)],
                                       atol=2e-6, rtol=0)

    def occupied(vals):
        return vals > (vals.min() + vals.max()) / 2   # the midpoint level

    np.testing.assert_array_equal(occupied(tvals), occupied(jvals))
    assert len(tf) > 100
    assert (len(tv), len(tf)) == (len(jv), len(jf))
    box = 1 + cfg["data"]["padding"]
    tt = _triangles(tv, tf, nx, box)
    jt = _triangles(jv, jf, nx, box)
    dist, idx = cKDTree(jt).query(tt, p=np.inf)
    assert len(np.unique(idx)) == len(idx)   # one-to-one
    dv = float(np.abs(tvals - jvals).max())
    bound = _vertex_bound(jv * nx / box + nx / 2, jvals.reshape(nx, nx, nx), dv)
    tri_bound = np.minimum(bound[jf].max(axis=1)[idx], MAX_TRI_BOUND)
    print(f"nx={nx} {mode} seed {batch_seed}: {len(idx)} triangles, largest "
          f"distance {dist.max():.3g} voxel, {int((dist > 1e-4).sum())} beyond "
          f"1e-4, largest allowed {tri_bound.max():.3g}")
    assert (dist <= tri_bound).all(), (dist / tri_bound).max()
    assert np.median(dist) <= 1e-4

    if len(tv) <= 2048:
        assert abs(tcd - jcd) <= 1e-6 and abs(temd - jemd) <= 1e-6
    else:
        pts = data["points.points_obj"]
        sample = np.ascontiguousarray(tv[:2048], np.float32)
        tc = float(tmetrics.chamfer_distance(torch.as_tensor(pts),
                                             torch.as_tensor(sample[None]))[0])
        jc = float(np.asarray(jmetrics.chamfer_distance(
            jnp.asarray(pts), jnp.asarray(sample[None])))[0])
        assert abs(tc - jc) <= 1e-6
        assert abs(tmetrics.earth_mover_distance(pts[0], sample)
                   - jmetrics.earth_mover_distance(pts[0], sample)) <= 1e-6
    assert np.isfinite(tcd) and np.isfinite(temd)


def test_mesh_metrics_equal_jax_above_2048_vertices(pair):
    """With both packages' marching cubes native, the vertices come in one
    order, the 2048-vertex sample behind chamfer and EMD is the same draw,
    and the metrics agree directly on a mesh of more than 2048 vertices."""
    from vtaco_tpu import native as jax_native

    assert jax_native.mc._ensure() is not None   # JAX's extractor loads
    cfg, jmodel, v, tmodel = pair
    cfg = copy.deepcopy(cfg)
    nx = 64
    cfg["generation"]["resolution_0"] = nx // 4
    cfg["model"]["with_img"] = False
    data = make_batch(np.random.default_rng(0))

    class State:
        params = v["params"]
        batch_stats = v["batch_stats"]

    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, transfer_dtype="float32")
    tgen = get_generator(tmodel, cfg)
    np.random.seed(0)
    (jv, _), jemd, jcd = jgen.generate_obj_mesh_wnf(State(), data)
    np.random.seed(0)
    (tv, _), temd, tcd = tgen.generate_obj_mesh_wnf(tmodel, data)
    assert len(tv) == len(jv) > 2048
    assert abs(tcd - jcd) <= 1e-6 and abs(temd - jemd) <= 1e-6, (tcd, jcd, temd, jemd)


@pytest.mark.parametrize("out", ["int8", "bfloat16", "float32"])
def test_transfer_rounding_matches_jax(rng, out):
    from vtaco_tpu_torch.generate.generator import Generator3D as TGen

    logits = (3 * rng.standard_normal(4096)).astype(np.float32)
    jd = {"int8": "int8", "bfloat16": jnp.bfloat16, "float32": jnp.float32}[out]
    td = {"int8": "int8", "bfloat16": torch.bfloat16, "float32": torch.float32}[out]
    want = JGen._finalize_logits(jnp.asarray(logits), jd)
    got = TGen._finalize_logits(torch.as_tensor(logits), td)
    if out == "int8":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert float(got[1]) == float(want[1])
    else:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
