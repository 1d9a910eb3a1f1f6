"""Port ops against their JAX functions on the same numpy inputs: geometry,
scatter pooling, grid interpolation, the separable dense-decode inputs,
contact selection and back-projection, marching cubes and the metrics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.ops import dense_decode as jdd
from vtaco_tpu.ops import geometry as jgeo
from vtaco_tpu.ops import interp as jinterp
from vtaco_tpu.ops import metrics as jmetrics
from vtaco_tpu.ops import scatter as jscatter
from vtaco_tpu.train import contact as jcontact
from vtaco_tpu_torch.ops import dense_decode as tdd
from vtaco_tpu_torch.ops import geometry as tgeo
from vtaco_tpu_torch.ops import interp as tinterp
from vtaco_tpu_torch.ops import metrics as tmetrics
from vtaco_tpu_torch.ops import scatter as tscatter
from vtaco_tpu_torch.train import contact as tcontact

ATOL = 1e-6


def T(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _points(rng, n=400):
    """Query points, including outliers and values that land in the
    [1 - eps, 1) band the remap leaves untouched."""
    p = rng.uniform(-0.6, 0.6, (2, n, 3)).astype(np.float32)
    edge = (1 + 0.1 + 10e-4) * (0.9995 - 0.5)   # normalizes into [1-1e-3, 1)
    p[0, :4] = [[edge, 0.0, -edge], [0.7, -0.8, 0.2], [-0.551, 0.551, 0.0],
                [edge, edge, edge]]
    return p


def test_normalize_and_index(rng):
    p = _points(rng)
    nor = tgeo.normalize_3d_coordinate(T(p), padding=0.1)
    want = jgeo.normalize_3d_coordinate(jnp.asarray(p), padding=0.1)
    np.testing.assert_array_equal(nor.numpy(), np.asarray(want))
    assert (nor.numpy() >= 1 - 10e-4).any() and (nor.numpy() < 1).all()
    for R in (16, 64):
        np.testing.assert_array_equal(
            tgeo.coordinate2index(nor, R, "3d").numpy(),
            np.asarray(jgeo.coordinate2index(want, R, "3d")))
    np.testing.assert_array_equal(
        tgeo.coordinate2index(nor[..., :2], 16, "2d").numpy(),
        np.asarray(jgeo.coordinate2index(want[..., :2], 16, "2d")))


def test_camera_geometry(rng):
    pc = rng.standard_normal((50, 3)).astype(np.float32) * 0.02
    obj = rng.standard_normal((80, 3)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
    trans = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    close(tgeo.norm_pc_1(T(pc), T(obj)), jgeo.norm_pc_1(jnp.asarray(pc), jnp.asarray(obj)))
    close(tgeo.pc_cam_to_world(T(pc), T(rot), T(trans)),
          jgeo.pc_cam_to_world(jnp.asarray(pc), jnp.asarray(rot), jnp.asarray(trans)))
    close(tgeo.R_from_PYR(T(rot)), jgeo.R_from_PYR(jnp.asarray(rot)))


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_scatter_pooling_with_shared_cells(rng, reduce):
    B, N, C, S = 2, 300, 5, 40   # 300 points into 40 cells: many collisions
    src = rng.standard_normal((B, N, C)).astype(np.float32)
    idx = rng.integers(0, S - 8, (B, N))   # the last cells stay empty
    tfn = tscatter.scatter_mean if reduce == "mean" else tscatter.scatter_max
    jfn = jscatter.scatter_mean if reduce == "mean" else jscatter.scatter_max
    got = tfn(T(src), T(idx), S)
    want = jfn(jnp.asarray(src), jnp.asarray(idx, jnp.int32), S)
    close(got, want)
    assert not got[:, S - 8:].any()
    close(tscatter.gather_cells(got, T(idx)),
          jscatter.gather_cells(want, jnp.asarray(idx, jnp.int32)))


def test_interp_grid(rng):
    fea = rng.standard_normal((2, 6, 7, 8, 4)).astype(np.float32)
    p = _points(rng, 200)
    uvw = jgeo.normalize_3d_coordinate(jnp.asarray(p), padding=0.1)
    close(tinterp.interp_grid(T(fea), T(uvw)),
          jinterp.interp_grid(jnp.asarray(fea), uvw))


@pytest.mark.parametrize("nx,R", [(9, 6), (32, 16), (64, 16)])
def test_dense_feature_volume(rng, nx, R):
    np.testing.assert_array_equal(
        tdd._axis_interp_matrix(nx, R, 1.1, 0.1, True),
        jdd._axis_interp_matrix(nx, R, 1.1, 0.1, True))
    g = rng.standard_normal((1, R, R, R, 8)).astype(np.float32)
    got = tdd.dense_feature_volume_cn({"grid": T(g)}, nx, 1.1, 0.1)
    want = jdd.dense_feature_volume_cn({"grid": jnp.asarray(g)}, nx, 1.1, 0.1)
    close(got, want)
    np.testing.assert_array_equal(
        tdd.dense_query_grid_cn(nx, 1.1, device="cpu").numpy(),
        np.asarray(jdd.dense_query_grid_cn(nx, 1.1)))


def test_dense_feature_volume_rejects_planes(rng):
    """Plane fields: the dense volume of three planes alone and beside a
    grid, and their scattered features at arbitrary points, as the JAX
    package sums them."""
    fields = {"xz": rng.standard_normal((1, 5, 5, 2)), "xy": rng.standard_normal((1, 6, 6, 2)),
              "yz": rng.standard_normal((1, 4, 4, 2)),
              "grid": rng.standard_normal((1, 4, 4, 4, 2))}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    p = rng.uniform(-0.6, 0.6, (3, 500)).astype(np.float32)
    for keys in (("xz",), ("xz", "xy", "yz"), ("grid", "xz", "xy", "yz")):
        tf = {k: T(fields[k]) for k in keys}
        jf = {k: jnp.asarray(fields[k]) for k in keys}
        close(tdd.dense_feature_volume_cn(tf, 8, 1.1, 0.1),
              jdd.dense_feature_volume_cn(jf, 8, 1.1, 0.1))
        close(tdd.scattered_feature_volume_cn(tf, T(p), 0.1),
              jdd.scattered_feature_volume_cn(jf, jnp.asarray(p), 0.1))


def test_backproject_depth(rng):
    H, W = 12, 10
    d = (0.0215 - 0.002 * rng.random((H, W))).astype(np.float32)
    f = H / (2 * np.tan(np.radians(30.0)))
    close(tcontact.backproject_depth(T(d), f, W, H),
          jcontact.backproject_depth(jnp.asarray(d), f, W, H))


def test_random_topk_select(rng):
    mask = rng.random(200) > 0.6
    g = torch.Generator().manual_seed(3)
    idx, valid = tcontact.random_topk_select(T(mask), 16, g)
    assert valid.all() and T(mask)[idx].all() and len(set(idx.tolist())) == 16
    few = np.zeros(200, bool)
    few[[3, 50, 199]] = True
    idx, valid = tcontact.random_topk_select(T(few), 16, g)
    assert valid.sum() == 3 and set(idx[valid].tolist()) == {3, 50, 199}
    explicit = np.arange(16)
    idx, valid = tcontact.random_topk_select(T(mask), 16, idx=explicit)
    np.testing.assert_array_equal(valid.numpy(), mask[:16])


def test_prep_contact_gates_with_jax_indices(rng):
    """More contact pixels than slots: the port replays the JAX package's
    draws through explicit indices and builds the same gates."""
    from vtaco_tpu.generate.generator import Generator3D as JGen
    from vtaco_tpu_torch.generate.generator import Generator3D as TGen
    import jax

    H, W, K = 16, 12, 8
    depths = np.full((5, H * W), 0.0215, np.float32)
    depths[:, rng.choice(H * W, 40, replace=False)] = 0.0195
    touch = np.array([True, True, False, True, True])
    cam_rot = rng.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)
    cam_pos = rng.uniform(-0.05, 0.05, (5, 3)).astype(np.float32)
    pc_ply = (rng.standard_normal((100, 3)) * 0.04).astype(np.float32)
    d_origin = np.full(H * W, 0.0215, np.float32)

    jgen = JGen(None, contact_per_finger=K)
    jpts, jvalid = jgen._prep_contact_gates(
        jnp.asarray(depths), jnp.zeros_like(depths), jnp.asarray(d_origin),
        jnp.asarray(touch), jnp.asarray(cam_rot), jnp.asarray(cam_pos),
        jnp.asarray(pc_ply), H, W, seed=0)
    key = jax.random.PRNGKey(0)
    idx = np.stack([np.asarray(jcontact.random_topk_select(
        jnp.asarray((np.abs(depths[f] - d_origin) > 1e-4) & touch[f]), K,
        jax.random.fold_in(key, f))[0]) for f in range(5)])

    tgen = TGen(None, contact_per_finger=K)
    tpts, tvalid = tgen._prep_contact_gates(
        T(depths), None, T(d_origin), T(touch), T(cam_rot), T(cam_pos),
        T(pc_ply), H, W, contact_idx=idx)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tvalid[[0, 1, 3, 4]].all() and not tvalid[2].any()
    close(tpts, jpts, atol=2e-6)  # matrix inverse rounds differently


def test_marching_cubes_matches_numpy_reference(rng):
    from vtaco_tpu.generate.marching_cubes import _marching_cubes_numpy
    from vtaco_tpu_torch.generate.marching_cubes import marching_cubes

    x = np.linspace(-1, 1, 21)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    vol = (0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
           + 0.05 * rng.standard_normal(X.shape)).astype(np.float32)
    # the port's marching cubes is native: the same mesh as the numpy
    # reference, its vertices in the scan's order (tests/test_marching_cubes.py's
    # soup comparison)
    from test_marching_cubes import _canon

    v, f = marching_cubes(vol, 0.1, gradient="descent")
    vn, fn = _marching_cubes_numpy(vol, 0.1)
    assert (len(v), len(f)) == (len(vn), len(fn))
    np.testing.assert_allclose(_canon(v, f), _canon(vn, fn), atol=1e-5)
    va, fa = marching_cubes(vol)
    vb, fb = _marching_cubes_numpy(vol, (vol.min() + vol.max()) / 2.0)
    assert (len(va), len(fa)) == (len(vb), len(fb))
    np.testing.assert_allclose(_canon(va, fa[:, ::-1]), _canon(vb, fb), atol=1e-5)


@pytest.mark.parametrize("n2", [500, 2048])
def test_metrics(rng, n2):
    p1 = rng.standard_normal((1, 2048, 3)).astype(np.float32)
    p2 = rng.standard_normal((1, n2, 3)).astype(np.float32)
    close(tmetrics.chamfer_distance(T(p1), T(p2)),
          jmetrics.chamfer_distance(jnp.asarray(p1), jnp.asarray(p2)), atol=1e-6)
    a, b = p1[0, :300], p2[0, :250]
    assert tmetrics.earth_mover_distance(a, b) == jmetrics.earth_mover_distance(a, b)
