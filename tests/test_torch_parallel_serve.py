"""The sharded decodes of the PyTorch port over a device mesh against
the same calls without one and against the JAX package's mesh results on
the CPU: ``eval_points_dense_sharded``, ``decode_dense_batched``,
``decode_points_batched``, ``multires_decode_batched`` and
``Inferencer.run_batched``, each under a 2-rank gloo mesh spawned from
tests/parallel_workers.py (no JAX in it), on the weights of
tests/test_torch_mise.py's and tests/test_torch_batched.py's fixtures.

Tolerances: the calls under the mesh equal the calls without one bit for
bit (each object's, or each slab's, arithmetic is the same), but
``eval_points_dense_sharded``, within one bfloat16 step of
``eval_points_dense``; against the JAX package's mesh results as
tests/test_torch_batched.py holds the calls without a mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.generate import mise as jmise
from vtaco_tpu.generate.inferencer import Inferencer as JInferencer
from vtaco_tpu.parallel.mesh import make_mesh as jax_make_mesh

import parallel_workers as W
from test_torch_batched import _bf16_steps, _float32_transfers, _grids, _one_step_apart
from test_torch_batched import served  # noqa: F401  (fixture)
from test_torch_inference import _batches
from test_torch_mise import _gens, pair, settled  # noqa: F401  (fixture)

PER_FINGER = 16

NX = 9
NX_SHARDED = 8


@pytest.fixture(scope="module")
def decodes(pair, tmp_path_factory):
    cfg, jmodel, state, tmodel = pair
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.55, 0.55, (2, 200, 3)).astype(np.float32)
    lat = rng.integers(0, 17, (2, 200, 3)).astype(np.int16)
    cn = np.ascontiguousarray(lat.transpose(0, 2, 1))
    cases = {"float": {"pts_b": pts, "transfer_dtype": torch.float32},
             "lattice": {"pts_b": lat, "lattice_reso": 16, "transfer_dtype": torch.float32},
             "int8": {"pts_b": lat, "lattice_reso": 16, "transfer_dtype": "int8"},
             "prepacked": {"pts_cn": cn, "n_real": 150, "lattice_reso": 16,
                           "transfer_dtype": torch.float32},
             "module": {"pts_b": pts, "fast": False, "transfer_dtype": torch.float32}}
    p = {"cfg": cfg, "params": state.params, "stats": state.batch_stats,
         "per_finger": PER_FINGER, "grids": _grids(cfg, seed=5), "nx": NX,
         "nx_sharded": NX_SHARDED, "points_cases": cases, "res0": 8}
    out = W.spawn("decode", 2, tmp_path_factory.mktemp("decode"), p)
    jgen, _ = _gens(cfg, jmodel, tmodel)
    jmesh = jax_make_mesh(data=2)
    g = p["grids"]
    jc = {"grid": jnp.asarray(g[:2])}
    want = {
        "sharded": jgen.eval_points_dense_sharded(state, NX_SHARDED,
                                                  {"grid": jnp.asarray(g[:1])}, jmesh),
        "dense": jgen.decode_dense_batched(state, NX, jc, device_mesh=jmesh,
                                           transfer_dtype=jnp.float32),
        # copies: the JAX package returns its pooled host buffer
        "float": np.array(jgen.decode_points_batched(state, pts, jc, device_mesh=jmesh,
                                                     transfer_dtype=jnp.float32)),
        "lattice": np.array(jgen.decode_points_batched(state, lat, jc, device_mesh=jmesh,
                                                       lattice_reso=16,
                                                       transfer_dtype=jnp.float32)),
        "mise": jmise.multires_decode_batched(jgen, state, jc, 8, 1, None,
                                              device_mesh=jmesh),
    }
    return out, want


def test_eval_points_dense_sharded(decodes):
    """Each rank decodes a z-slab of the 8³ grid through K2's wrapper (its
    plain version on the CPU) and every rank returns the whole x-slowest
    grid: within one bfloat16 step of ``eval_points_dense`` and of the
    JAX package's sharded decode."""
    (r0, r1), want = decodes
    np.testing.assert_array_equal(r0["sharded"], r1["sharded"])
    assert r0["sharded"].shape == (NX_SHARDED ** 3,)
    ref = torch.as_tensor(r0["sharded_ref"]).to(torch.bfloat16).float().numpy()
    assert np.abs(_bf16_steps(r0["sharded"]) - _bf16_steps(ref)).max() <= 1
    _one_step_apart(_bf16_steps(r0["sharded"]), _bf16_steps(want["sharded"]))


@pytest.mark.parametrize("b", [2, 3])
def test_decode_dense_batched_mesh(decodes, b):
    """Two objects split over the ranks, three decoded whole by each: the
    same logits as without a mesh on every rank, at every transfer; two
    objects against the JAX package's mesh decode at float32."""
    (r0, r1), want = decodes
    for td in ("torch.float32", "torch.bfloat16", "int8"):
        got = r0["dense", b, td, False]
        assert got.shape == (b, NX ** 3)
        np.testing.assert_array_equal(got, r0["dense", b, td, True])
        np.testing.assert_array_equal(got, r1["dense", b, td, False])
    if b == 2:
        np.testing.assert_allclose(r0["dense", 2, "torch.float32", False], want["dense"],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["float", "lattice", "int8", "prepacked", "module"])
def test_decode_points_batched_mesh(decodes, case):
    """Per-object points, each rank its object: the same logits as without
    a mesh (float and lattice coordinates, int8, a prepacked upload, the
    module decode), and against the JAX package's mesh decode."""
    (r0, r1), want = decodes
    got = r0["points", case, False]
    np.testing.assert_array_equal(got, r0["points", case, True])
    np.testing.assert_array_equal(got, r1["points", case, False])
    if case in want:
        np.testing.assert_allclose(got, want[case], atol=1e-5, rtol=0)


def test_multires_decode_batched_mesh(decodes):
    """Batched MISE over the mesh: the grids and levels of the call
    without one, and the JAX package's mesh result as
    tests/test_torch_batched.py holds MISE."""
    (r0, r1), want = decodes
    grids, levels = r0["mise", False]
    for g, g1, g_one in zip(grids, r1["mise", False][0], r0["mise", True][0]):
        np.testing.assert_array_equal(g, g_one)
        np.testing.assert_array_equal(g, g1)
    assert levels == r0["mise", True][1]
    jgrids, jthr = want["mise"]
    np.testing.assert_allclose(levels, jthr, atol=1e-6, rtol=0)
    for t, j, lt, lj in zip(grids, jgrids, levels, jthr):
        j = np.asarray(j)
        keep, n_near = settled(t, lt, j, lj)
        assert n_near <= 2 and keep.mean() > 0.85
        np.testing.assert_array_equal((t >= lt)[keep], (j >= lj)[keep])
        np.testing.assert_allclose(t[keep], j[keep], atol=1e-5, rtol=0)


def test_run_batched_mesh(served, monkeypatch, tmp_path):  # noqa: F811
    """``run_batched`` over the 3-object test split, two a flight, under a
    2-rank mesh (a flight split over the ranks, then one object decoded by
    both): every rank returns rank 0's result, which equals the call
    without a mesh, and on the first flight the JAX package's mesh run
    (float32 transfers, as tests/test_torch_batched.py compares them; the
    JAX package cannot split a flight of one over two devices); rank 1
    writes nothing."""
    _, cfg, jmodel, state, tmodel = served
    batches = _batches(cfg, "test")
    p = {"cfg": cfg, "params": state.params, "stats": state.batch_stats,
         "batches": batches, "out": str(tmp_path)}
    r0, r1 = W.spawn("serve", 2, tmp_path, p)
    assert r0["mesh"] == r1["mesh"]
    assert r0["mesh"]["names"] == r0["one"]["names"] == [b["points.name"][0] for b in batches]
    np.testing.assert_allclose(r0["mesh"]["cd"], r0["one"]["cd"], atol=1e-5, rtol=0)
    assert len(r0["mesh_files"]) == 3 and r1["mesh_files"] == []
    jgen, _ = _gens(cfg, jmodel, tmodel)
    _float32_transfers(monkeypatch)
    # the JAX package shards a flight only whole over the mesh: its first
    want = JInferencer.from_config(jmodel, jgen, cfg).run_batched(
        state, batches[:2], batch_size=2, device_mesh=jax_make_mesh(data=2),
        out_dir=str(tmp_path / "jax"))
    assert r0["mesh"]["names"][:2] == want["names"]
    np.testing.assert_allclose(r0["mesh"]["cd"][:2], want["cd"], atol=1e-5, rtol=0)
