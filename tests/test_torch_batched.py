"""Batched serving in the PyTorch port against the JAX package on the CPU:
``decode_dense_batched``, ``decode_points_batched``,
``multires_decode_batched``, ``Inferencer.run_batched`` and
``cli.generate --batched``, on the same weights (carried across by
load_jax_params) and inputs from numpy seeds.

Sizes: the parity model of tests/test_torch_setup.py with its decoder's
feature conditioning damped (tests/test_torch_mise.py), B = 2–3 objects of
6³ × 8 random grids, nx = 9 (a MISE coarse level) and res0 = 8 with one
level; the pipeline tests take tests/test_trainer._small_cfg's widths
(nx = 16) on a synthetic set whose test split holds 3 objects, served
two at a time. The JAX side takes its XLA trunk (its kernels are off on
the CPU). On the CPU the port's batched K2 runs its plain version,
``trunk_cn`` per object.

Tolerances: float32 logits 1e-5. Rounded transfers: the two packages'
float32 logits differ by about 1e-7, so a logit that lies that close to
a rounding boundary may round to the neighbouring step; bfloat16 and int8
results may differ by one step there, at under 1 % of the points, and
each object's int8 scale within 1e-6 relative. MISE grids as in
tests/test_torch_mise.py. Served meshes and their chamfer distances
equal (files within their %.6f rounding, chamfer within 1e-5) when both
packages' bfloat16 logits agree, which the test asserts first.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu.core.checkpoint import CheckpointIO as JaxCheckpointIO
from vtaco_tpu.data.core import Shapes3dDataset as JaxDataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate import mise as jmise
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.generate.inferencer import Inferencer as JInferencer
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.data.core import Shapes3dDataset
from vtaco_tpu_torch.generate import mise as tmise
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
from vtaco_tpu_torch.utils import meshio

from test_torch_generate import _vertex_bound
from test_torch_inference import IMG_H, IMG_W, _batches, _pair
from test_torch_mise import _gens, pair, settled  # noqa: F401  (fixture)
from test_trainer import _small_cfg

B, R, NX = 3, 6, 9


def T(x):
    return torch.as_tensor(np.array(x))


def _grids(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, R, R, R, cfg["model"]["c_dim"])).astype(np.float32)


def _bf16_steps(x):
    """bfloat16 values as their bit patterns: one step apart, one apart."""
    return torch.as_tensor(x).to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)


def _one_step_apart(got, want):
    """At most one rounding step between two arrays of rounding steps (int8
    levels, bfloat16 bit patterns), at under 1 % of the entries."""
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("case", ["float32", "bfloat16", "int8", "over_limit"])
def test_decode_dense_batched_matches_jax(pair, case):
    """(B, nx³) logits, x-major per object, against the JAX package's
    (vmapped, or mapped over objects above ``batched_vmap_limit``); each
    object equal to the port's single-object ``eval_points_dense``; the
    device result of ``return_device`` in the transfer dtype."""
    cfg, jmodel, state, tmodel = pair
    jgen, tgen = _gens(cfg, jmodel, tmodel)
    g = _grids(cfg)
    jc, tc = {"grid": jnp.asarray(g)}, {"grid": T(g)}
    jd = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}.get(case, jnp.float32)
    td = {"int8": "int8", "bfloat16": torch.bfloat16}.get(case, torch.float32)
    if case == "over_limit":
        jgen.batched_vmap_limit = tgen.batched_vmap_limit = 2 * NX ** 3
    want = jgen.decode_dense_batched(state, NX, jc, transfer_dtype=jd)
    got = tgen.decode_dense_batched(tmodel, NX, tc, transfer_dtype=td)
    assert got.shape == (B, NX ** 3) and got.dtype == np.float32
    jf = jgen.decode_dense_batched(state, NX, jc, transfer_dtype=jnp.float32)
    tf = tgen.decode_dense_batched(tmodel, NX, tc, transfer_dtype=torch.float32)
    np.testing.assert_allclose(tf, jf, atol=1e-5, rtol=0)
    for b in range(B):
        one = tgen.eval_points_dense(tmodel, NX, {"grid": tc["grid"][b:b + 1]},
                                     transfer_dtype=torch.float32)
        np.testing.assert_array_equal(tf[b], one)
    if case in ("float32", "over_limit"):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        dev = tgen.decode_dense_batched(tmodel, NX, tc, return_device=True)
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.bfloat16
        np.testing.assert_array_equal(dev.float().numpy(),
                                      T(tf).to(torch.bfloat16).float().numpy())
    elif case == "bfloat16":
        np.testing.assert_array_equal(got, T(tf).to(torch.bfloat16).float().numpy())
        _one_step_apart(_bf16_steps(got), _bf16_steps(want))
    else:
        q, scale = tgen.decode_dense_batched(tmodel, NX, tc, transfer_dtype="int8",
                                             return_device=True)
        jscale = np.abs(jf).max(axis=1) / 127
        np.testing.assert_allclose(scale.numpy(), jscale, rtol=1e-6)
        np.testing.assert_array_equal(got, q.numpy().astype(np.float32)
                                      * scale.numpy()[:, None])
        _one_step_apart(np.rint(got / scale.numpy()[:, None]),
                        np.rint(want / jscale[:, None]))


@pytest.mark.parametrize("case", ["lattice", "float", "coord_quant", "int8_short",
                                  "prepacked"])
def test_decode_points_batched_matches_jax(pair, case):
    """(B, M) logits at per-object points against the JAX package's: int16
    lattice nodes, float coords, uint16-quantized coords, int8 transfer
    with a short object (the zeros, lattice node 0, after its last point
    are decoded and set its scale, as MISE's stacked upload has them), and
    a prepacked (B, 3, mpad) upload whose pad columns repeat each object's
    last point."""
    cfg, jmodel, state, tmodel = pair
    jgen, tgen = _gens(cfg, jmodel, tmodel)
    g = _grids(cfg, seed=1)
    jc, tc = {"grid": jnp.asarray(g)}, {"grid": T(g)}
    rng = np.random.default_rng(2)
    M, reso = 300, 16
    kw = {"transfer_dtype": jnp.float32}, {"transfer_dtype": torch.float32}
    if case == "float":
        pts = rng.uniform(-0.55, 0.55, (B, M, 3)).astype(np.float32)
        args = (pts, pts), ({}, {})
    elif case == "coord_quant":
        pts = rng.uniform(-0.55, 0.55, (B, M, 3)).astype(np.float32)
        args = (pts, pts), ({"coord_quant": True}, {"coord_quant": True})
    elif case == "prepacked":
        cn = rng.integers(0, reso + 1, (B, 3, M + 7)).astype(np.int16)
        n_real = [M, M - 20, M - 1]
        for b, n in enumerate(n_real):
            cn[b, :, n:] = cn[b, :, n - 1:n]
        extra = {"pts_cn": cn, "n_real": M, "lattice_reso": reso}
        args = (None, None), (extra, extra)
    else:
        pts = rng.integers(0, reso + 1, (B, M, 3)).astype(np.int16)
        if case == "int8_short":
            pts[1, M - 40:] = 0
            kw = {"transfer_dtype": jnp.int8}, {"transfer_dtype": "int8"}
        args = (pts, pts), ({"lattice_reso": reso}, {"lattice_reso": reso})
    (jp, tp), (jkw, tkw) = args
    want = jgen.decode_points_batched(state, jp, jc, **jkw, **kw[0])
    got = tgen.decode_points_batched(tmodel, tp, tc, **tkw, **kw[1])
    assert got.shape == (B, M) and got.dtype == np.float32
    if case != "int8_short":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    tf = tgen.decode_points_batched(tmodel, tp, tc, lattice_reso=reso,
                                    transfer_dtype=torch.float32)
    scale = np.abs(tf).max(axis=1) / 127        # node 0's logit among them
    jscale = np.abs(want).max(axis=1) / 127
    np.testing.assert_allclose(scale, jscale, rtol=1e-6)
    np.testing.assert_allclose(np.abs(got).max(axis=1) / 127, scale, rtol=1e-6)
    _one_step_apart(np.rint(got / scale[:, None]), np.rint(want / jscale[:, None]))


@pytest.mark.parametrize("thresholds,engine,transfer", [
    ("scalar", "native", "float32"), ("list", "numpy", "int8"),
    ("none", "native", "float32")])
def test_multires_decode_batched_matches_jax(pair, monkeypatch, thresholds, engine,
                                             transfer):
    """Batched MISE in both packages on the same grids: levels (a scalar,
    per-object, or None for each object's coarse mean), query counts and
    grids as in tests/test_torch_mise.py. The native engines take the
    prepacked ``query_cn`` upload, the numpy engines the stacked int16
    upload with zeros after a short object's points, here at int8
    transfer, where those slots set the object's scale: there values are
    equal up to the float rounding of q·scale or one int8 step apart, at
    under 1 % of the points. An object may hold up to two undecided values
    (``settled``; each masks a 7³ block of its 17³ grid). Four host threads
    give the port's serial result bit for bit."""
    cfg, jmodel, state, tmodel = pair
    jgen, tgen = _gens(cfg, jmodel, tmodel, transfer)
    if engine == "numpy":
        monkeypatch.setattr(jmise, "MultiGridExtractor", jmise.MultiGridExtractorNumpy)
        monkeypatch.setattr(tmise, "MultiGridExtractor", tmise.MultiGridExtractorNumpy)
    g = _grids(cfg, seed=3)
    jc, tc = {"grid": jnp.asarray(g)}, {"grid": T(g)}
    coarse = jgen.decode_dense_batched(state, 9, jc, transfer_dtype=jnp.float32)
    thr = {"scalar": float(coarse.mean()),
           "list": [(float(v.min()) + float(v.max())) / 2 for v in coarse],
           "none": None}[thresholds]
    jst, tst = {}, {}
    jgrids, jthr = jmise.multires_decode_batched(jgen, state, jc, 8, 1, thr, stats=jst)
    monkeypatch.setattr(tmise, "HOST_THREADS", 1)
    tgrids, tthr = tmise.multires_decode_batched(tgen, tmodel, tc, 8, 1, thr, stats=tst)
    monkeypatch.setattr(tmise, "HOST_THREADS", 4)
    threaded, thr4 = tmise.multires_decode_batched(tgen, tmodel, tc, 8, 1, thr)
    assert thr4 == tthr and len(tgrids) == B
    for a, b in zip(threaded, tgrids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tthr, jthr, atol=1e-6, rtol=0)
    assert tst["query_pts"] == jst["query_pts"] and 0 < tst["query_pts"][0] < 17 ** 3
    print(f"{thresholds} {engine} {transfer}: query_pts {tst['query_pts']}")
    for t, j, lt, lj in zip(tgrids, jgrids, tthr, jthr):
        j = np.asarray(j)
        keep, n_near = settled(t, lt, j, lj)
        assert n_near <= 2 and keep.mean() > 0.85
        np.testing.assert_array_equal((t >= lt)[keep], (j >= lj)[keep])
        if transfer == "float32":
            np.testing.assert_allclose(t[keep], j[keep], atol=1e-5, rtol=0)
        else:
            step = np.abs(j).max() / 127 * 1.0001
            d = np.abs(t - j)[keep]
            assert d.max() <= step and (d > 1e-3 * step).mean() < 0.01


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A synthetic set whose test split holds 3 objects, VTacO at
    _small_cfg's widths (nx = 16), and weights from a seed in both
    packages."""
    root = tmp_path_factory.mktemp("served")
    data = jax_generate(str(root / "synth"), n_models=5, n_query=500, n_surface=1000,
                        img_h=IMG_H, img_w=IMG_W, seed=7,
                        splits=(("train", 0.2), ("val", 0.2), ("test", 0.6)))
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *data)
    cfg["generation"]["resolution_0"] = 4
    return (root, cfg) + _pair(cfg, seed=23)


def _float32_transfers(monkeypatch):
    """Both packages' ``decode_dense_batched`` at float32 transfers, for
    the comparisons of ``run_batched`` (see test_run_batched_matches_jax)."""
    for cls, f32 in ((JGen, jnp.float32), (TGen, torch.float32)):
        def patched(self, *a, _orig=cls.decode_dense_batched, _f32=f32, **kw):
            return _orig(self, *a, **{**kw, "transfer_dtype": _f32})

        monkeypatch.setattr(cls, "decode_dense_batched", patched)


def test_run_batched_matches_jax(served, monkeypatch, tmp_path):
    """``run_batched`` over the 3-object test split, two objects per
    flight (a full flight, then one of one object). As it runs, at the
    decode's bfloat16 transfer: the split's names, and each ``.off`` file
    the marching cubes of the port's own ``decode_dense_batched``. Then
    against the JAX package, both at float32 transfers: the same names, no
    empty mesh, the same faces, vertices as in tests/test_torch_generate.py
    (within their files' %.6f rounding) and chamfer distances within 1e-5. (The two packages' float32 logits
    differ by about 1e-7, so at bfloat16 a logit that close to a rounding
    boundary rounds to the neighbouring step in one package only, 4 of
    8,192 on this split; a vertex count then differs, and with it every
    one of the chamfer's 2048 draws.)"""
    _, cfg, jmodel, state, tmodel = served
    batches = _batches(cfg, "test")
    assert len(batches) == 3
    names = [b["points.name"][0] for b in batches]
    jgen, tgen = _gens(cfg, jmodel, tmodel)
    got = Inferencer.from_config(tmodel, tgen, cfg).run_batched(
        tmodel, batches, batch_size=2, out_dir=str(tmp_path / "bf16"))
    assert set(got) == {"names", "cd", "cd_mean", "n_empty"}
    assert got["names"] == names and got["n_empty"] == 0
    nx, box = 16, 1 + cfg["data"]["padding"]
    for s in (slice(0, 2), slice(2, 3)):
        inputs = np.stack([np.asarray(b["inputs"])[0] for b in batches[s]])
        with torch.no_grad():
            logits = tgen.decode_dense_batched(tmodel, nx, tmodel.encode_inputs(T(inputs)))
        for name, v in zip(names[s], logits):
            verts, faces = marching_cubes(v.reshape(nx, nx, nx))
            fv, ff = meshio.read_off(str(tmp_path / "bf16" / f"{name}_obj.off"))
            np.testing.assert_array_equal(ff, faces)
            np.testing.assert_allclose(fv, (verts - nx / 2) * box / nx, atol=1e-6, rtol=0)

    _float32_transfers(monkeypatch)
    want = JInferencer.from_config(jmodel, jgen, cfg).run_batched(
        state, batches, batch_size=2, out_dir=str(tmp_path / "jax"))
    got = Inferencer.from_config(tmodel, tgen, cfg).run_batched(
        tmodel, batches, batch_size=2, out_dir=str(tmp_path / "port"))
    assert got["names"] == want["names"] == names
    assert got["n_empty"] == want["n_empty"] == 0
    np.testing.assert_allclose(got["cd"], want["cd"], atol=1e-5, rtol=0)
    assert abs(got["cd_mean"] - want["cd_mean"]) <= 1e-5
    for s in (slice(0, 2), slice(2, 3)):
        inputs = np.stack([np.asarray(b["inputs"])[0] for b in batches[s]])
        jc = jgen._apply(state, jmodel.encode_inputs, jnp.asarray(inputs), train=False)
        with torch.no_grad():
            tc = tmodel.encode_inputs(T(inputs))
        jgrids = jgen.decode_dense_batched(state, nx, jc)
        tgrids = tgen.decode_dense_batched(tmodel, nx, tc)
        for name, j, t in zip(names[s], jgrids, tgrids):
            tv, tf = meshio.read_off(str(tmp_path / "port" / f"{name}_obj.off"))
            jv, jf = meshio.read_off(str(tmp_path / "jax" / f"{name}_obj.off"))
            assert len(tf) > 20
            np.testing.assert_array_equal(tf, jf)
            # the vertices as in tests/test_torch_generate.py, plus the
            # files' rounding
            bound = _vertex_bound(jv * nx / box + nx / 2, j.reshape(nx, nx, nx),
                                  float(np.abs(t - j).max()))
            assert (np.abs(tv - jv).max(axis=1) <= bound * box / nx + 1e-6).all()


def test_batched_cli_matches_jax(served, monkeypatch, capsys):
    """``cli.generate --batched 2`` in both packages from checkpoints of
    the same weights (each in its own format) on the 3-object test split,
    at float32 transfers (see test_run_batched_matches_jax) and with each
    item's input drawn from a seed of its own: the same last line,
    ``cd_mean`` within 1e-5."""
    from vtaco_tpu.cli.generate import main as jax_main
    from vtaco_tpu_torch.cli.generate import main as port_main

    root, cfg, jmodel, state, tmodel = served
    _float32_transfers(monkeypatch)
    for cls in (JaxDataset, Shapes3dDataset):
        # each item's input subsample and noise from its own seed: the JAX
        # CLI draws a batch from the split before its loader runs
        def seeded(self, idx, _orig=cls.__getitem__):
            np.random.seed(100 + idx)
            return _orig(self, idx)

        monkeypatch.setattr(cls, "__getitem__", seeded)
    lines = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        out = root / f"cli_{pkg}"
        c = copy.deepcopy(cfg)
        c["training"].update(out_dir=str(out), n_workers_val=1)
        if pkg == "jax":
            first = _batches(cfg, "train")[0]
            full = JaxTrainer.from_config(jmodel, cfg).init_state_abstract(first)
            JaxCheckpointIO(str(out), state=full.replace(
                params=state.params, batch_stats=state.batch_stats)).save("model.ckpt")
        else:
            CheckpointIO(str(out), model=tmodel).save("model.ckpt")
        path = root / f"cli_{pkg}.yaml"
        path.write_text(yaml.safe_dump(c))
        capsys.readouterr()
        main([str(path), "--cpu", "--checkpoint", "model.ckpt", "--batched", "2"])
        lines[pkg] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(os.listdir(out / "generation")) == 3
    got, want = lines["port"], lines["jax"]
    assert set(got) == {"split", "n", "cd_mean", "batched"}
    assert {k: got[k] for k in ("split", "n", "batched")} == \
        {k: want[k] for k in ("split", "n", "batched")} == \
        {"split": "test", "n": 3, "batched": 2}
    assert abs(got["cd_mean"] - want["cd_mean"]) <= 1e-5
