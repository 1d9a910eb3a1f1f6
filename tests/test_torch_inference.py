"""The paper's pipeline through the PyTorch port (vtaco_tpu_torch) against
the JAX package on the same weights (random, carried across by
load_jax_params) and the same loader batches of a small synthetic set:
axis-angle to Euler angles, the hand mesh, the predicted tactile clouds,
``Inferencer.run`` on a split (object and hand meshes, names, the
``n_empty`` / inf contract; the tactile branch's clouds); then the port's
CLIs end to end on the CPU (pretrain the depth stack, train VTacO with its
graft, reconstruct), and the messages of what is not ported.

Widths are tests/test_trainer._small_cfg's, nx = 16. Tolerances: Euler
angles 1e-6; hand vertices and tactile clouds 1e-5 (written files: plus
their %.6f rounding); object meshes as in tests/test_torch_generate.py,
with the decoder's feature conditioning damped and equal occupancy
asserted first; the metrics of a whole-mesh subsample 1e-6.
"""

import copy
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.generate.inferencer import Inferencer as JInferencer
from vtaco_tpu.ops import geometry as JG
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_generator, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.ops import geometry as TG
from vtaco_tpu_torch.utils import meshio

from test_torch_generate import FEATURE_GAIN, MAX_TRI_BOUND, _triangles, _vertex_bound
from test_torch_setup import random_tree
from test_trainer import _small_cfg

IMG_H, IMG_W = 16, 12


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth")), n_models=4, n_query=500,
                        n_surface=1000, img_h=IMG_H, img_w=IMG_W, seed=7)


def _batches(cfg, split):
    np.random.seed(0)
    return list(JaxBatchLoader(jax_get_dataset(split, cfg, return_idx=True), 1,
                               shuffle=False, num_workers=1))


def _pair(cfg, seed, damp=True):
    """(JAX model, JAX state, port model) on the same random weights (every
    leaf nonzero); ``damp`` scales the decoder's fc_c kernels by
    FEATURE_GAIN (tests/test_torch_generate.py)."""
    jmodel, _ = jax_get_model(cfg)
    shapes = JaxTrainer.from_config(jmodel, cfg).init_state_abstract(
        _batches(cfg, "train")[0])
    rng = np.random.default_rng(seed)
    params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
    for name, leaf in params.get("decoder", {}).items():
        if name.startswith("fc_c") and damp:
            leaf["kernel"] = leaf["kernel"] * FEATURE_GAIN
    tmodel = get_model(cfg, device="cpu")
    load_jax_params(tmodel, params, stats)
    return jmodel, SimpleNamespace(params=params, batch_stats=stats), tmodel


@pytest.fixture(scope="module")
def vtaco(synth):
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    cfg["generation"]["resolution_0"] = 4
    # weights whose fields cross the midpoint level with about 1,000
    # triangles in both samples (the seed screened before, 21, gave one
    # sample a blob of 8)
    return (cfg,) + _pair(cfg, seed=23)


@pytest.fixture(scope="module")
def tactile(synth):
    cfg = _small_cfg("configs/tactile/tactile_test.yaml", *synth)
    return (cfg,) + _pair(cfg, seed=22)


def test_axisang_to_euler_xyz_matches_jax():
    """Random rotations and rotations within 0.3 rad of the gimbal lock
    (b = ±π/2) within 1e-6 of the JAX function. Nearer the lock the float32
    conversion is ill-conditioned: arcsin's slope 1/cos b amplifies the
    one-ulp differences of the two libraries' sin, cos and arcsin, so
    there each package is held to scipy's float64 ``as_euler('XYZ')``
    within 3e-7 / cos b (measured: both 2.0e-6 at 0.1 rad, 1.7e-5 at 0.01)."""
    rng = np.random.default_rng(0)
    rotvecs = [rng.standard_normal(3) for _ in range(64)]
    margin = []
    for d in (0.5, 0.3, 0.1, 0.03, 0.01):
        for sign in (1, -1):
            for _ in range(32):
                a, c = rng.uniform(-np.pi, np.pi, 2)
                rotvecs.append(Rotation.from_euler(
                    "XYZ", [a, sign * (np.pi / 2 - d), c]).as_rotvec())
                margin.append(d)
    margin = np.array([np.inf] * 64 + margin)
    rotvecs = np.asarray(rotvecs, np.float32)
    got = np.stack([TG.axisang_to_euler_xyz(T(v)).numpy() for v in rotvecs])
    want = np.stack([np.asarray(JG.axisang_to_euler_xyz(jnp.asarray(v))) for v in rotvecs])
    exact = Rotation.from_rotvec(rotvecs.astype(np.float64)).as_euler("XYZ")
    far = margin >= 0.3
    np.testing.assert_allclose(got[far], want[far], atol=1e-6, rtol=0)
    bound = 3e-7 / np.cos(np.pi / 2 - margin[~far])[:, None]
    for angles in (got, want):
        assert (np.abs(angles[~far] - exact[~far]) <= bound).all()


def test_generate_hand_mesh_matches_jax(vtaco):
    """The MANO prediction in the object's normalized frame: vertices
    within 1e-5, faces equal, for each sample of the val and test
    splits."""
    cfg, jmodel, state, tmodel = vtaco
    jgen, tgen = JGen.from_config(jmodel, cfg), get_generator(tmodel, cfg)
    for batch in _batches(cfg, "val") + _batches(cfg, "test"):
        jv, jf = jgen.generate_hand_mesh(state, batch)
        tv, tf = tgen.generate_hand_mesh(tmodel, batch)
        assert tv.shape == (778, 3) and tv.dtype == np.float32
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tf, jf)


def test_generate_tactile_pc_matches_jax(tactile, vtaco):
    """The predicted depth maps back-projected, moved to the world and
    normalized: (B, 5, H*W, 3) within 1e-5. A model whose encoder_img
    gives features (VTacO's ResNet-18) raises, as in the JAX package."""
    cfg, jmodel, state, tmodel = tactile
    jgen, tgen = JGen.from_config(jmodel, cfg), get_generator(tmodel, cfg)
    batch = _batches(cfg, "val")[0]
    want = jgen.generate_tactile_pc(state, batch)
    got = tgen.generate_tactile_pc(tmodel, batch)
    assert got.shape == (1, 5, IMG_H * IMG_W, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    vcfg, _, _, vmodel = vtaco
    with pytest.raises(ValueError, match="depth-map image encoder"):
        get_generator(vmodel, vcfg).generate_tactile_pc(vmodel, batch)


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return np.loadtxt(lines[lines.index("end_header") + 1:], ndmin=2)


@pytest.mark.parametrize("field", ["damped", "constant", "tactile"])
def test_inferencer_run_matches_jax(vtaco, tactile, tmp_path, field):
    """``Inferencer.run`` over the val and test splits in both packages:
    the same names and ``n_empty``; hand meshes equal (faces) and within
    1e-5 (vertices); object meshes triangle for triangle (the value grids'
    occupancy equal first) with their metrics. Contact gating takes every
    pressed pixel (contact_per_finger = H*W), so that both packages gate
    with the same contact sets. 'constant': a decoder whose output layer
    is zero gives no iso-surface: every object reports inf and counts as
    empty, and the means are None. 'tactile': the depth stack's branch,
    the predicted clouds of each sample."""
    cfg, jmodel, state, tmodel = tactile if field == "tactile" else vtaco
    if field == "constant":
        state = copy.deepcopy(state)
        state.params["decoder"]["fc_out"]["kernel"] *= 0
        tmodel = copy.deepcopy(tmodel)
        torch.nn.init.zeros_(tmodel.decoder.fc_out.weight)
    batches = _batches(cfg, "val") + _batches(cfg, "test")
    kw = dict(contact_per_finger=IMG_H * IMG_W)
    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, transfer_dtype="float32", **kw)
    tgen = get_generator(tmodel, cfg, **kw)
    np.random.seed(0)
    want = JInferencer.from_config(jmodel, jgen, cfg).run(state, batches,
                                                          out_dir=str(tmp_path / "jax"))
    np.random.seed(0)
    got = Inferencer.from_config(tmodel, tgen, cfg).run(tmodel, batches,
                                                        out_dir=str(tmp_path / "port"))
    assert got["names"] == want["names"] and len(got["names"]) == 2
    assert got["n_empty"] == want["n_empty"] == (2 if field == "constant" else 0)
    if field != "damped":
        assert got["cd_mean"] is want["cd_mean"] is None
        assert got["emd_mean"] is want["emd_mean"] is None
    if field == "constant":
        assert np.isinf(got["cd"]).all() and np.isinf(got["emd"]).all()
    for name, batch in zip(got["names"], batches):
        port, jax_ = (lambda s: str(tmp_path / "port" / s), lambda s: str(tmp_path / "jax" / s))
        if field == "tactile":
            a, b = _read_ply(port(f"{name}_tactile.ply")), _read_ply(jax_(f"{name}_tactile.ply"))
            assert a.shape == (5 * IMG_H * IMG_W, 3)
            np.testing.assert_allclose(a, b, atol=1e-5 + 1e-6, rtol=0)
            continue
        tv, tf = meshio.read_off(port(f"{name}_hand.off"))
        jv, jf = meshio.read_off(jax_(f"{name}_hand.off"))
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, atol=1e-5 + 1e-6, rtol=0)
        tv, tf = meshio.read_off(port(f"{name}_obj.off"))
        jv, jf = meshio.read_off(jax_(f"{name}_obj.off"))
        assert (len(tf) > 20) == (field == "damped") and len(jf) == len(tf)
        if field == "constant":
            continue
        _assert_same_mesh(cfg, jgen, state, jmodel, tgen, tmodel, batch, (tv, tf), (jv, jf))
    if field == "damped":
        assert all(len(meshio.read_off(str(tmp_path / "port" / f"{n}_obj.off"))[0]) <= 2048
                   for n in got["names"])     # the whole mesh is the metrics' subsample
        np.testing.assert_allclose(got["cd"], want["cd"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["emd"], want["emd"], atol=1e-6, rtol=0)


def _assert_same_mesh(cfg, jgen, state, jmodel, tgen, tmodel, batch, t_mesh, j_mesh):
    """The value grids behind both meshes on the same side of the midpoint
    level everywhere, then every port triangle within _vertex_bound of one
    JAX triangle (tests/test_torch_generate.py)."""
    nx = cfg["generation"]["resolution_0"] * 4
    J = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v[0], str)}
    Tt = {k: T(v) for k, v in batch.items() if not isinstance(v[0], str)}
    jgates = jgen._build_gates(
        state, J["inputs"], J["inputs.img"], J["inputs.depth"],
        J["inputs.touch_success"] > 0.5, J["inputs.pc_ply"], J["points.mano"],
        J["points.wrist"], J["points.cam_pos"], J["points.cam_rot"])
    jgrid = jgen._apply(state, jmodel.encode_inputs, J["inputs"], train=False)
    jvals = jgen.eval_points_dense(state, nx, jgrid, *jgates, transfer_dtype=jnp.float32)
    with torch.no_grad():
        tgates = tgen._build_gates(tmodel, Tt["inputs.img"], Tt["inputs.depth"],
                                   Tt["inputs.touch_success"] > 0.5, Tt["inputs.pc_ply"],
                                   Tt["points.cam_pos"], Tt["points.cam_rot"])
        tvals = tgen.eval_points_dense(tmodel, nx, tmodel.encode_inputs(Tt["inputs"]),
                                       *tgates, transfer_dtype=torch.float32)
    assert tgates[0] == jgates[0] == "contact"

    def occupied(vals):
        return vals > (vals.min() + vals.max()) / 2

    np.testing.assert_array_equal(occupied(tvals), occupied(jvals))
    (tv, tf), (jv, jf) = t_mesh, j_mesh
    assert (len(tv), len(tf)) == (len(jv), len(jf))
    box = 1 + cfg["data"]["padding"]
    dist, idx = cKDTree(_triangles(jv, jf, nx, box)).query(_triangles(tv, tf, nx, box),
                                                            p=np.inf)
    assert len(np.unique(idx)) == len(idx)
    dv = float(np.abs(tvals - jvals).max())
    bound = _vertex_bound(jv * nx / box + nx / 2, jvals.reshape(nx, nx, nx), dv)
    # plus the files' %.6f rounding, in voxels
    tri_bound = np.minimum(bound[jf].max(axis=1)[idx], MAX_TRI_BOUND) + 1e-6 * nx / box
    assert (dist <= tri_bound).all(), (dist / tri_bound).max()


def _cli_cfg(cfg, out_dir, **training):
    cfg = copy.deepcopy(cfg)
    cfg["training"].update(dict(out_dir=str(out_dir), batch_size=2, n_workers=1,
                                n_workers_val=1, print_every=1, validate_every=-1,
                                checkpoint_every=-1, visualize_every=1), **training)
    return cfg


def test_pipeline_through_the_clis(synth, tmp_path, capsys):
    """The paper's three stages through the port's CLIs on the CPU: the
    depth stack trains one step (the loop's visualization writes its
    clouds), VTacO trains one step with the stack's parameters grafted
    from its absolute ``model_file`` (the visualization writes both
    meshes), then cli.generate reconstructs the test split (object and
    hand meshes, the JSON line) and the depth stack's clouds, whose
    checkpoint is given by an absolute path; a checkpoint that is not
    there warns and the run goes on."""
    from vtaco_tpu_torch.cli import generate, train

    def run(main, cfg, *args):
        path = tmp_path / f"{cfg['training']['out_dir'].split(os.sep)[-1]}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        main([str(path), "--cpu", *args])
        return capsys.readouterr().out

    tac = _cli_cfg(_small_cfg("configs/tactile/tactile_test.yaml", *synth), tmp_path / "tac")
    out = run(train.main, tac, "--max-iters", "1")
    name = _batches(tac, "val")[0]["points.name"][0]
    assert os.path.exists(tmp_path / "tac" / "vis" / f"1_{name}_tactile.ply")
    assert "visualize failed" not in out

    vt = _cli_cfg(_small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth), tmp_path / "vt")
    vt["model"]["encoder_t2d_kwargs"]["model_file"] = str(tmp_path / "tac" / "model.ckpt")
    vt["generation"].update(resolution_0=4, mc_level="mean")
    out = run(train.main, vt, "--max-iters", "1")
    assert "loaded pretrained t2d weights from" in out and "visualize failed" not in out
    for part in ("obj", "hand"):
        assert os.path.exists(tmp_path / "vt" / "vis" / f"1_{name}_{part}.off")
    assert "Metrics CD:" in out

    out = run(generate.main, vt, "--checkpoint", "model.ckpt")
    assert "=> loaded model.ckpt (it=1)" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["split"] == "test" and line["n"] == 1 and np.isfinite(line["cd_mean"])
    assert np.isfinite(line["emd_mean"])
    test_name = _batches(vt, "test")[0]["points.name"][0]
    for part in ("obj", "hand"):
        v, f = meshio.read_off(str(tmp_path / "vt" / "generation" / f"{test_name}_{part}.off"))
        assert len(f) > 0 and np.isfinite(v).all()

    ckpt = str(tmp_path / "tac" / "model.ckpt")
    out = run(generate.main, tac, "--split", "val", "--checkpoint", ckpt,
              "--out-dir", str(tmp_path / "clouds"))
    assert f"=> loaded {ckpt}" in out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "split": "val", "n": 1, "emd_mean": None, "cd_mean": None}
    cloud = _read_ply(str(tmp_path / "clouds" / f"{name}_tactile.ply"))
    assert cloud.shape == (5 * IMG_H * IMG_W, 3) and np.isfinite(cloud).all()

    out = run(generate.main, tac, "--split", "val", "--checkpoint", "absent.ckpt")
    assert "Warning: checkpoint absent.ckpt not found" in out
    assert json.loads(out.strip().splitlines()[-1])["n"] == 1


@pytest.mark.parametrize("what", ["points_unfast", "tensorboard", "profile_dir",
                                  "debug_nans"])
def test_unported_options_raise(synth, tmp_path, what, monkeypatch):
    """Options that raised until they were ported. The chunked legacy
    ``decode_points_batched(fast=False)`` (item 7) equals the JAX
    package's. The loop's TensorBoard, profiler and NaN-debug options,
    which raised until they were ported, now run a step: event files
    beside the jsonl log, a profiler trace in profile_dir (its window
    moved to the first step here), and a finite run under debug_nans
    (tests/test_torch_utils.py plants a NaN)."""
    from vtaco_tpu_torch.train import loop

    cfg = _cli_cfg(_small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth), tmp_path / "out")
    if what == "points_unfast":
        from test_torch_setup import build_pair

        pcfg, jmodel, v, tmodel = build_pair()
        pcfg["generation"]["batch_size"] = 100      # chunks of 100, the last padded
        jgen, gen = JGen.from_config(jmodel, pcfg), get_generator(tmodel, pcfg)
        rng = np.random.default_rng(4)
        g = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
        pts = rng.uniform(-0.6, 0.6, (2, 250, 3)).astype(np.float32)
        want = jgen.decode_points_batched(SimpleNamespace(**v), pts, {"grid": jnp.asarray(g)},
                                          fast=False, transfer_dtype=jnp.float32)
        got = gen.decode_points_batched(tmodel, pts, {"grid": torch.as_tensor(g)},
                                        fast=False, transfer_dtype=torch.float32)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
        with pytest.raises(ValueError, match="lattice_reso"):
            gen.decode_points_batched(tmodel, pts, {"grid": torch.as_tensor(g)},
                                      fast=False, lattice_reso=8)
    else:
        import functools

        from vtaco_tpu_torch.utils.profiling import ProfiledRegion

        prof = str(tmp_path / "prof")
        cfg["training"][what] = prof if what == "profile_dir" else True
        monkeypatch.setattr(loop, "ProfiledRegion",
                            functools.partial(ProfiledRegion, start_step=1, stop_step=1))
        _, it = loop.train(cfg, max_iters=1, device="cpu")
        assert it == 1
        logs = os.listdir(os.path.join(cfg["training"]["out_dir"], "logs"))
        assert "metrics.jsonl" in logs
        assert any(f.startswith("events.out.tfevents") for f in logs) == (what == "tensorboard")
        assert os.listdir(prof) == ["trace_1_1.json"] if what == "profile_dir" else (
            not os.path.exists(prof))


@pytest.mark.parametrize("case", ["planes_dense", "planes_gather", "trainer_no_img"])
def test_unported_messages_name_the_missing_piece(synth, case):
    """Plane fields on the dense decode and the gather route (ROADMAP item
    8; within 1e-5), and a train step without images, the plain loss path
    (items 5 and 7; loss scalars within 1e-5 relative), equal the JAX
    package."""
    from vtaco_tpu.ops import dense_decode as JD
    from vtaco_tpu.ops import fast_trunk as JFT
    from vtaco_tpu_torch.ops import fast_trunk as FT
    from vtaco_tpu_torch.ops.dense_decode import dense_feature_volume_cn
    from vtaco_tpu_torch.train.trainer import Trainer

    from test_torch_setup import build_pair

    rng = np.random.default_rng(9)
    planes = {"grid": rng.standard_normal((1, 4, 4, 4, 8)).astype(np.float32),
              "xz": rng.standard_normal((1, 4, 4, 8)).astype(np.float32)}
    jplanes = {k: jnp.asarray(v) for k, v in planes.items()}
    tplanes = {k: torch.as_tensor(v) for k, v in planes.items()}
    if case == "planes_dense":
        np.testing.assert_allclose(dense_feature_volume_cn(tplanes, 8, 1.1, 0.1).numpy(),
                                   np.asarray(JD.dense_feature_volume_cn(jplanes, 8, 1.1, 0.1)),
                                   atol=1e-6, rtol=0)
    elif case == "planes_gather":
        cfg, jmodel, v, tmodel = build_pair()
        jgen, gen = JGen.from_config(jmodel, cfg), get_generator(tmodel, cfg)
        p = rng.uniform(-0.6, 0.6, (3, 400)).astype(np.float32)
        jtp = JFT.extract_trunk_params(v["params"]["decoder"], tmodel.decoder.n_blocks,
                                       with_img=False)
        want = jgen._decode_scatter_fast_impl(
            jtp, jnp.asarray(p), jplanes, jnp.zeros((1, 3)), jnp.zeros((1, 1)),
            jnp.zeros((1,), bool), "none", jnp.float32, use_pallas=False)
        got = gen._decode_scatter_fast_impl(
            FT.extract_trunk_params(tmodel.decoder, with_img=False), torch.as_tensor(p),
            tplanes, None, None, None, "none", torch.float32, False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    else:
        cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
        cfg["model"].update(with_img=False, encoder_img=False, encoder_t2d=False)
        cfg["training"]["matmul_precision"] = "highest"
        jmodel, state, tmodel = _pair(cfg, seed=3, damp=False)
        jtr = JaxTrainer.from_config(jmodel, cfg)
        batch = _batches(cfg, "train")[0]
        _, want = jtr.train_step(jtr._state_from_variables(
            {"params": state.params, "batch_stats": state.batch_stats}), batch)
        got = Trainer.from_config(tmodel, cfg).train_step(batch)
        assert set(got) == set(want) == {"loss", "loss_l1", "loss_mano", "loss_pc"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
