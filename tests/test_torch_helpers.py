"""The JAX package's public helpers in the PyTorch port (ROADMAP.md §1
item 18) and the crop generator's ``vol_bound`` (item 7), each against
the JAX function on the same numpy inputs from a seed, on the CPU.

``test_public_names_ported``: an AST diff of the public names of both
packages (module-level functions, classes and names, and the classes'
methods; a name the port's module or class has at run time, inherited
or assigned, counts as present) leaves only the names ROADMAP.md §1
lists as needing no port.

Tolerances: geometry 1e-6 absolute (float32 in both packages;
``rotmat_projection`` 1e-5, two LAPACK SVDs in float32); ``Camera`` also
as tests/test_geometry.py holds the JAX one; ``hand_joint_error`` exact
(float64 on the host in both); ``dense_query_grid`` exact; the dense
feature volumes 1e-6 on a grid and on a three-plane config;
``supercell_packed_volume`` bit for bit; the point encoder's
``generate_*_features`` 1e-4, as tests/test_torch_models.py holds the
encoder's grid (the U-Nets' float32 convolutions sum in another order);
the dataset's completeness checks, the factory
names and ``vol_bound`` equal.
"""

import ast
import copy
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import config as jax_config
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.generate.generator import Generator3D as JaxGenerator3D
from vtaco_tpu.models.mano import ManoLayer as JaxManoLayer
from vtaco_tpu.ops import dense_decode as JD
from vtaco_tpu.ops import geometry as JG
from vtaco_tpu.ops import metrics as JM
from vtaco_tpu.train import trainer as jax_trainer
from vtaco_tpu_torch.core import config, factory
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.data import core as data_core
from vtaco_tpu_torch.data.synthetic import generate
from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.models.mano import ManoLayer
from vtaco_tpu_torch.ops import dense_decode as D
from vtaco_tpu_torch.ops import geometry as G
from vtaco_tpu_torch.ops import metrics as M
from vtaco_tpu_torch.train import trainer
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_crop import crop_cfg
from test_torch_setup import build_pair
from test_trainer import _small_cfg

GEOM_TOL = 1e-6


def T(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, tol=GEOM_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol, err


def test_camera_matches_jax():
    """The back-projection of numpy and tensor depth maps, the valid mask
    and the intrinsics, as tests/test_geometry.py holds the JAX camera."""
    rng = np.random.default_rng(0)
    cam, jcam = (C(width=24, height=32, near_plane=0.019, far_plane=0.022, fov=60)
                 for C in (G.Camera, JG.Camera))
    np.testing.assert_array_equal(cam.intrinsic_matrix, jcam.intrinsic_matrix)
    depth = rng.uniform(0.019, 0.0222, (32, 24)).astype(np.float32)
    want = jcam.depth_to_camera_pointcloud(depth)
    got = cam.depth_to_camera_pointcloud(depth)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cam.valid_mask(got), jcam.valid_mask(want))
    got_t = cam.depth_to_camera_pointcloud(T(depth))
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
    close(got_t, jcam.depth_to_camera_pointcloud(jnp.asarray(depth)))
    mask = cam.valid_mask(got_t).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jcam.valid_mask(want)))
    assert 0 < mask.sum() < mask.size
    flat = cam.depth_to_camera_pointcloud(torch.full((32, 24), 0.020))
    assert flat.shape == (32 * 24, 3)
    close(flat[:, 0], np.full(32 * 24, 0.020))
    assert cam.valid_mask(flat).all()
    assert not cam.valid_mask(cam.depth_to_camera_pointcloud(torch.full((32, 24), 0.022))).any()


def test_projections_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, 50, 3)).astype(np.float32)
    rt = rng.standard_normal((2, 3, 4)).astype(np.float32)
    K = np.tile(np.array([[200.0, 0, 12], [0, 200.0, 16], [0, 0, 1]], np.float32), (2, 1, 1))
    pts_front = pts + np.array([0, 0, 4], np.float32)
    close(G.transform_points(T(pts), T(rt)), JG.transform_points(jnp.asarray(pts), jnp.asarray(rt)))
    close(G.transform_points(T(pts), T(K)), JG.transform_points(jnp.asarray(pts), jnp.asarray(K)),
          tol=1e-4)   # values of hundreds: 1e-6 relative
    got = G.project_to_camera(T(pts_front), T(K))
    want = JG.project_to_camera(jnp.asarray(pts_front), jnp.asarray(K))
    close(got / 100.0, np.asarray(want) / 100.0)


def test_rotations_match_jax():
    """rotmat_projection (reflections among the inputs) and the
    quaternion algebra."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    r = rng.standard_normal((64, 4)).astype(np.float32)
    mats = (np.asarray(JG.quat2mat(jnp.asarray(q)))
            + 0.2 * rng.standard_normal((64, 3, 3))).astype(np.float32)
    mats[::2, :, 0] *= -1
    want = np.asarray(JG.rotmat_projection(jnp.asarray(mats)))
    assert (np.linalg.det(mats) < 0).sum() >= 16
    got = G.rotmat_projection(T(mats))
    close(got, want, tol=1e-5)
    close(torch.linalg.det(got), np.ones(64), tol=1e-5)
    jq, jr = jnp.asarray(q), jnp.asarray(r)
    close(G.quaternion_mul(T(q), T(r)), JG.quaternion_mul(jq, jr))
    close(G.quaternion_inv(T(q)), JG.quaternion_inv(jq))
    close(G.quaternion_normalize(T(q)), JG.quaternion_normalize(jq))
    close(G.quaternion_to_rotation_matrix(T(q)), JG.quaternion_to_rotation_matrix(jq))
    assert G.quaternion_to_rotation_matrix is G.quat2mat


def test_metrics_match_jax():
    """hand_joint_error exactly (float64 arrays and tensors, with and
    without the batch axis), and the EMD's reference name."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((1, 21, 3)), rng.standard_normal((1, 21, 3))
    want = JM.hand_joint_error(a, b)
    assert M.hand_joint_error(a, b) == want
    assert M.hand_joint_error(T(a), T(b)) == want
    assert M.hand_joint_error(T(a[0]), b[0]) == want
    assert M.EarthMoverDistance is M.earth_mover_distance
    p, q = rng.standard_normal((40, 3)), rng.standard_normal((40, 3))
    assert M.EarthMoverDistance(p, q) == JM.EarthMoverDistance(p, q)


@pytest.mark.parametrize("fields", [("grid",), ("xz", "xy", "yz")])
def test_dense_volumes_match_jax(fields):
    """The particle-order dense helpers (x slowest) on a grid config and
    a three-plane config, nx = 9 over R = 5."""
    rng = np.random.default_rng(4)
    nx, box, pad, C = 9, 1.1, 0.1, 6
    c = {k: rng.standard_normal((1,) + (5,) * (3 if k == "grid" else 2) + (C,)).astype(
        np.float32) for k in fields}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: T(v) for k, v in c.items()}
    np.testing.assert_array_equal(D.dense_query_grid(nx, box, device="cpu").numpy(),
                                  JD.dense_query_grid(nx, box))
    close(D.dense_feature_volume(tc, nx, box, pad), JD.dense_feature_volume(jc, nx, box, pad))
    for k in fields:
        if k == "grid":
            close(D.dense_grid_features_simple(tc[k], nx, box, pad),
                  JD.dense_grid_features_simple(jc[k], nx, box, pad))
        else:
            close(D.dense_plane_features(tc[k], k, nx, box, pad),
                  JD.dense_plane_features(jc[k], k, nx, box, pad))
    # the channels-first form these views are taken from
    close(D.dense_feature_volume_cn(tc, nx, box, pad), JD.dense_feature_volume_cn(jc, nx, box, pad))
    close(D.dense_query_grid_cn(nx, box, device="cpu"), JD.dense_query_grid_cn(nx, box))


@pytest.mark.parametrize("L", [1, 2])
def test_supercell_packed_volume_matches_jax(L):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    vol, n1 = D.supercell_packed_volume(T(g), S=16, L=L)
    jvol, jn1 = JD.supercell_packed_volume(jnp.asarray(g), 16, L)
    assert n1 == jn1
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol))


def test_point_encoder_field_methods_match_jax():
    """generate_grid_features (object encoder, UNet3D) and
    generate_plane_features (hand encoder, UNet2D) on the same weights
    and point features."""
    cfg, jmodel, variables, tmodel = build_pair(8, seed=6)
    rng = np.random.default_rng(6)
    p = rng.uniform(-0.55, 0.55, (2, 64, 3)).astype(np.float32)
    c = rng.standard_normal((2, 64, 8)).astype(np.float32)

    def run(enc_name, name, *extra):
        want = np.asarray(jmodel.apply(
            variables, jnp.asarray(p), jnp.asarray(c),
            method=lambda m, pp, cc: getattr(getattr(m, enc_name), name)(
                pp, cc, *extra, train=False)))
        with torch.no_grad():
            got = getattr(getattr(tmodel, enc_name), name)(T(p), T(c), *extra)
        close(got, want, tol=1e-4)

    run("encoder", "generate_grid_features")
    run("encoder_hand", "generate_plane_features", "xz")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("synth_helpers")), n_models=4, n_query=300,
                    n_surface=500, img_h=16, img_w=12, seed=9)


def test_dataset_completeness_matches_jax(synth):
    """Every field's check_complete, test_model_complete and
    get_model_dict on a split with one model's point cloud removed."""
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    sets = [(get_dataset(s, cfg, return_idx=True), jax_get_dataset(s, copy.deepcopy(cfg),
                                                                   return_idx=True))
            for s in ("train", "test")]
    ds, _ = sets[0]
    gone = ds.get_model_dict(0)
    os.remove(os.path.join(ds.dataset_folder, gone["category"], gone["model"],
                           "pointcloud.npz"))
    seen = set()
    for ds, jds in sets:
        assert [type(f).__name__ for f in ds.fields.values()] == [
            type(f).__name__ for f in jds.fields.values()]
        for i in range(len(ds)):
            m = ds.get_model_dict(i)
            assert m == jds.get_model_dict(i)
            files = os.listdir(os.path.join(ds.dataset_folder, m["category"], m["model"]))
            for f, jf in zip(ds.fields.values(), jds.fields.values()):
                assert f.check_complete(files) == jf.check_complete(files)
            ok = ds.test_model_complete(m["category"], m["model"])
            assert ok == jds.test_model_complete(m["category"], m["model"])
            seen.add((m["model"], ok))
    assert (gone["model"], False) in seen and any(ok for _, ok in seen)


def test_factory_names_match_jax(synth):
    """DEFAULT_CONFIG, get_trainer, get_inferencer, get_data_fields,
    DEPTH_FAR and ManoLayer.th_faces."""
    assert os.path.samefile(config.DEFAULT_CONFIG, jax_config.DEFAULT_CONFIG)
    assert factory.get_data_fields is data_core.get_data_fields
    assert trainer.DEPTH_FAR == jax_trainer.DEPTH_FAR
    cfg = _small_cfg("configs/tactile/tactile_test.yaml", *synth)
    model = get_model(cfg, device="cpu")
    tr = config.get_trainer(model, cfg, seed=4)
    assert isinstance(tr, Trainer) and tr.seed == 4 and tr.train_tactile
    gen = config.get_generator(model, cfg)
    inf = config.get_inferencer(model, gen, cfg)
    assert isinstance(inf, Inferencer) and inf.generator is gen and inf.train_tactile
    mano, jmano = ManoLayer(), JaxManoLayer()
    assert mano.th_faces is mano.faces
    np.testing.assert_array_equal(mano.th_faces.numpy(), np.asarray(jmano.th_faces))


@pytest.mark.parametrize("sliding", [True, False])
def test_vol_bound_matches_jax(synth, sliding):
    """scene_crop's vol_bound with generation.sliding_window, and None
    without it."""
    cfg = crop_cfg(synth[0])
    cfg["generation"]["sliding_window"] = sliding
    jmodel, _ = jax_config.get_model(copy.deepcopy(cfg))
    want = JaxGenerator3D.from_config(jmodel, copy.deepcopy(cfg)).vol_bound
    got = Generator3D.from_config(get_model(cfg, device="cpu"), cfg).vol_bound
    assert got == want
    assert (got is not None) == sliding


# JAX, XLA or flax names that need no port (ROADMAP.md §1), by module;
# the modules' flax ``setup`` hooks are left out by name
NO_PORT = {
    "parallel/mesh.py": {"batch_sharding", "put_global", "replicate", "replicated"},
    "parallel/tp.py": {"tp_sharding"},
    "train/trainer.py": {"TrainState", "Trainer.init_state_abstract"},
    "models/unet3d.py": {"SmallChannelConv3"},
    "generate/generator.py": {"Generator3D.lower_dense_fast", "Generator3D.transfer_dtype"},
    "core/checkpoint.py": {"import_torch_bn", "import_torch_conv", "import_torch_convtranspose",
                           "import_torch_linear", "load_partial_params"},
    "utils/profiling.py": {"annotate"},
}
ABSENT = object()
NO_PORT_FILES = {"core/cache.py", "core/torch_import.py", "models/mano_assets.py",
                 "ops/pallas/__init__.py", "ops/pallas/decode.py"}


def _public_names(path):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")}
    return names


def test_public_names_ported():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_root = os.path.join(root, "vtaco_tpu")
    missing, no_file = {}, set()
    for dirpath, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
            if not os.path.exists(os.path.join(root, "vtaco_tpu_torch", rel)):
                no_file.add(rel)
                continue
            mod = importlib.import_module("vtaco_tpu_torch." + rel[:-3].replace(os.sep, "."))
            for name in _public_names(os.path.join(jax_root, rel)):
                obj = mod
                for part in name.split("."):
                    obj = getattr(obj, part, ABSENT)
                if obj is ABSENT and not name.endswith(".setup"):
                    missing.setdefault(rel, set()).add(name)
    assert no_file == NO_PORT_FILES
    assert missing == NO_PORT
