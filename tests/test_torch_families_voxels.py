"""Voxel inputs in the PyTorch port (vtaco_tpu_torch) against the JAX
package on the CPU: binvox files, the voxel encoders, ``input_type:
voxels`` data, the voxel IoU, and the voxel model's dense decode.

binvox writes and reads byte for byte, the voxels' cell indices into the
fields index for index (the port's centres come from torch.linspace, the
JAX package's from jnp.linspace), a dataset item key for key and bit for
bit. ``LocalVoxelEncoder`` on a grid (UNet3D) and on planes (a UNet2D
each) and ``VoxelEncoder``, in float64 and float32 at tests/families.py's
``assert_matches_jax`` tolerances. fam_vox (tests/families.py) through the plain path's train and
eval steps with ``iou_voxels`` (tests/families.py's tolerances), and its
dense decode (the plain version of K2's trunk) and lattice ``eval_points``
within 1e-5 at float32 transfers. F8 (c) beside the JAX package's
failures.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.data import binvox_rw as jbinvox
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.device_data import DeviceDataset as JDeviceDataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.models import voxels as JV
from vtaco_tpu.ops import geometry as JG
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data import binvox_rw
from vtaco_tpu_torch.data.device_data import DeviceDataset
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models import voxels as TV
from vtaco_tpu_torch.ops import geometry as TG

from families import (assert_matches_jax, check_steps, family_cfg, jax_f64, jax_state,
                      loaders, trainers)
from test_torch_fast import share_cores  # noqa: F401
from test_torch_setup import random_tree
from voxel_files import write_voxels


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root, mesh_root = jax_generate(str(tmp_path_factory.mktemp("synth_vox")), n_models=4,
                                   n_query=2000, n_surface=1000, img_h=16, img_w=12,
                                   seed=7)
    write_voxels(root)
    return root, mesh_root


@pytest.mark.parametrize("fix_coords", [True, False])
def test_binvox_roundtrip_matches_jax(tmp_path, fix_coords):
    """A random cube, an all-occupied one (runs longer than 255 cells) and
    a non-cubic grid (which, in both packages, reads back in another
    shape: the header's dims are the grid's, the data the transposed
    grid's)."""
    rng = np.random.default_rng(0)
    grids = {"cube": rng.random((6, 6, 6)) > 0.6, "full": np.ones((40,) * 3, bool),
             "box": rng.random((8, 6, 5)) > 0.6}
    for name, data in grids.items():
        v = binvox_rw.Voxels(data, list(data.shape), [0.1, -0.2, 0.3], 1.5, "xyz")
        jv = jbinvox.Voxels(data, list(data.shape), [0.1, -0.2, 0.3], 1.5, "xyz")
        with open(tmp_path / f"{name}.binvox", "wb") as f:
            binvox_rw.write(v, f)
        with open(tmp_path / f"{name}_jax.binvox", "wb") as f:
            jbinvox.write(jv, f)
        raw = (tmp_path / f"{name}.binvox").read_bytes()
        assert raw == (tmp_path / f"{name}_jax.binvox").read_bytes()
        with open(tmp_path / f"{name}.binvox", "rb") as f:
            got = binvox_rw.read_as_3d_array(f, fix_coords=fix_coords)
        with open(tmp_path / f"{name}.binvox", "rb") as f:
            want = jbinvox.read_as_3d_array(f, fix_coords=fix_coords)
        np.testing.assert_array_equal(got.data, want.data)
        assert (got.dims, got.translate, got.scale, got.axis_order) == (
            want.dims, want.translate, want.scale, want.axis_order)
        if fix_coords and name != "box":
            np.testing.assert_array_equal(got.data, data)


@pytest.mark.parametrize("D,reso", [(32, 64), (32, 32), (12, 8), (7, 5)])
def test_voxel_cell_indices_match_jax(D, reso):
    """Where each voxel's features land: the grid cell and each plane's."""
    jc = jnp.linspace(-0.5, 0.5, D)
    jp = jnp.stack(jnp.meshgrid(jc, jc, jc, indexing="ij"), -1).reshape(1, -1, 3)
    tc = torch.linspace(-0.5, 0.5, D)
    tp = torch.stack(torch.meshgrid(tc, tc, tc, indexing="ij"), -1).reshape(1, -1, 3)
    want = JG.coordinate2index(JG.normalize_3d_coordinate(jp, padding=0.1), reso, "3d")
    got = TG.coordinate2index(TG.normalize_3d_coordinate(tp, padding=0.1), reso, "3d")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for plane in ("xz", "xy", "yz"):
        want = JG.coordinate2index(JG.normalize_coordinate(jp, 0.1, plane), reso, "2d")
        got = TG.coordinate2index(TG.normalize_coordinate(tp, 0.1, plane), reso, "2d")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoder_pair(jenc, tenc, x, train=False):
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              train=False))
    params = random_tree(shapes["params"], rng)
    enc = load_jax_params(tenc, params, {})
    def run(v, x):
        return jenc.apply(v, x, train=train)

    with jax.default_matmul_precision("highest"):
        want = run({"params": params}, jnp.asarray(x))
    want64 = jax_f64(run, {"params": params}, x)
    with torch.no_grad():
        got = enc(T(x))
        ex = copy.deepcopy(enc).double()(T(x).double())
    return got, want, ex, want64


@pytest.mark.parametrize("kind", ["grid", "planes"])
def test_local_voxel_encoder_matches_jax(kind):
    x = (np.random.default_rng(5).random((2, 12, 12, 12)) > 0.7).astype(np.float32)
    if kind == "grid":
        kw = dict(c_dim=8, plane_type=["grid"], grid_resolution=8, unet3d=True,
                  unet3d_kwargs=dict(num_levels=2, f_maps=8, in_channels=8,
                                     out_channels=8))
    else:
        kw = dict(c_dim=8, plane_type=["xz", "yz"], plane_resolution=8, unet=True,
                  unet_kwargs=dict(depth=2, start_filts=8))
    got, want, ex, want64 = _encoder_pair(JV.LocalVoxelEncoder(**kw),
                                          TV.LocalVoxelEncoder(**kw), x)
    assert set(got) == set(want) == ({"grid"} if kind == "grid" else {"xz", "yz"})
    for k in got:
        assert got[k].shape == want[k].shape
        assert_matches_jax(k, got[k].numpy(), np.asarray(want[k]), ex[k].numpy(), want64[k])


def test_voxel_encoder_matches_jax():
    x = (np.random.default_rng(6).random((2, 32, 32, 32)) > 0.7).astype(np.float32)
    got, want, ex, want64 = _encoder_pair(JV.VoxelEncoder(c_dim=8), TV.VoxelEncoder(c_dim=8),
                                          x)
    assert_matches_jax("c", got.numpy(), np.asarray(want), ex.numpy(), want64)


def test_voxel_dataset_items_match_jax(synth):
    cfg = family_cfg(synth, "vox")
    for split in ("train", "val"):
        jds = jax_get_dataset(split, cfg)
        ds = get_dataset(split, cfg)
        np.random.seed(3)
        want = jds[0]
        np.random.seed(3)
        got = ds[0]
        assert set(got) == set(want)
        assert got["inputs"].shape == (32,) * 3 and got["inputs"].any()   # voxel_files' side
        assert ("voxels" in got) == (split == "val")
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


def test_vox_steps_match_jax(synth):
    """The plain path's train step and the eval step with ``iou_voxels``
    (the voxel grid's cell centres decoded, sigmoid at the threshold). The
    JAX package's float32 encoder gradients stray 0.80 % from the float64
    step (the port's 2.5e-5; ``python tests/families.py``), so the
    gradients are held in float64 on both sides (tests/families.py)."""
    cfg = family_cfg(synth, "vox")
    model = get_model(cfg, device="cpu")
    assert isinstance(model.encoder, TV.LocalVoxelEncoder) and model.encoder_hand is None
    scalars, _, _ = check_steps(cfg)
    assert "iou_voxels" in scalars and 0 < scalars["iou_voxels"] <= 1


def test_vox_dense_decode_matches_jax(synth):
    """The voxel model's feature grid, then the dense decode (the port's
    plain version of K2's trunk on the CPU) and the lattice eval_points of
    the JAX package's grid."""
    cfg = family_cfg(synth, "vox")
    jtr, _ = trainers(cfg)
    batch = loaders(cfg, "test", 1, shuffle=False)
    params, stats, state = jax_state(jtr, batch)
    jgen = JGen.from_config(jtr.model, cfg, use_pallas=False)
    jc = jgen._apply(state, jtr.model.encode_inputs, jnp.asarray(batch["inputs"]),
                     train=False)
    model = load_jax_params(get_model(cfg, device="cpu"), params, stats)
    gen = TGen.from_config(model, cfg)
    assert gen._fast_capable(model)
    want64 = jax_f64(lambda v, x: jtr.model.apply(v, x, method=jtr.model.encode_inputs,
                                                  train=False),
                     {"params": params, "batch_stats": stats}, batch["inputs"])
    with torch.no_grad():
        got = model.encode_inputs(T(batch["inputs"]))["grid"].numpy()
        ex = copy.deepcopy(model).double().encode_inputs(
            T(batch["inputs"]).double())["grid"].numpy()
    assert_matches_jax("grid", got, np.asarray(jc["grid"]), ex, want64["grid"])
    c = {"grid": T(jc["grid"])}
    want = jgen.eval_points_dense(state, 16, jc, transfer_dtype=jnp.float32)
    got = gen.eval_points_dense(model, 16, c, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    pts = 1.1 * TG.make_3d_grid((-0.5,) * 3, (0.5,) * 3, (12,) * 3)
    want = jgen.eval_points(state, pts, jc, transfer_dtype=jnp.float32)
    got = gen.eval_points(model, pts, c, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_voxel_batch_faults_match_jax(synth):
    """F8 (c): a hand encoder on a voxel batch, the object mesh of a voxel
    batch (no inputs.pc_ply), and device-resident voxel data fail in the
    JAX package, and the port raises at each."""
    cfg = family_cfg(synth, "vox")
    with_hand = copy.deepcopy(cfg)
    with_hand["model"]["encoder_hand"] = "pointnet_local_pool"
    batch = loaders(cfg, "train", 2, seed=0)
    jtr, _ = trainers(with_hand)
    with pytest.raises(ValueError, match="unpack"):
        jtr.init_state_abstract(batch)
    model = get_model(with_hand, device="cpu")
    with pytest.raises(NotImplementedError, match=r"F8 \(c\)"):
        model.encode_hand_inputs(T(batch["inputs"]))

    jtr, _ = trainers(cfg)
    tb = loaders(cfg, "test", 1, shuffle=False)
    params, stats, state = jax_state(jtr, tb)
    with pytest.raises(KeyError, match="inputs.pc_ply"):
        JGen.from_config(jtr.model, cfg).generate_obj_mesh_wnf(state, tb)
    model = load_jax_params(get_model(cfg, device="cpu"), params, stats)
    with pytest.raises(NotImplementedError, match=r"F8 \(c\)"):
        TGen.from_config(model, cfg).generate_obj_mesh_wnf(model, tb)

    jds = jax_get_dataset("train", cfg)
    fused = jtr.make_fused_train_fn(JDeviceDataset(jds), 64, 128)
    with pytest.raises(ValueError, match="unpack"):
        fused(state, jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(NotImplementedError, match=r"F8 \(c\)"):
        DeviceDataset(get_dataset("train", cfg), device="cpu")
