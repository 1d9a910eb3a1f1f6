"""The scene_crop config (``data.input_type: pointcloud_crop``) in the
PyTorch port (vtaco_tpu_torch) against the JAX package, on the CPU at the
small widths of tests/test_trainer.py::test_crop_mode_trains (hidden 8,
U-Net depth 2, query_vol_size 16): the crop geometry helpers, the local
coordinates and plane sampling, the crop data fields, the crop encoder
and decoder on carried weights, the plain train step on a crop batch, the
crop decode through ``eval_points``, the two faults of the JAX package the
port keeps as raises (F6, ROADMAP.md §3), and the train CLI on the
shipped config.

The crop centre is drawn from numpy's global random state in
``get_vol_info``, so each package's sample is drawn right after one seed,
with one loader worker. Tolerances: geometry helpers and data fields bit
for bit; local coordinates and plane sampling 1e-6; module outputs 1e-5
(relative to the largest entry where that exceeds 1);
the step's loss scalars 1e-5 relative, each parameter's gradient within
1e-5 of its largest entry or at a cosine of at least 0.99999; the crop
decode 1e-5 at float32 transfers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.core.config import load_config
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import collate_batch as jax_collate
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JaxGenerator
from vtaco_tpu.ops import geometry as JG
from vtaco_tpu.ops import interp as JI
from vtaco_tpu.ops import local_coords as JL
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data.core import collate_batch
from vtaco_tpu_torch.ops import geometry as G
from vtaco_tpu_torch.ops.interp import interp_plane
from vtaco_tpu_torch.ops.local_coords import map2local, positional_encoding
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_fast import share_cores  # noqa: F401
from test_torch_setup import random_tree


def t(x):
    return torch.as_tensor(np.array(x))


def crop_cfg(root, **model):
    """configs/crop/scene_crop.yaml at test_crop_mode_trains' widths."""
    cfg = load_config("configs/crop/scene_crop.yaml", "configs/default.yaml")
    cfg["data"].update(path=root, points_subsample=128, pointcloud_n=128,
                       query_vol_size=16)
    enc = cfg["model"]["encoder_kwargs"]
    enc["hidden_dim"] = 8
    enc["unet_kwargs"].update(depth=2, start_filts=8)
    enc["unet3d_kwargs"]["num_levels"] = 1
    cfg["model"]["decoder_kwargs"]["hidden_size"] = 16
    cfg["model"].update(model)
    cfg["training"]["matmul_precision"] = "highest"
    cfg["generation"]["batch_size"] = 300
    return cfg


def close(got, want, tol):
    """Within ``tol`` of the reference, relative to its largest entry where
    that exceeds 1 (random weights give fields of tens)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def close_grads(got, want, report):
    """Each parameter's gradient within 1e-5 of its largest entry, or at a
    cosine of at least 0.99999."""
    for k, ref in want.items():
        g = got[k].numpy().astype(np.float64).ravel()
        r = np.asarray(ref, np.float64).ravel()
        err = np.abs(g - r).max()
        scale = np.abs(r).max()
        cos = g @ r / max(np.linalg.norm(g) * np.linalg.norm(r), 1e-300)
        report[k] = (err, scale, cos)
        assert err <= 1e-5 * scale or cos >= 0.99999, (k, err, scale, cos)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Four scenes (two train, one val, one test) with enough query points
    that every train crop holds some."""
    return jax_generate(str(tmp_path_factory.mktemp("synth_crop")), n_models=4,
                        n_query=4000, n_surface=1000, img_h=16, img_w=12, seed=3)


@pytest.fixture(scope="module")
def crop(synth):
    """Both packages' trainers on one crop config and random weights
    (every leaf nonzero), and one train batch of two."""
    cfg = crop_cfg(synth[0])
    jds = jax_get_dataset("train", copy.deepcopy(cfg))
    jmodel, _ = jax_get_model(copy.deepcopy(cfg), dataset=jds)
    jtr = JaxTrainer.from_config(jmodel, cfg)
    np.random.seed(0)
    batch = next(iter(JaxBatchLoader(jds, batch_size=2, num_workers=1, seed=0)))
    shapes = jtr.init_state_abstract(batch)
    rng = np.random.default_rng(4)
    params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
    return cfg, jtr, batch, params, stats


# ---------------------------------------------------------------------------
# geometry, local coordinates, plane sampling

def test_crop_geometry_matches_jax():
    """normalize_coord, coord2index (the upper face lands in the next row;
    only an index above reso^k is clamped), update_reso and
    decide_total_volume_range, bit for bit."""
    rng = np.random.default_rng(0)
    vol = [np.array([-0.2, -0.1, -0.3], np.float32), np.array([0.28, 0.38, 0.18], np.float32)]
    p = rng.uniform(-0.35, 0.45, (3000, 3)).astype(np.float32)
    p[:6] = vol[1]                      # the upper corner
    p[6:12, 0] = vol[1][0]              # the upper x face
    for plane in ("xz", "xy", "yz", "grid"):
        np.testing.assert_array_equal(G.normalize_coord(p, vol, plane),
                                      JG.normalize_coord(p, vol, plane))
        for reso in (8, 24):
            np.testing.assert_array_equal(G.coord2index(p, vol, reso, plane),
                                          JG.coord2index(p, vol, reso, plane))
    for reso in range(1, 70):
        for depth in (1, 2, 4, 5):
            assert G.update_reso(reso, depth) == JG.update_reso(reso, depth)
    for args in ((1.1, 32, 0.02, 4), (1.1, 8, 0.02, 2), (100000, 32, 0.02, 4),
                 (0.5, 16, 0.1, 3)):
        got, want = G.decide_total_volume_range(*args), JG.decide_total_volume_range(*args)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert G.decide_total_volume_range(1.1, 32, 0.02, 4)[2] == 88


def test_local_coords_and_interp_plane_match_jax():
    """map2local (negative coordinates included) with and without the
    positional encoding, and interp_plane, bilinear and nearest, at
    coordinates outside [0, 1] too, within 1e-6."""
    rng = np.random.default_rng(1)
    p = rng.uniform(-0.6, 0.6, (2, 500, 3)).astype(np.float32)
    for enc in ("linear", "sin_cos"):
        np.testing.assert_allclose(map2local(t(p), 0.02, enc).numpy(),
                                   np.asarray(JL.map2local(jnp.asarray(p), 0.02, enc)),
                                   atol=1e-6, rtol=0)
    u = rng.uniform(0, 1, (2, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(positional_encoding(t(u)).numpy(),
                               np.asarray(JL.positional_encoding(jnp.asarray(u))),
                               atol=1e-6, rtol=0)
    fea = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (2, 600, 2)).astype(np.float32)
    uv[:, :4] = [[0, 0], [1, 1], [0.5, 0.5], [1, 0]]
    for mode in ("bilinear", "nearest"):
        np.testing.assert_allclose(
            interp_plane(t(fea), t(uv), mode).numpy(),
            np.asarray(JI.interp_plane(jnp.asarray(fea), jnp.asarray(uv), mode)),
            atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# data

@pytest.mark.parametrize("split", ["train", "val"])
def test_crop_fields_bit_equal(synth, split):
    """Under one seed each package's crop sample is the same, bit for bit:
    the crop volume, the masked cloud and its overflow indices, the query
    points and their normalized coordinates; the batch that collate_batch
    stacks as well."""
    cfg = crop_cfg(synth[0])
    jds = jax_get_dataset(split, copy.deepcopy(cfg))
    pds = get_dataset(split, cfg)
    assert (pds.depth, pds.total_reso) == (jds.depth, jds.total_reso)
    for i in range(len(jds)):
        np.random.seed(10 + i)
        want = jds[i]
        np.random.seed(10 + i)
        got = pds[i]
        if want is None:
            assert got is None
            continue
        assert set(got) == set(want) and {"inputs.ind.xz", "points.normalized.yz",
                                          "inputs.mask", "pointcloud_crop"} <= set(got)
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v
                continue
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the loaders' producer threads draw ahead from the global state, so
    # the stacking is compared on samples drawn here
    np.random.seed(0)
    jb = jax_collate([jds[0], jds[0]])
    np.random.seed(0)
    pb = collate_batch([pds[0], pds[0]])
    assert set(pb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)


def test_partial_pointcloud_inputs_bit_equal(synth):
    """``data.input_type: partial_pointcloud`` (PartialPointCloudField: a
    random side, cut at a random length, then subsampled and noised) draws
    the same sample as the JAX package's under one seed."""
    cfg = load_config("configs/VTacO/VTacO_YCB.yaml", "configs/default.yaml")
    cfg["data"].update(path=synth[0], input_type="partial_pointcloud", pointcloud_n=128)
    jds, pds = jax_get_dataset("train", copy.deepcopy(cfg)), get_dataset("train", cfg)
    for i in range(len(jds)):
        np.random.seed(20 + i)
        want = jds[i]
        np.random.seed(20 + i)
        got = pds[i]
        assert set(got) == set(want) and got["inputs"].shape == (128, 3)
        for k in ("inputs", "inputs.normals"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# models and the train step

@pytest.mark.parametrize("coords", ["linear", "local_sin_cos"])
def test_crop_modules_match_jax(synth, crop, coords):
    """PatchLocalPoolPointnet (pools over reso² + 1 cells, the overflow
    cell dropped, then the plane U-Nets) and PatchLocalDecoder on the JAX
    package's weights: a whole scene_crop tree loads with strict=True,
    and the fields and logits agree within 1e-5; with model.local_coord
    and the sin/cos encoding as well (the kwargs propagate from the model
    level, as in the JAX factory)."""
    cfg, jtr, batch, params, stats = crop
    if coords != "linear":
        cfg = crop_cfg(synth[0], local_coord=True, pos_encoding="sin_cos")
        jds = jax_get_dataset("train", copy.deepcopy(cfg))
        jmodel, _ = jax_get_model(copy.deepcopy(cfg), dataset=jds)
        jtr = JaxTrainer.from_config(jmodel, cfg)
        shapes = jtr.init_state_abstract(batch)
        rng = np.random.default_rng(5)
        params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
    model = get_model(cfg, device="cpu", dataset=get_dataset("train", cfg))
    assert model.encoder.plane_resolution == 24 and model.encoder.local_coord == (
        coords != "linear")
    load_jax_params(model, params, stats)
    a = jtr.prepare_batch(batch)
    v = {"params": params, "batch_stats": stats}
    enc_in = {"points": a["inputs"], "index": a["inputs_index"]}
    jc = jtr.model.apply(v, enc_in, train=False, method=jtr.model.encode_inputs)
    p_in = {"p": a["points"], "p_n": a["points_normalized"]}
    jl = jtr.model.apply(v, p_in, jc, method=jtr.model.decode)
    with torch.no_grad():
        tc = model.encode_inputs({"points": t(a["inputs"]),
                                  "index": {k: t(x).long() for k, x in a["inputs_index"].items()}})
        tl = model.decode({"p": t(a["points"]),
                           "p_n": {k: t(x) for k, x in a["points_normalized"].items()}}, tc)
    assert set(tc) == set(jc) == {"xz", "xy", "yz"}
    for k in jc:
        assert tc[k].shape == (2, 24, 24, 32)
        close(tc[k].numpy(), jc[k], 1e-5)
    close(tl.numpy(), jl, 1e-5)


def test_crop_train_step_and_f6a(crop):
    """One scene_crop train step (the plain loss path on the crop dict
    forms) against the JAX package's loss and gradients; then the eval
    step on a crop batch raises in both packages (F6 (a): the JAX IoU
    hands the crop encoder the bare cloud)."""
    from vtaco_tpu.core import torch_import as TI

    cfg, jtr, batch, params, stats = crop
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    a = jtr.prepare_batch(batch)

    def loss_fn(p):
        return jtr._compute_loss(p, state.batch_stats, state.rng, a)

    (_, (want, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    model = get_model(cfg, device="cpu", dataset=get_dataset("train", cfg))
    load_jax_params(model, params, stats)
    tr = Trainer.from_config(model, cfg)
    got = tr.train_step(batch)
    assert set(got) == {k for k in want} == {"loss", "loss_l1", "loss_mano", "loss_pc"}
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-5, abs=1e-7), (k, got[k], float(v))
    grads = {n: p.grad for n, p in model.named_parameters()}
    jg = TI.export_state_dict(jgrads, {})
    assert set(jg) == set(grads) and all(g is not None for g in grads.values())
    close_grads(grads, jg, {})

    vds = jax_get_dataset("val", copy.deepcopy(cfg))
    vb = next(iter(JaxBatchLoader(vds, 1, shuffle=False, num_workers=1)))
    with pytest.raises(TypeError, match="string indexing"):
        jtr.eval_step(state, vb)
    with pytest.raises(NotImplementedError, match=r"F6 \(a\)"):
        tr.eval_step(vb)


# ---------------------------------------------------------------------------
# generation

def test_crop_eval_points_and_f6b(crop):
    """eval_points on a crop model (the test split's whole-scene
    resolution): the chunked module decode (1000 points in chunks of 300,
    the last one padded), each chunk normalized into the scene's input
    volume, against the JAX package's within 1e-5 at float32 transfers.
    generate_obj_mesh_wnf on the crop batch raises in both packages (F6
    (b): the batch holds no object scan), and so does
    decode_points_batched (F6 (c): its legacy decode hands the crop
    decoder bare points)."""
    cfg, jtr, _, params, stats = crop
    jds = jax_get_dataset("test", copy.deepcopy(cfg))
    jmodel, _ = jax_get_model(copy.deepcopy(cfg), dataset=jds)
    jgen = JaxGenerator.from_config(jmodel, cfg)
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    np.random.seed(1)
    tb = next(iter(JaxBatchLoader(jds, 1, shuffle=False, num_workers=1)))
    a = jtr.prepare_batch(tb)
    v = {"params": params, "batch_stats": stats}
    jc = jmodel.apply(v, {"points": a["inputs"], "index": a["inputs_index"]}, train=False,
                      method=jmodel.encode_inputs)
    model = get_model(cfg, device="cpu", dataset=get_dataset("test", cfg))
    assert model.encoder.plane_resolution == jds.total_reso == 62
    load_jax_params(model, params, stats)
    gen = get_generator(model, cfg)
    assert gen.points_batch_size == 300 and gen.input_type == "pointcloud_crop"
    np.testing.assert_array_equal(gen.input_vol[0], jgen.input_vol[0])
    with torch.no_grad():
        tc = model.encode_inputs({"points": t(a["inputs"]),
                                  "index": {k: t(x).long() for k, x in a["inputs_index"].items()}})
    pts = np.random.default_rng(2).uniform(-0.6, 0.6, (1000, 3)).astype(np.float32)
    want = np.asarray(jgen.eval_points(state, pts, jc, transfer_dtype=jnp.float32))
    got = gen.eval_points(model, pts, tc, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(KeyError, match="pc_ply"):
        jgen.generate_obj_mesh_wnf(state, tb)
    with pytest.raises(NotImplementedError, match=r"F6 \(b\)"):
        gen.generate_obj_mesh_wnf(model, tb)
    with pytest.raises(TypeError, match="string indexing"):
        jgen.decode_points_batched(state, pts[None, :50], jc)
    with pytest.raises(NotImplementedError, match=r"F6 \(c\)"):
        gen.decode_points_batched(model, pts[None, :50], tc)


# ---------------------------------------------------------------------------
# the CLI

def test_scene_crop_trains_through_cli(synth, tmp_path):
    """python -m vtaco_tpu_torch.cli.train configs/crop/scene_crop.yaml
    --cpu at the shipped full width: 2 steps on the synthetic set, then
    model.ckpt holds the 56² training planes' model."""
    from vtaco_tpu_torch.cli.train import main

    out = tmp_path / "out"
    main(["configs/crop/scene_crop.yaml", "--cpu", "--data-root", synth[0],
          "--max-iters", "2", "--out-dir", str(out)])
    payload, scalars = CheckpointIO(str(out)).load_raw("model.ckpt")
    assert scalars["it"] == 2
    sd = payload["model"]
    assert sd["encoder.fc_c.weight"].shape == (32, 32)
    assert sd["decoder.fc_out.weight"].shape == (1, 32)
    assert all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point())
