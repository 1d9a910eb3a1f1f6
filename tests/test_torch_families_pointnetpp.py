"""PointNet++ with the point decoder (``pointnet_plus_plus`` and
``simple_local_point``) in the PyTorch port (vtaco_tpu_torch) against the
JAX package on the CPU.

The helpers index for index: farthest-point sampling and the ball query on
a random cloud and on a lattice full of tied distances (both first-index
tie rules), and the 3-NN interpolation where more than three coarse points
tie (``lax.top_k`` takes the lowest indices); values within 1e-6. The
whole stack at N = 600, c_dim 8, in train mode (outputs and moved
statistics) and eval mode, and LocalPointDecoder in both kernel modes, in
float64 and float32 at tests/families.py's ``assert_matches_jax``
tolerances. Then fam_pn2
(tests/families.py) through the plain loss path's train and eval steps,
and its chunked decode across chunk boundaries (the last chunk padded,
the (points, features) pair passed whole to every chunk) within 1e-5 at
float32 transfers. F8 (b) and (d) beside the JAX package's failures
(the train loop and the generation CLI for (d)).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.models import decoder as JD
from vtaco_tpu.models import pointnetpp as JP
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models import decoder as TD
from vtaco_tpu_torch.models import pointnetpp as TP

from families import (assert_matches_jax, check_steps, family_cfg, jax_f64, jax_state,
                      loaders, trainers)
from test_torch_fast import share_cores  # noqa: F401
from test_torch_setup import random_tree


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth_pn2")), n_models=4,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


def _clouds():
    """A random cloud, and a shuffled 4³ lattice of spacing 0.25 (exact
    squared distances, so many ties)."""
    rng = np.random.default_rng(0)
    rand = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    g = np.stack(np.meshgrid(*[np.arange(4) * 0.25] * 3, indexing="ij"), -1).reshape(-1, 3)
    lattice = np.stack([g[rng.permutation(64)] for _ in range(2)]).astype(np.float32)
    return {"random": rand, "lattice": lattice}


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_sampling_and_grouping_match_jax(kind):
    xyz = _clouds()[kind]
    npoint = 20 if kind == "lattice" else 64
    want = np.asarray(JP.farthest_point_sample(jnp.asarray(xyz), npoint))
    got = TP.farthest_point_sample(T(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    centres = xyz[np.arange(2)[:, None], want]
    for radius, nsample in ((0.3, 8), (0.26, 32)):
        want_g = np.asarray(JP.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                                jnp.asarray(centres)))
        got_g = TP.query_ball_point(radius, nsample, T(xyz), T(centres)).numpy()
        np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_allclose(
        TP.square_distance(T(centres), T(xyz)).numpy(),
        np.asarray(JP.square_distance(jnp.asarray(centres), jnp.asarray(xyz))),
        rtol=0, atol=1e-6)


def test_three_nn_interpolation_with_ties_matches_jax():
    """Each fine point against eight coarse points, the cube corners: the
    origin ties all eight, a face centre ties four; lax.top_k keeps the
    lowest indices, and so must the port."""
    rng = np.random.default_rng(1)
    corners = np.stack(np.meshgrid(*[[-1.0, 1.0]] * 3, indexing="ij"), -1).reshape(1, 8, 3)
    fine = np.concatenate([np.zeros((1, 1, 3)), [[[1.0, 0, 0], [0, -1.0, 0]]],
                           rng.uniform(-1, 1, (1, 5, 3))], axis=1).astype(np.float32)
    feats = rng.standard_normal((1, 8, 5)).astype(np.float32)
    jfp = JP.FeaturePropagation(mlp=())
    want = jfp.apply({}, jnp.asarray(fine), jnp.asarray(corners, jnp.float32), None,
                     jnp.asarray(feats))
    got = TP.FeaturePropagation(5, ())(T(fine), T(corners).float(), None, T(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_pointnetpp_matches_jax(train):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-0.5, 0.5, (2, 600, 3)).astype(np.float32)
    jnet = JP.PointNetPlusPlus(c_dim=8)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                              train=False))
    params = random_tree(shapes["params"], rng)
    stats = random_tree(shapes["batch_stats"], rng)
    net = load_jax_params(TP.PointNetPlusPlus(c_dim=8), params, stats).train(train)
    exact = copy.deepcopy(net).double()
    def run(v, x):
        out = jnet.apply(v, x, train=train, mutable=["batch_stats"] if train else False)
        return out if train else (out, {"batch_stats": {}})

    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        (pts, want), mut = run(variables, jnp.asarray(xyz))
    (_, want64), mut64 = jax_f64(run, variables, xyz)
    with torch.no_grad():
        got_pts, got = net(T(xyz))
        _, ex = exact(T(xyz).double())
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(pts))
    assert_matches_jax("features", got.numpy(), np.asarray(want), ex.numpy(), want64)
    if train:
        sd, sd64 = net.state_dict(), exact.state_dict()
        moved64 = TI.export_state_dict({}, mut64["batch_stats"])
        for k, v in TI.export_state_dict({}, mut["batch_stats"]).items():
            assert_matches_jax(k, sd[k].numpy(), np.asarray(v), sd64[k].numpy(), moved64[k])


@pytest.mark.parametrize("mode", ["gaussian", "inverse"])
def test_local_point_decoder_matches_jax(mode):
    rng = np.random.default_rng(3)
    kw = dict(c_dim=8, hidden_size=16, n_blocks=3, sample_mode=mode)
    p = rng.uniform(-0.55, 0.55, (2, 50, 3)).astype(np.float32)
    cloud = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    fea = rng.standard_normal((2, 300, 8)).astype(np.float32)
    jdec = JD.LocalPointDecoder(**kw)
    c = (jnp.asarray(cloud), jnp.asarray(fea))
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), jnp.asarray(p), c))
    params = random_tree(shapes["params"], rng)
    dec = load_jax_params(TD.LocalPointDecoder(**kw), params, {})
    assert not isinstance(dec, TD.LocalDecoder)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdec.apply({"params": params}, jnp.asarray(p), c))
    want64 = jax_f64(lambda v, p, c: jdec.apply(v, p, c), {"params": params}, p,
                     (cloud, fea))
    with torch.no_grad():
        got = dec(T(p), (T(cloud), T(fea))).numpy()
        ex = copy.deepcopy(dec).double()(T(p).double(),
                                         (T(cloud).double(), T(fea).double())).numpy()
    assert_matches_jax("logits", got, want, ex, want64)


def test_pn2_steps_match_jax(synth):
    """The plain loss path (object and hand encoders, the point decoder on
    the batch's query points) on 600-point clouds. In float32 the ReLUs
    that rounding flips (train-mode BatchNorm over few rows, random
    weights) put the encoder's gradients 0.67 % (JAX) and 0.82 % (port)
    from the float64 step (``python tests/families.py``), so the
    gradients are held in float64 on both sides (tests/families.py)."""
    cfg = family_cfg(synth, "pn2")
    cfg["data"]["pointcloud_n"] = 600
    model = get_model(cfg, device="cpu")
    assert isinstance(model.encoder, TP.PointNetPlusPlus)
    assert isinstance(model.decoder, TD.LocalPointDecoder)
    check_steps(cfg)


def test_pn2_chunked_decode_matches_jax(synth):
    """The dense 16³ decode of fam_pn2 in chunks of 1,000 points (four
    whole chunks and a padded fifth) in both packages, and the port's
    mesh through it."""
    cfg = family_cfg(synth, "pn2")
    cfg["data"]["pointcloud_n"] = 600
    cfg["generation"]["batch_size"] = 1000
    jtr, port = trainers(cfg)
    batch = loaders(cfg, "test", 1, shuffle=False)
    params, stats, state = jax_state(jtr, batch)
    jgen = JGen.from_config(jtr.model, cfg)
    jc = jgen._apply(state, jtr.model.encode_inputs, jnp.asarray(batch["inputs"]),
                     train=False)
    want = jgen.eval_points_dense(state, 16, jc, transfer_dtype=jnp.float32)
    model = load_jax_params(get_model(cfg, device="cpu"), params, stats)
    gen = TGen.from_config(model, cfg)
    assert gen.points_batch_size == 1000 and not gen._fast_capable(model)
    with torch.no_grad():
        c = model.encode_inputs(T(batch["inputs"]))
    assert isinstance(c, tuple) and c[0].shape[1] == 600
    got = gen.eval_points_dense(model, 16, c, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
    assert len(verts) == 0 or np.isfinite(cd)


def test_point_decoder_faults_match_jax(synth, tmp_path):
    """F8 (b): no tactile and no contact head on the point decoder, in
    either package. F8 (d): the JAX Trainer's initialization traces
    decode_img for every decoder, so the JAX package's train loop and
    generation CLI fail on fam_pn2, and the port's raise at the same
    place (its Trainer's steps and Generator stay open, as the JAX
    package's do on weights from ``init``: test_pn2_steps_match_jax,
    test_pn2_chunked_decode_matches_jax)."""
    from vtaco_tpu.cli.generate import main as jax_generate_main
    from vtaco_tpu.train import loop as jax_loop
    from vtaco_tpu_torch.cli.generate import main as generate_main
    from vtaco_tpu_torch.train import loop

    cfg = family_cfg(synth, "pn2")
    cfg["training"]["out_dir"] = str(tmp_path)
    jtr, _ = trainers(cfg)
    batch = loaders(cfg, "train", 2, seed=0)
    with pytest.raises(AttributeError, match="forward_img"):
        jtr.init_state_abstract(batch)
    with pytest.raises(AttributeError, match="forward_img"):
        jax_loop.train(copy.deepcopy(cfg), max_iters=1)
    with pytest.raises(NotImplementedError, match=r"F8 \(d\)"):
        loop.train(copy.deepcopy(cfg), max_iters=1, device="cpu")
    path = tmp_path / "pn2.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(AttributeError, match="forward_img"):
        jax_generate_main([str(path), "--cpu"])
    with pytest.raises(NotImplementedError, match=r"F8 \(d\)"):
        generate_main([str(path), "--cpu"])
    model = get_model(cfg, device="cpu")
    p = torch.zeros(1, 4, 3)
    c = (torch.zeros(1, 5, 3), torch.zeros(1, 5, 32))
    with pytest.raises(NotImplementedError, match=r"F8 \(b\)"):
        model.decode_img(p, c, torch.zeros(1, 4, 32))
    with pytest.raises(NotImplementedError, match=r"F8 \(b\)"):
        model.decode_contact(p, c)
    params, _, _ = jax_state(jtr, batch)
    jc = (jnp.zeros((1, 5, 3)), jnp.zeros((1, 5, 32)))
    for method, args in ((jtr.model.decode_img, (jc, jnp.zeros((1, 4, 32)))),
                         (jtr.model.decode_contact, (jc,))):
        with pytest.raises(AttributeError, match="forward_"):
            jtr.model.apply({"params": params}, jnp.zeros((1, 4, 3)), *args,
                            method=method)
