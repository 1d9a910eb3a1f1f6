"""The rest of the model families' slice in the PyTorch port
(vtaco_tpu_torch) against the JAX package on the CPU: the index encoder
(``encoder: idx``), the MANO helpers, the factory over every registry key,
and F8 (a).

``IndexEncoder`` loads the JAX tree strictly (its one weight is
``encoder.weight``) and returns the same rows, exactly. ``mano_aux`` on
anchor files written to tmp_path: the files load alike, and the anchors,
joint axes and midpoint subdivision (ids, faces, vertices) match within
1e-6. The port's factory builds every encoder and decoder key of the JAX
registry, and ``idx``, each with the JAX package's parameter names and
shapes where both packages build the module. F8 (a): the index encoder's
(B, c_dim) latent reaching a field decoder fails in the JAX package and
raises in the port.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.core.registry import decoder_dict as jax_decoders
from vtaco_tpu.core.registry import encoder_dict as jax_encoders
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.models import mano_aux as JA
from vtaco_tpu.models.pointnet import IndexEncoder as JIndexEncoder
from vtaco_tpu_torch.core import factory
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.models import mano_aux as TA
from vtaco_tpu_torch.models.pointnet import IndexEncoder

from families import family_cfg, loaders, trainers
from test_torch_setup import random_tree


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth_misc")), n_models=4,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


def test_index_encoder_matches_jax():
    rng = np.random.default_rng(0)
    jenc = JIndexEncoder(num_embeddings=7, c_dim=6)
    idx = np.array([3, 0, 6])
    params = random_tree(jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(idx)))["params"], rng)
    holder = torch.nn.Module()
    holder.encoder = IndexEncoder(7, 6)
    load_jax_params(holder, {"encoder": params}, {})
    assert set(holder.state_dict()) == {"encoder.weight"}
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(idx)))
    np.testing.assert_array_equal(holder.encoder(T(idx)).detach().numpy(), want)
    np.testing.assert_array_equal(
        holder.encoder(T(idx.astype(np.float32))).detach().numpy(), want)


def _anchor_files(root, rng):
    os.makedirs(root, exist_ok=True)
    fvi = rng.integers(0, 778, (32, 3))
    w = rng.uniform(0, 1, (32, 2))
    merged = rng.integers(0, 32, 778)
    np.savetxt(os.path.join(root, "face_vertex_idx.txt"), fvi, fmt="%d")
    np.savetxt(os.path.join(root, "anchor_weight.txt"), w)
    np.savetxt(os.path.join(root, "merged_vertex_assignment.txt"), merged, fmt="%d")
    with open(os.path.join(root, "anchor_mapping_path.pkl"), "wb") as f:
        pickle.dump({i: f"anchor{i}" for i in range(32)}, f)


def test_mano_aux_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    _anchor_files(str(tmp_path / "anchors"), rng)
    got, want = TA.load_anchors(str(tmp_path / "anchors")), JA.load_anchors(
        str(tmp_path / "anchors"))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    fvi, weight = got[0], got[1].astype(np.float32)
    verts = rng.standard_normal((2, 778, 3)).astype(np.float32)
    np.testing.assert_allclose(TA.recover_anchors(T(verts), fvi, weight).numpy(),
                               np.asarray(JA.recover_anchors(verts, fvi, weight)),
                               rtol=0, atol=1e-6)
    joints = rng.standard_normal((2, 21, 3)).astype(np.float32)
    transf = np.tile(np.eye(4, dtype=np.float32), (2, 16, 1, 1))
    u, _, vt = np.linalg.svd(rng.standard_normal((2, 16, 3, 3)))
    transf[:, :, :3, :3] = u @ vt
    for g, w in zip(TA.hand_axes(T(joints), T(transf)), JA.hand_axes(joints, transf)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2], [1, 4, 2], [2, 4, 3]])
    v = rng.standard_normal((2, 5, 3)).astype(np.float32)
    edges, new_faces = TA.subdivide_topology(faces, 5)
    jedges, jfaces = JA.subdivide_topology(faces, 5)
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_array_equal(new_faces, jfaces)
    for _ in range(2):
        gv, gf = TA.upsample_mesh(T(v), faces)
        wv, wf = JA.upsample_mesh(v, faces)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gf, wf)
        v, faces = np.asarray(wv), wf
    assert TA.subdivide_topology(faces, 5) is TA.subdivide_topology(faces.copy(), 5)


ENCODERS = sorted(jax_encoders)
DECODERS = sorted(jax_decoders)


def test_registries_match_jax():
    assert set(factory.encoder_dict) == set(jax_encoders)
    assert set(factory.decoder_dict) == set(jax_decoders)


@pytest.mark.parametrize("key", ENCODERS + ["idx"])
def test_factory_builds_every_encoder(synth, key):
    """VTacO_YCB (small widths) with the object encoder set to ``key``
    (an image encoder as ``encoder_img``); the port's parameter names and
    shapes are the JAX package's."""
    cfg = family_cfg(synth, "r50")
    m = cfg["model"]
    if key in ("Resnet18", "Resnet34", "Resnet50", "UNet"):
        m["encoder_img"] = key
        m["encoder_img_kwargs"] = {"num_classes": 32} if key != "UNet" else {
            "num_classes": 1, "depth": 2, "start_filts": 8}
    elif key == "voxel_simple_local":
        cfg = family_cfg(synth, "vox")
    elif key == "pointnet_crop_local_pool":
        m["encoder"] = key
        m["decoder"] = "simple_local_crop"
        m.update(with_img=False, encoder_t2d=False, encoder_hand=False)
    else:
        m["encoder"] = key
        if key == "pointnet_plus_plus":
            m.update(with_img=False, encoder_t2d=False)
    model = get_model(cfg, device="cpu")
    if key == "idx":
        assert isinstance(model.encoder, IndexEncoder) and model.encoder.weight.shape == (1, 32)
        return
    jmodel, _ = jax_get_model(copy.deepcopy(cfg))
    sub = "encoder_img" if key in ("Resnet18", "Resnet34", "Resnet50", "UNet") else "encoder"
    assert type(getattr(model, sub)).__name__ in (
        jax_encoders[key].__name__, "ResNet", "TactileUNet")
    if key in ("pointnet_crop_local_pool", "pointnet_plus_plus", "voxel_simple_local"):
        return       # their trees are held against JAX's in their own tests
    jtr, _ = trainers(cfg)
    shapes = jtr.init_state_abstract(loaders(cfg, "train", 2, seed=0))
    want = {k: v.shape for k, v in TI.export_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats)).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


@pytest.mark.parametrize("key", DECODERS)
def test_factory_builds_every_decoder(synth, key):
    cfg = family_cfg(synth, "r50")
    cfg["model"]["decoder"] = key
    model = get_model(cfg, device="cpu")
    assert type(model.decoder).__name__ == jax_decoders[key].__name__


def test_index_encoder_fault_matches_jax(synth):
    """F8 (a): with ``encoder: idx`` a field decoder gets a (B, c_dim)
    latent where it expects fields: the JAX package fails there (its init
    decodes, decoder.py:77), and the port's decoders raise."""
    cfg = family_cfg(synth, "r50")
    cfg["model"].update(encoder="idx", with_img=False, encoder_t2d=False)
    jtr, _ = trainers(cfg)
    with pytest.raises(IndexError):
        jtr.init_state_abstract(loaders(cfg, "train", 2, seed=0))
    for decoder in ("simple_local", "attention_local"):
        cfg["model"]["decoder"] = decoder
        model = get_model(cfg, device="cpu")
        c = model.encode_inputs(T([0, 0]))
        assert c.shape == (2, 32)
        with pytest.raises(NotImplementedError, match=r"F8 \(a\)"):
            model.decode(torch.zeros(2, 4, 3), c)
