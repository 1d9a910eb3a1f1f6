"""The attention decoder and its fusion transformer (``attention_local``)
in the PyTorch port (vtaco_tpu_torch) against the JAX package on the CPU.

Each fusion part alone (TransNonlinear, RelationUnit, MultiheadAttention
with two heads, PositionEmbeddingLearned with its BatchNorm in train
mode) and TransformerFusion with positional embeddings and two layers,
in train and eval mode; the weight tying (one self-attention module for
both stacks and every layer, one cross-attention: the state_dict holds
each tensor once, and the strict load sets the one module both stacks
run); AttentionDecoder's three forwards. All in float64 and float32 at
tests/families.py's ``assert_matches_jax`` tolerances. Then fam_att (tests/families.py): the
t2d_img train and eval steps (tests/families.py's tolerances), and its
chunked decode with contact gates in chunks of 100 points (the fusion's
normalizations run per chunk, so both packages use the same chunks),
within 1e-5 at float32 transfers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.models import decoder as JD
from vtaco_tpu.models import fusion as JF
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models import decoder as TD
from vtaco_tpu_torch.models import fusion as TF
from vtaco_tpu_torch.ops import geometry as TG

from families import (assert_matches_jax, check_steps, family_cfg, jax_f64, jax_state,
                      loaders, trainers)
from test_torch_fast import share_cores  # noqa: F401
from test_torch_setup import random_tree


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth_att")), n_models=4,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


def _pair(jmod, tmod, args, method=None, train=False, **kw):
    """(port output, JAX output, float64 port output, float64 JAX output,
    the port module) on random weights."""
    rng = np.random.default_rng(7)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, method=method,
                                              **kw))
    params = random_tree(shapes["params"], rng)
    stats = random_tree(shapes.get("batch_stats", {}), rng)
    tmod = load_jax_params(tmod, params, stats)
    exact = copy.deepcopy(tmod).double()
    variables = {"params": params, "batch_stats": stats}

    def run(v, *a):
        out = jmod.apply(v, *a, method=method, mutable=["batch_stats"] if train else False,
                         **kw)
        return out[0] if train else out

    with jax.default_matmul_precision("highest"):
        want = run(variables, *jargs)
    want64 = jax_f64(run, variables, *args)
    targs = [None if a is None else T(a) for a in args]
    call = getattr(tmod, method.__name__) if method is not None else tmod
    call64 = getattr(exact, method.__name__) if method is not None else exact
    with torch.no_grad():
        got = call(*targs, **kw)
        ex = call64(*[None if a is None else a.double() for a in targs], **kw)
    return got, want, ex, want64, tmod


def _feats(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_fusion_parts_match_jax():
    rng = np.random.default_rng(8)
    q, k = _feats(rng, 2, 10, 8), _feats(rng, 2, 12, 8)
    got, want, ex, want64, _ = _pair(JF.TransNonlinear(8, 16), TF.TransNonlinear(8, 16),
                                     [q])
    assert_matches_jax("TransNonlinear", got.numpy(), np.asarray(want), ex.numpy(), want64)
    got, want, ex, want64, _ = _pair(JF.RelationUnit(8, 4), TF.RelationUnit(8, 4),
                                     [q, k, k])
    assert_matches_jax("RelationUnit", got.numpy(), np.asarray(want), ex.numpy(), want64)
    got, want, ex, want64, _ = _pair(JF.MultiheadAttention(8, 2, 4),
                                     TF.MultiheadAttention(8, 2, 4), [q, k, k])
    assert got.shape == (2, 10, 16)
    assert_matches_jax("MultiheadAttention", got.numpy(), np.asarray(want), ex.numpy(),
                       want64)


@pytest.mark.parametrize("train", [True, False])
def test_position_embedding_matches_jax(train):
    """The encoder stack's positional embedding alone (Linear, BatchNorm,
    ReLU, Linear), its BatchNorm on batch statistics with ``train``."""
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-0.5, 0.5, (2, 20, 3)).astype(np.float32)
    kw = dict(d_model=8, num_layers=1, key_feature_dim=4, with_pos_embed=True)
    jmod, mod = JF.TransformerFusion(**kw), TF.TransformerFusion(**kw)
    x = jnp.zeros((1, 5, 8))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, x[..., :3], x,
                                              x[..., :3]))
    params, stats = random_tree(shapes["params"], rng), random_tree(shapes["batch_stats"], rng)
    load_jax_params(mod, params, stats)
    pos = mod.encoder.layers[0].self_posembed
    def run(v, p):
        return jmod.apply(v, p, method=lambda m, p: m.encoder_pos_embed(p, train=train),
                          mutable=["batch_stats"])

    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        want, mut = run(variables, jnp.asarray(xyz))
    want64, _ = jax_f64(run, variables, xyz)
    with torch.no_grad():
        got = pos(T(xyz), train)
        ex = copy.deepcopy(pos).double()(T(xyz).double(), train)
    assert_matches_jax("pos", got.numpy(), np.asarray(want), ex.numpy(), want64)
    moved = TI.export_state_dict({}, mut["batch_stats"])
    sd = mod.state_dict()
    for k, v in moved.items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert int(pos.position_embedding_head[1].num_batches_tracked) == int(train)


@pytest.mark.parametrize("train", [True, False])
def test_transformer_fusion_matches_jax(train):
    rng = np.random.default_rng(10)
    args = [_feats(rng, 2, 10, 8), rng.uniform(-1, 1, (2, 10, 3)).astype(np.float32),
            _feats(rng, 2, 12, 8), rng.uniform(-1, 1, (2, 12, 3)).astype(np.float32)]
    kw = dict(d_model=8, num_layers=2, key_feature_dim=4, with_pos_embed=True)
    got, want, ex, want64, mod = _pair(JF.TransformerFusion(**kw),
                                       TF.TransformerFusion(**kw), args, train=train)
    assert_matches_jax("fusion", got.numpy(), np.asarray(want), ex.numpy(), want64)


def test_fusion_weight_tying():
    """One self-attention and one cross-attention, each registered once
    under the reference's canonical name and run by every layer of both
    stacks: the state_dict is the JAX export's, and a strict load sets
    the modules each stack calls."""
    kw = dict(d_model=8, num_layers=2, key_feature_dim=4, with_pos_embed=False)
    jmod, mod = JF.TransformerFusion(**kw), TF.TransformerFusion(**kw)
    x = jnp.zeros((1, 5, 8))
    params = random_tree(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x, None, x, None))["params"],
        np.random.default_rng(11))
    export = TI.export_state_dict(params, {})
    assert set(mod.state_dict()) == set(export)
    assert len(list(mod.parameters())) == len(export)
    load_jax_params(mod, params, {})
    calls = []
    for stack in ("encoder", "decoder"):
        for name, sub in getattr(mod, stack).layers[0].named_children():
            sub.register_forward_hook(lambda m, i, o, tag=f"{stack}.{name}": calls.append(tag))
    with torch.no_grad():
        mod(torch.ones(1, 5, 8), None, torch.ones(1, 5, 8), None)
    # two encoder layers (self), two decoder layers (self, cross)
    assert calls == ["encoder.self_attn"] * 2 + ["encoder.self_attn",
                                                  "decoder.cross_attn"] * 2
    w = mod.encoder.layers[0].self_attn.head[0].WK.weight
    np.testing.assert_array_equal(
        w.detach().numpy(), export["encoder.layers.0.self_attn.head.0.WK.weight"])


@pytest.mark.parametrize("with_contact", [False, True])
def test_attention_decoder_forwards_match_jax(with_contact):
    rng = np.random.default_rng(12)
    kw = dict(c_dim=8, hidden_size=16, n_blocks=3, with_contact=with_contact)
    p = rng.uniform(-0.55, 0.55, (2, 30, 3)).astype(np.float32)
    grid = _feats(rng, 2, 5, 5, 5, 8)
    c_img = _feats(rng, 2, 30, 8)
    jdec = JD.AttentionDecoder(**kw)

    def every(m, p, c, ci):
        m(p, c)
        m.forward_img(p, c, ci)
        if with_contact:
            m.forward_contact(p, c)

    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), jnp.asarray(p),
                                              {"grid": jnp.asarray(grid)},
                                              jnp.asarray(c_img), method=every))
    params = random_tree(shapes["params"], rng)
    dec = load_jax_params(TD.AttentionDecoder(**kw), params, {})
    assert not isinstance(dec, TD.LocalDecoder) and not hasattr(dec, "fc_p_img")
    exact = copy.deepcopy(dec).double()
    methods = ["__call__", "forward_img"] + (["forward_contact"] if with_contact else [])
    for name in methods:
        args = [p, {"grid": grid}] + ([c_img] if name == "forward_img" else [])
        jargs = [jnp.asarray(a) if not isinstance(a, dict) else
                 {k: jnp.asarray(v) for k, v in a.items()} for a in args]
        targs = [T(a) if not isinstance(a, dict) else {k: T(v) for k, v in a.items()}
                 for a in args]
        dargs = [a.double() if isinstance(a, torch.Tensor) else
                 {k: v.double() for k, v in a.items()} for a in targs]
        def run(v, *a):
            return jdec.apply(v, *a, method=None if name == "__call__" else getattr(jdec, name))

        with jax.default_matmul_precision("highest"):
            want = run({"params": params}, *jargs)
        want64 = jax_f64(run, {"params": params}, *args)
        tname = "forward" if name == "__call__" else name
        dec.train()      # the fusion keeps dropout off, as in the JAX package
        with torch.no_grad():
            got, ex = getattr(dec, tname)(*targs), getattr(exact, tname)(*dargs)
        for g, w, e, w64 in zip(*(o if isinstance(o, tuple) else (o,)
                                  for o in (got, want, ex, want64))):
            assert_matches_jax(name, g.numpy(), np.asarray(w), e.numpy(), w64)


def test_att_steps_match_jax(synth):
    cfg = family_cfg(synth, "att")
    model = get_model(cfg, device="cpu")
    assert isinstance(model.decoder, TD.AttentionDecoder)
    check_steps(cfg)


@pytest.mark.parametrize("gating", ["none", "contact"])
def test_att_chunked_decode_matches_jax(synth, gating):
    """fam_att's 8³ grid decode in chunks of 100 points (the last one
    padded with zeros), through the fusion in each chunk (with contact
    gates; without them the plain head). The contacts sit on lattice
    points, so every chunk holds tactile rows: in a chunk with none, the
    fusion's search stream is a constant sequence, its InstanceNorm
    divides rounding noise by sqrt(1e-5), and both packages' logits are
    that noise (they differ by 1e-4 at a scale of 0.5 on this model)."""
    cfg = family_cfg(synth, "att")
    cfg["generation"]["batch_size"] = 100
    jtr, _ = trainers(cfg)
    batch = loaders(cfg, "test", 1, shuffle=False)
    params, stats, state = jax_state(jtr, batch)
    jgen = JGen.from_config(jtr.model, cfg)
    jc = jgen._apply(state, jtr.model.encode_inputs, jnp.asarray(batch["inputs"]),
                     train=False)
    rng = np.random.default_rng(13)
    gates = (None, None, None)
    if gating == "contact":
        lattice = 1.1 * TG.make_3d_grid((-0.5,) * 3, (0.5,) * 3, (8,) * 3)
        q = lattice[np.linspace(3, 508, 40).astype(np.int64)].reshape(5, 8, 3)
        gates = (q.astype(np.float32), rng.standard_normal((5, 32)).astype(np.float32),
                 rng.random((5, 8)) > 0.2)
    want = jgen.eval_points_dense(
        state, 8, jc, gating, *[None if g is None else jnp.asarray(g) for g in gates],
        transfer_dtype=jnp.float32)
    model = load_jax_params(get_model(cfg, device="cpu"), params, stats)
    gen = TGen.from_config(model, cfg)
    assert gen.points_batch_size == 100 and not gen._fast_capable(model)
    got = gen.eval_points_dense(model, 8, {"grid": T(jc["grid"])}, gating,
                                *[None if g is None else T(g) for g in gates],
                                transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
