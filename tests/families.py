"""Shared helpers of tests/test_torch_families_*.py: the model families'
configs at small widths and one train and one eval step of a config held
against the JAX trainer (the voxel files come from tests/voxel_files.py).

A family config is VTacO_YCB at tests/test_trainer.py's small widths with
only the family's keys changed (the on-card families in chip_smoke.py
make the same changes at full width):
  r34, r50  ``model.encoder_img`` Resnet34 / Resnet50;
  pn2       ``encoder: pointnet_plus_plus``, ``decoder: simple_local_point``,
            without images and without the tactile-to-depth model (the
            plain loss path);
  vox       ``data.input_type: voxels`` (``model.binvox``, 32³),
            ``encoder: voxel_simple_local`` on the grid with UNet3D, and
            neither hand encoder, images nor tactile-to-depth model (the JAX
            package fails on a voxel batch with any of them, F8 (c));
  att       ``decoder: attention_local`` with ``input_size`` at the decode
            sample's size (a key neither package reads: the fusion runs
            on whatever chunk it is given).

The port is held to the JAX package in float64 on both sides (the port's
modules in double, the JAX package under ``jax.enable_x64``): every
output, loss scalar and gradient within 1e-9 of the JAX package's,
relative to its largest entry, except gradients that both packages put
below 1e-12 of the model's largest (a bias whose effect a later
normalization removes: zero up to rounding). In float32 each output and
loss scalar must lie within 1e-5 of the JAX package's float64 value, or
no more than twice as far from it as the JAX package's own float32 value
(train-mode BatchNorm over a few rows, deep stacks and ReLUs that rounding
flips carry float32 rounding far past 1e-5 in both packages: ResNet-50's
features 5.0e-4 and gradients 8.2 % in the JAX package; ``report``).
IoUs and the eval step's scalars: 1e-6 absolute and 1e-5 relative, in
float32. The port's float32 steps run with oneDNN off (``ieee_convs``).
"""

import contextlib
import copy
import types

import jax
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer, _cast_floats

from test_torch_setup import random_tree
from test_torch_train import PER_FINGER, jax_draws
from test_trainer import _small_cfg
from voxel_files import write_voxels

def family_cfg(synth, name):
    root, mesh_root = synth
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", root, mesh_root)
    cfg["training"]["matmul_precision"] = "highest"
    cfg["generation"]["resolution_0"] = 4
    m = cfg["model"]
    if name in ("r34", "r50"):
        m["encoder_img"] = {"r34": "Resnet34", "r50": "Resnet50"}[name]
    elif name == "pn2":
        m.update(encoder="pointnet_plus_plus", decoder="simple_local_point",
                 with_img=False, encoder_t2d=False)
    elif name == "vox":
        cfg["data"].update(input_type="voxels", voxels_file="model.binvox")
        m.update(encoder="voxel_simple_local", encoder_hand=False, with_img=False,
                 encoder_t2d=False)
        m["encoder_kwargs"] = {"plane_type": ["grid"], "grid_resolution": 8,
                               "unet3d": True,
                               "unet3d_kwargs": m["encoder_kwargs"]["unet3d_kwargs"]}
    elif name == "att":
        m["decoder"] = "attention_local"
        m["decoder_kwargs"]["input_size"] = cfg["data"]["num_sample"]
    else:
        raise ValueError(name)
    return cfg


def jax_init_shapes(jtr, batch):
    """The JAX trainer's parameter shapes. A simple_local_point model
    never initializes through the JAX Trainer (its init traces decode_img,
    F8 (d)), so for it the modules the plain path runs are initialized
    directly."""
    if jtr.model.decoder.__class__.__name__ != "LocalPointDecoder":
        state = jtr.init_state_abstract(batch)
        return state.params, state.batch_stats
    a = jtr.prepare_batch(batch)

    def init_fn(model):
        c = model.encode_inputs(a["inputs"], train=False)
        if model.encoder_hand is not None:
            model.encode_hand_inputs(a["inputs"], train=False)
        model.decode(a["points"], c)

    shapes = jax.eval_shape(lambda: jtr.model.init(jax.random.PRNGKey(0), method=init_fn))
    return shapes["params"], shapes.get("batch_stats", {})


def jax_state(jtr, batch, seed=6):
    """Random weights (every leaf nonzero) as numpy trees, and the JAX
    TrainState on them."""
    pshapes, sshapes = jax_init_shapes(jtr, batch)
    rng = np.random.default_rng(seed)
    params, stats = random_tree(pshapes, rng), random_tree(sshapes, rng)
    return params, stats, jtr._state_from_variables({"params": params, "batch_stats": stats})


def loaders(cfg, split, batch_size, **kw):
    np.random.seed(0)   # the items' subsampling and noise draw from it
    ds = jax_get_dataset(split, cfg, return_idx=split != "train")
    return next(iter(JaxBatchLoader(ds, batch_size=batch_size, num_workers=1, **kw)))


def trainers(cfg):
    """(the JAX trainer, a function building the port's on JAX trees)."""
    kw = {"contact_per_finger": PER_FINGER} if cfg["model"]["encoder_t2d"] else {}
    jmodel, _ = jax_get_model(copy.deepcopy(cfg))
    jbank = jax_build_mesh_bank(cfg) if cfg["model"]["encoder_t2d"] else None
    jtr = JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, **kw)

    def port(params, stats):
        model = load_jax_params(get_model(cfg, device="cpu"), params, stats)
        return Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"), **kw)

    return jtr, port


def rel(got, want):
    """The largest difference relative to the largest entry of want."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def assert_matches_jax(name, got, want, got64, want64):
    """The port's float64 value within 1e-9 of the JAX package's (both
    relative to the largest entry), and the port's float32 value within
    1e-5 of the JAX package's float64 value or no more than twice as far
    from it as the JAX package's float32 value is."""
    assert rel(got64, want64) <= 1e-9, (name, rel(got64, want64))
    own, theirs = rel(got, want64), rel(want, want64)
    assert own <= max(1e-5, 2 * theirs), (name, own, theirs)


def jax_f64(fn, *args):
    """fn(*args) under jax.enable_x64, every floating leaf of args in
    float64 (a module's weights, its inputs), as numpy."""
    with jax.enable_x64(True):
        out = jax.jit(fn)(*[jax.tree.map(jax.numpy.asarray, _f64(a)) for a in args])
        return jax.tree.map(np.asarray, out)


def port_step_f64(port, params, stats, batch, draws):
    """The port's train step's loss and gradients evaluated in float64 on
    the same weights, batch and draws (the loss path ``_train_step``
    takes, without its float32 scalars and the optimizer's update):
    ({scalar: float}, {parameter: float64 gradient})."""
    tr = port(params, stats)
    tr.model.double().train()
    a = _cast_floats(tr.prepare_batch(batch), torch.float64)
    with ieee_convs():
        if tr.encode_t2d:
            loss, scalars, _ = tr._compute_loss(a, draws)
        elif tr.with_img:
            loss, scalars, _ = tr._compute_loss_img(a, draws)
        else:
            loss, scalars = tr._compute_loss_plain(a)
        loss.backward()
    return ({k: float(v) for k, v in scalars.items()},
            {n: p.grad.numpy() for n, p in tr.model.named_parameters() if p.grad is not None})


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else x, tree)


@contextlib.contextmanager
def mano_f64(jmodel):
    """The JAX model's MANO constants in float64 for the block (under
    jax.enable_x64): the layer's rest shape is a product of constants
    alone, which would stay float32, where the port's ``double()`` casts
    its buffers."""
    layer = getattr(jmodel, "mano_layer", None)
    old = {k: v for k, v in vars(layer).items()
           if isinstance(v, jax.Array) and np.issubdtype(v.dtype, np.floating)
           } if layer is not None else {}
    try:
        for k, v in old.items():
            setattr(layer, k, jax.numpy.asarray(v, np.float64))
        yield
    finally:
        for k, v in old.items():
            setattr(layer, k, v)


def jax_step_f64(jtr, params, stats, a, rng):
    """The JAX package's loss scalars and gradients in float64
    (jax.enable_x64) on the same weights and prepared batch."""
    with jax.enable_x64(True), mano_f64(jtr.model):
        a64 = jax.tree.map(jax.numpy.asarray, _f64(a))
        s64 = _f64(stats)

        def loss_fn(p):
            return jtr._compute_loss(p, s64, rng, a64)

        (_, (scalars, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _f64(params))
        return ({k: float(v) for k, v in scalars.items()},
                TI.export_state_dict(jax.tree.map(np.asarray, grads), {}))


@contextlib.contextmanager
def ieee_convs():
    """oneDNN off for the block. On this suite's CPUs its float32
    convolutions lose precision in the backward pass: in fam_att's step
    the port's ResNet-18 gradients stray 1.47 % from the float64 step with
    oneDNN and 3.7e-5 without it (the JAX package's: 4.6e-5; ``report``).
    The card does not use oneDNN."""
    old = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = old


def step_setup(cfg, batch_size=2):
    """The JAX trainer's train step on random weights and one batch: a
    namespace with both trainers (the port's as a function of JAX trees),
    the batch, the weights and JAX state, the prepared arrays, the step's
    key, JAX's loss scalars and gradients (torch-named) and, on the t2d
    paths, the step's contact draws and ``draws_of`` for other keys."""
    jtr, port = trainers(cfg)
    batch = loaders(cfg, "train", batch_size, seed=0)
    params, stats, state = jax_state(jtr, batch)
    a = jtr.prepare_batch(batch)
    _, step_rng = jax.random.split(state.rng)

    def loss_fn(p):
        return jtr._compute_loss(p, state.batch_stats, step_rng, a)

    (_, (want, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    draws_of = draws = None
    if cfg["model"]["encoder_t2d"]:
        d0 = np.asarray(jtr._depth_origin_for(a["imgs"].shape[2] * a["imgs"].shape[3]))

        def draws_of(arrs, key):
            return jax_draws(np.asarray(arrs["depths"]), np.asarray(arrs["touch_success"]),
                             d0, arrs["points"].shape[1], jtr.num_sample, PER_FINGER, key)

        draws = draws_of(a, jax.random.split(step_rng)[1])
    return types.SimpleNamespace(
        jtr=jtr, port=port, batch=batch, params=params, stats=stats, state=state, a=a,
        step_rng=step_rng, want=want, jgrads=TI.export_state_dict(jgrads, {}),
        draws=draws, draws_of=draws_of)


def check_steps(cfg, batch_size=2):
    """One train step (loss scalars and every parameter's gradient) and one
    eval step of ``cfg`` in both packages on the same random weights and
    batch; the t2d paths take the JAX trainer's contact draws. The train
    step is compared in float64 and float32 as the module docstring says.
    Returns (the port's eval scalars, the port's trainer after the step,
    (params, stats, the JAX state))."""
    st = step_setup(cfg, batch_size)
    jtr, port, batch, params, stats, state = (st.jtr, st.port, st.batch, st.params,
                                              st.stats, st.state)
    want, jg, draws, draws_of = st.want, st.jgrads, st.draws, st.draws_of
    tr = port(params, stats)
    with ieee_convs():
        got = tr.train_step(batch, draws=draws)
    assert set(got) == set(want)
    grads = {n: (torch.zeros(p.shape) if p.grad is None else p.grad)
             for n, p in tr.model.named_parameters()}
    assert set(jg) == set(grads)
    want64, jg64 = jax_step_f64(jtr, params, stats, st.a, st.step_rng)
    draws64 = None
    if draws_of is not None:
        # under jax.enable_x64 the contact draws are float64 uniforms
        with jax.enable_x64(True):
            draws64 = draws_of(st.a, jax.random.split(st.step_rng)[1])
    got64, g64 = port_step_f64(port, params, stats, batch, draws64)
    assert set(want64) == set(want) and set(jg64) == set(jg)
    for k, v in want.items():
        assert_matches_jax(k, got[k], float(v), got64[k], want64[k])
    big = max(np.abs(v).max() for v in jg64.values())
    for k, v in jg64.items():
        g = g64.get(k, np.zeros_like(v))
        if max(np.abs(v).max(), np.abs(g).max()) > 1e-12 * big:
            assert rel(g, v) <= 1e-9, (k, rel(g, v))
    assert all(grads[k].abs().max() == 0 for k in jg if np.abs(jg[k]).max() == 0)

    vb = loaders(cfg, "val", 1, shuffle=False)
    jwant = jtr.eval_step(state, vb)
    iou_draws = None
    if draws_of is not None:
        va = jtr.prepare_batch(vb)
        key = jax.random.fold_in(state.rng, 12345)
        draws, iou_draws = draws_of(va, jax.random.split(key)[1]), draws_of(va, key)
    with ieee_convs():
        jgot = port(params, stats).eval_step(vb, draws, iou_draws)
    assert set(jgot) == set(jwant)
    for k in jwant:
        if k.startswith("iou"):
            assert jgot[k] == pytest.approx(jwant[k], abs=1e-6, nan_ok=True), k
        else:
            assert jgot[k] == pytest.approx(jwant[k], rel=1e-5, abs=1e-7), k
    return jgot, tr, (params, stats, state)


def _module_gaps(grads, exact):
    """{top-level module: |g - exact| / |exact|} over each module's
    gradients, flattened together (float64 norms)."""
    out = {}
    for mod in sorted({k.split(".")[0] for k in exact}):
        keys = [k for k in exact if k.split(".")[0] == mod]
        g = np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])
        e = np.concatenate([np.asarray(exact[k], np.float64).ravel() for k in keys])
        out[mod] = float(np.linalg.norm(g - e) / max(np.linalg.norm(e), 1e-300))
    return out


def report(synth, families=("r50", "pn2", "vox", "att")):
    """The float32 gaps behind check_steps' modes, per family: each
    module's gradient distance from the port's float64 step (relative to
    its norm), for the JAX package's float32 step and the port's with
    and without oneDNN; for fam_r50 also the train-mode image features'
    largest gap (relative to the largest entry)."""
    for name in families:
        cfg = family_cfg(synth, name)
        if name == "pn2":
            cfg["data"]["pointcloud_n"] = 600
        st = step_setup(cfg)
        _, ex = port_step_f64(st.port, st.params, st.stats, st.batch, st.draws)
        print(f"{name} jax:", _module_gaps(st.jgrads, ex))
        for label, ctx in (("port with oneDNN", contextlib.nullcontext()),
                           ("port", ieee_convs())):
            tr = st.port(st.params, st.stats)
            with ctx:
                tr.train_step(st.batch, draws=st.draws)
            print(f"{name} {label}:", _module_gaps(
                {n: p.grad.numpy() for n, p in tr.model.named_parameters()
                 if p.grad is not None}, ex))
        if name == "r50":
            with jax.default_matmul_precision("highest"):
                want, _ = st.jtr.model.apply(
                    {"params": st.params, "batch_stats": st.stats}, st.a["imgs"],
                    method=st.jtr.model.encode_img_inputs, train=True,
                    mutable=["batch_stats"])
            model = load_jax_params(get_model(cfg, device="cpu"), st.params, st.stats)
            x = torch.as_tensor(np.array(st.a["imgs"]))
            with torch.no_grad(), ieee_convs():
                got = model.train().encode_img_inputs(x).numpy()
                exact = copy.deepcopy(model).double().encode_img_inputs(x.double()).numpy()
            print("r50 image features, jax / port:", rel(np.asarray(want), exact),
                  rel(got, exact))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/families.py
    import os
    import sys
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    from vtaco_tpu.data.synthetic import generate

    with tempfile.TemporaryDirectory() as tmp:
        # the family test files' sets: 2,000 query points for the voxel
        # model's (so that its grids hold objects), 500 for the others'
        for n_query, families in ((500, ("r50", "pn2", "att")), (2000, ("vox",))):
            data = generate(os.path.join(tmp, str(n_query)), n_models=4,
                            n_query=n_query, n_surface=1000, img_h=16, img_w=12, seed=7)
            write_voxels(data[0])
            report(data, families)
    sys.exit(0)
