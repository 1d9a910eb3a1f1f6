"""Selective mixed precision per module: every module that the ``*_fast``
configs run in bfloat16 (VTacO_YCB's object encoder, hand encoder and
ResNet-18 image encoder; tactile_test's depth U-Net and sensor-pose head;
VTacOH_YCB's are VTacO_YCB's modules at the same widths), in the PyTorch
port (vtaco_tpu_torch) against the JAX package's bfloat16 evaluation, on
the CPU at small widths.

Why per module: over a whole train step the gradients are a chaotic
function of bfloat16 rounding (the L1 loss's signs, train-mode BatchNorm
on [0, 1/255] images), so that the JAX package's own bfloat16 and float32
steps have module gradient cosines of 0.18-0.24 at these widths
(tests/test_torch_fast.py). Each module is therefore run alone, as the
trainer runs it in a bfloat16 step: train mode, its parameters cast to
bfloat16 (Trainer._cast_params, the JAX Trainer._cast_params), the batch's
inputs cast as the step casts them, one fixed random cotangent on its
floating outputs; its outputs and the gradient of its parameters are
compared.

Bars: for three random weight sets, R = sqrt(sum ||port - jax_bf16||^2 /
sum ||jax_bf16 - jax_f32||^2), the port's distance to the JAX package's
bfloat16 evaluation in units of JAX's own bfloat16-to-float32 gap, pooled
over the sets; R <= 0.6 for each output and R <= 0.8 for the gradient
(tests/bf16_checks.py, which chip_smoke.py shares).
The gradient leaves out the biases of convolutions that feed a train-mode
BatchNorm (the tactile U-Net's conv1 and conv2 ahead of their block's
shared norm): the norm removes any per-channel constant, so their exact
gradient is zero and what either package gives is rounding. Each planted
fault must fail the same bars: the module left in float32
(keep_f32_modules naming it), and, where the module has BatchNorm,
BatchNorm reducing and normalizing in bfloat16. The two packages' float32
evaluations agree within a tenth of that gap (R <= 0.1).

`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_fast_modules.py`
prints every reading (the port's R and each fault's). VTacO_YCB's object
and hand encoders are checked in tests/test_torch_fast_modules_vtaco.py
and tactile_test's modules in tests/test_torch_fast_modules_tactile.py,
so that no file holds one worker long."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.models import layers
from vtaco_tpu_torch.train.trainer import cpu_reduced_precision_convs

from bf16_checks import MODULE_GRAD_BAR as GRAD_BAR
from bf16_checks import MODULE_OUT_BAR as OUT_BAR
from bf16_checks import bf16_batchnorm, exact_zero
from test_torch_fast import port_trainer, share_cores, small, trainer_kw  # noqa: F401
from test_torch_setup import random_tree

SEEDS = (21, 22, 23)
# module → (the model method that runs it, the batch key it takes)
METHODS = {"encoder": ("encode_inputs", "inputs"),
           "encoder_hand": ("encode_hand_inputs", "inputs"),
           "encoder_img": ("encode_img_inputs", "imgs")}
CASES = [("vtaco", "encoder"), ("vtaco", "encoder_hand"), ("vtaco", "encoder_img"),
         ("tactile", "encoder_hand"), ("tactile", "encoder_img")]
# the cases of each file, by name: this file's, test_torch_fast_modules_vtaco.py's
# and test_torch_fast_modules_tactile.py's; a case in no file or in two fails here
SPLIT = {"modules": [("vtaco", "encoder_img")],
         "vtaco": [("vtaco", "encoder"), ("vtaco", "encoder_hand")],
         "tactile": [("tactile", "encoder_hand"), ("tactile", "encoder_img")]}
assert sorted(sum(SPLIT.values(), [])) == sorted(CASES), SPLIT


def make_synth(root):
    return jax_generate(root, n_models=6, n_query=500, n_surface=1000, img_h=16, img_w=12,
                        seed=7, splits=(("train", 0.67), ("val", 0.33)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synth(str(tmp_path_factory.mktemp("synth_fast_modules")))


def leaves(out):
    """A module's output → {name: array}, its floating leaves."""
    items = sorted(out.items()) if isinstance(out, dict) else [("out", out)]
    return {k: v for k, v in items if v.dtype in (jnp.float32, jnp.bfloat16, torch.float32,
                                                  torch.bfloat16)}


_JAX_SETUP, _JAX_JIT = {}, {}


def jax_setup(name, synth):
    """The JAX side of one config's module checks, built once per config
    and synthetic set and shared by every module case of it in a file:
    (cfg, the float32 and bfloat16 JAX trainers, the batch, the variables'
    shapes, each seed's random (params, batch_stats))."""
    key = (name, tuple(synth))
    if key not in _JAX_SETUP:
        cfg = small(name, synth)
        jmodel, _ = jax_get_model(cfg)
        jbank = jax_build_mesh_bank(cfg) if name == "vtaco" else None
        jtrs = {dt: JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, compute_dtype=dt,
                                           **trainer_kw(name)) for dt in (None, "bfloat16")}
        np.random.seed(0)   # the items' subsampling and noise draw from it
        batch = dict(next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                              num_workers=1, seed=0))))
        shapes = jtrs[None].init_state_abstract(batch)
        weights = {}
        for seed in SEEDS:
            rng = np.random.default_rng(seed)
            weights[seed] = (random_tree(shapes.params, rng),
                             random_tree(shapes.batch_stats, rng))
        _JAX_SETUP[key] = cfg, jtrs, batch, shapes, weights
    return _JAX_SETUP[key]


def jax_module(jtr, params, stats, mod, x, cot, jit=False):
    """(outputs, gradient as a state_dict) of the JAX package's module on
    x, its parameters cast by the trainer, train mode; ``cot`` the
    cotangent by output name, None to draw it (returned third). ``jit``
    compiles the forward and its vjp once per trainer and module (for the
    float32 reference: XLA's excess precision concerns bfloat16 only);
    without it every operation runs and rounds on its own, as PyTorch's
    do."""
    method = getattr(jtr.model, METHODS[mod][0])

    def apply(pm, params, stats, x):
        p = dict(params, **{mod: pm})
        out, _ = jtr._apply({"params": jtr._cast_params(p), "batch_stats": stats}, method, x,
                            train=True)
        return out

    if jit:
        if (id(jtr), mod) not in _JAX_JIT:
            _JAX_JIT[id(jtr), mod] = (jtr, jax.jit(apply), jax.jit(
                lambda pm, params, stats, x, ct: jax.vjp(
                    lambda q: apply(q, params, stats, x), pm)[1](ct)[0]))
        _, fwd, bwd = _JAX_JIT[id(jtr), mod]
        out = fwd(params[mod], params, stats, x)
        vjp = lambda ct: (bwd(params[mod], params, stats, x, ct),)  # noqa: E731
    else:
        out, vjp = jax.vjp(lambda pm: apply(pm, params, stats, x), params[mod])
    lv = leaves(out)
    if cot is None:
        rng = np.random.default_rng(5)
        cot = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in lv.items()}
    if isinstance(out, dict):
        ct = {k: (jnp.asarray(cot[k], v.dtype) if k in cot else jnp.zeros_like(v))
              for k, v in out.items()}
    else:
        ct = jnp.asarray(cot["out"], out.dtype)
    grads = TI.export_state_dict({mod: vjp(ct)[0]}, {})
    return {k: np.asarray(v, np.float32) for k, v in lv.items()}, grads, cot


def port_module(cfg, params, stats, name, mod, batch, cot, compute_dtype, fault=None):
    """The port's module as a bfloat16 train step runs it (Trainer._call
    on the step's cast parameters and cast batch): (outputs, gradient of
    the module's parameters). ``fault``: 'float32' keeps the module in
    float32, 'bf16_batchnorm' plants bf16_batchnorm."""
    keep = ("decoder", mod) if fault == "float32" else ("decoder",)
    tr = port_trainer(cfg, params, stats, name, compute_dtype=compute_dtype,
                      keep_f32_modules=keep)
    tr.model.train()
    method, key = METHODS[mod]
    forward = layers.BatchNorm2d.forward
    if fault == "bf16_batchnorm":
        layers.BatchNorm2d.forward = bf16_batchnorm
    try:
        with cpu_reduced_precision_convs(compute_dtype is not None):
            if compute_dtype is not None:
                tr._params = tr._module_params(tr._cast_params(dict(tr.model.named_parameters())))
            out = leaves(tr._call(method, tr._cast_batch(tr.prepare_batch(batch))[key]))
            torch.autograd.backward([out[k] for k in cot],
                                    [torch.as_tensor(cot[k]).to(out[k].dtype) for k in cot])
    finally:
        tr._params = None
        layers.BatchNorm2d.forward = forward
    grads = {n: (np.zeros(p.shape) if p.grad is None else p.grad.numpy())
             for n, p in tr.model.named_parameters() if n.split(".")[0] == mod}
    return {k: v.detach().float().numpy() for k, v in out.items()}, grads


def module_readings(name, mod, synth):
    """R of the port and of each planted fault, by output and 'grad'
    (and of the port's float32 evaluation against JAX's float32 one), and
    JAX's own gap for each weight set."""
    cfg, jtrs, batch, shapes, weights = jax_setup(name, synth)
    has_bn = any(".bn" in k or "downsample" in k for k in
                 TI.export_state_dict({mod: shapes.params[mod]}, {}))
    faults = ["float32"] + (["bf16_batchnorm"] if has_bn else [])
    sq = {}

    def add(tag, got, ref, live):
        d = sq.setdefault(tag, {})
        for k in ref[0]:
            d.setdefault(k, []).append(float(np.sum(np.square(
                got[0][k].astype(np.float64) - ref[0][k]))))
        d.setdefault("grad", []).append(float(sum(np.sum(np.square(
            got[1][k].astype(np.float64) - ref[1][k])) for k in live)))

    for seed in SEEDS:
        params, stats = weights[seed]
        x = {dt: jtr._cast_batch(jtr.prepare_batch(batch))[METHODS[mod][1]]
             for dt, jtr in jtrs.items()}
        j32 = jax_module(jtrs[None], params, stats, mod, x[None], None, jit=True)
        cot = j32[2]
        j16 = jax_module(jtrs["bfloat16"], params, stats, mod, x["bfloat16"], cot)
        live = sorted(set(j32[1]) - exact_zero(j32[1]))
        add("gap", j16, j32, live)
        add("port_float32", port_module(cfg, params, stats, name, mod, batch, cot, None), j32,
            live)
        add("port", port_module(cfg, params, stats, name, mod, batch, cot, "bfloat16"), j16, live)
        for fault in faults:
            add(fault, port_module(cfg, params, stats, name, mod, batch, cot, "bfloat16",
                                   fault), j16, live)
    ratio = {tag: {k: float(np.sqrt(sum(v) / sum(sq["gap"][k]))) for k, v in d.items()}
             for tag, d in sq.items() if tag != "gap"}
    gap = {k: [float(np.sqrt(v)) for v in vs] for k, vs in sq["gap"].items()}
    return {"config": name, "module": mod, "R": ratio, "jax_gap_each": gap}


def check_module(synth, name, mod):
    """The port's bfloat16 module within the bars of the JAX package's
    bfloat16 module (R <= 0.6 per output, <= 0.8 for the gradient), and
    each planted fault beyond them."""
    r = module_readings(name, mod, synth)
    assert all(v <= 0.1 for v in r["R"].pop("port_float32").values()), r
    port = r["R"]["port"]
    assert all(v <= (GRAD_BAR if k == "grad" else OUT_BAR) for k, v in port.items()), r
    for fault, got in r["R"].items():
        if fault != "port":
            assert any(v > (GRAD_BAR if k == "grad" else OUT_BAR) for k, v in got.items()), (
                fault, r)


@pytest.mark.parametrize("name,mod", SPLIT["modules"])
def test_bf16_module_matches_jax(synth, name, mod):
    check_module(synth, name, mod)


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    s = make_synth(tempfile.mkdtemp())
    for name, mod in CASES:
        print(json.dumps(module_readings(name, mod, s)), flush=True)
