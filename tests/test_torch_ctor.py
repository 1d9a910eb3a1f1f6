"""The port's Generator3D and Inferencer take the JAX package's constructor
arguments, in the same order with the same defaults, and store what the
JAX package stores: built with the same positional arguments and
keywords, then with none, every attribute the JAX objects keep is equal
in the port's (``upsampling_steps`` = 3 by default). A generator built
directly refines as many MISE levels as JAX's when no step count is
passed.

Attributes compared: the JAX objects' public attributes, but for those
the port resolves or keeps under another name: ``coord_quant`` (JAX
keeps 'auto', the port the resolved bool), ``window_interpret`` (the
JAX switch that runs its Pallas window kernel in interpret mode; the
port's CUDA kernels have no such mode), ``model`` (each package its own
model) and ``generator`` (each its own generator).
"""

import inspect

import numpy as np
import pytest

from vtaco_tpu.generate import mise as jmise
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.generate.inferencer import Inferencer as JInf
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate import mise as tmise
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.generate.inferencer import Inferencer as TInf

from test_torch_generate import FEATURE_GAIN
from test_torch_setup import build_pair, make_batch

OWN = {"model", "generator", "coord_quant", "window_interpret"}

# positional: points_batch_size, threshold, resolution0, upsampling_steps,
# padding, sample, refinement_step, simplify_nfaces, input_type, vol_info,
# vol_bound, alpha
GEN_ARGS = (5000, 0.4, 8, 2, 0.2, True, 3, 1000, "pointcloud", None,
            {"reso": 9}, 0.3)
GEN_KW = dict(with_img=True, encode_t2d=True, contact_per_finger=16,
              legacy_gt_depth=False, matmul_precision="default", mc_level="mean",
              use_pallas=False, transfer_dtype="float32", band_transfer=False)
INF_KW = dict(threshold=0.3, num_sample=512, with_img=True, with_contact=True,
              train_tactile=True, encode_t2d=True, input_type="img")


def _public(obj):
    return {k: v for k, v in vars(obj).items() if not k.startswith("_") and k not in OWN}


def _assert_same(jobj, tobj):
    want = _public(jobj)
    missing = sorted(k for k in want if not hasattr(tobj, k))
    assert not missing, f"the port lacks {missing}"
    for k, v in want.items():
        assert getattr(tobj, k) == v, (k, getattr(tobj, k), v)


def test_signatures_match():
    """The same parameters, in the same order, with the same defaults."""
    for j, t in ((JGen.__init__, TGen.__init__), (JInf.__init__, TInf.__init__)):
        jp, tp = inspect.signature(j).parameters, inspect.signature(t).parameters
        assert list(tp) == list(jp)
        for name, p in jp.items():
            assert (tp[name].default, tp[name].kind) == (p.default, p.kind), name


@pytest.mark.parametrize("given", ["none", "all"])
def test_generator_attributes_match(given):
    args, kw = ((), {}) if given == "none" else (GEN_ARGS, GEN_KW)
    jgen, tgen = JGen(None, *args, **kw), TGen(None, *args, **kw)
    _assert_same(jgen, tgen)
    assert tgen.upsampling_steps == (3 if given == "none" else 2)
    assert tgen.use_kernels == (given == "none")


@pytest.mark.parametrize("given", ["none", "all"])
def test_inferencer_attributes_match(given, tmp_path):
    kw = {} if given == "none" else dict(INF_KW, vis_dir=str(tmp_path / "vis"))
    jinf = JInf(None, JGen(None, resolution0=8, padding=0.2), **kw)
    tinf = TInf(None, TGen(None, resolution0=8, padding=0.2), **kw)
    _assert_same(jinf, tinf)
    assert (tinf.resolution0, tinf.padding) == (8, 0.2)


def test_direct_generator_mise_levels_match(monkeypatch):
    """generate_obj_mesh_mise on generators built with only (model,
    resolution0=4): both packages refine the JAX default of 3 levels (the
    step count multires_decode receives), and each mesh has vertices."""
    cfg, jmodel, v, tmodel = build_pair()
    for name, leaf in v["params"]["decoder"].items():
        if name.startswith("fc_c"):
            leaf["kernel"] = leaf["kernel"] * FEATURE_GAIN
    load_jax_params(tmodel, v["params"], v["batch_stats"])

    class State:
        params = v["params"]
        batch_stats = v["batch_stats"]

    steps = {}
    for name, mod in (("jax", jmise), ("port", tmise)):
        run = mod.multires_decode

        def record(gen, model, c, res0, n_steps, *a, _run=run, _name=name, **kw):
            steps[_name] = (res0, n_steps)
            return _run(gen, model, c, res0, n_steps, *a, **kw)

        monkeypatch.setattr(mod, "multires_decode", record)
    data = make_batch(np.random.default_rng(0))
    jv, _ = JGen(jmodel, resolution0=4).generate_obj_mesh_mise(State(), data)
    tv, _ = TGen(tmodel, resolution0=4).generate_obj_mesh_mise(tmodel, data)
    assert steps == {"jax": (16, 3), "port": (16, 3)}
    assert len(jv) > 0 and len(tv) > 0
