"""A fresh port model draws its parameters from the distributions the JAX
package's ``init`` draws them from (F12, ROADMAP.md §3), on the CPU.

For each shipped config (VTacO_YCB, VTacOH_YCB, tactile_test, scene_crop
and the three ``*_fast``) at tests/test_trainer.py's small widths
(scene_crop at tests/test_torch_crop.py's) and each family of
tests/families.py, the JAX model's parameters are those its Trainer
initializes (``init_state``'s trace on a loader batch; for
simple_local_point, which the JAX Trainer cannot initialize, F8 (d),
``families.jax_init_shapes``). Every initializer flax calls there is
recorded and then evaluated on its shape: the JAX package's own
initializers (scale, mode, fans, the truncation and its 0.8796 factor),
whose standard normals are numpy's (JAX's generator compiles for about
0.2 s per tensor on the CPU, which would take minutes here; the
distribution is the same). core/weights' ``export_state_dict`` maps the
tree to the port's names and layouts. The port's model is
``get_model(cfg, device="cpu", generator=...)``.

Tolerances:
  * a tensor that JAX initializes to all zeros or all ones is exactly
    that in the port;
  * every other tensor of at least 64 elements has a std within 5
    standard errors of the JAX one, the standard error
    sqrt(s_jax²/(2 n) + s_port²/(2 n)) taken from both samples;
  * pooled over every config and family, per initializer (the port
    layer's ``kernel_init``), sqrt(Σ n_i r_i² / Σ n_i) with r_i the
    tensors' std ratio is within 3 % of 1;
  * no ``lecun_normal`` tensor exceeds its cut, 2/(0.8796 √fan_in), the
    fan from the JAX kernel's shape.

``Trainer.init_state`` draws the same tensors as ``get_model`` from the
same generator, again for the same seed and otherwise for another, and
resets BatchNorm's statistics, the optimizer's moments and the step.
"""

import copy
import functools
import math

import jax
import jax._src.random as jax_random
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.models.pointnet import IndexEncoder as JIndexEncoder
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_dataset, get_model
from vtaco_tpu_torch.core.weights import export_state_dict
from vtaco_tpu_torch.models import init as I
from vtaco_tpu_torch.models.pointnet import IndexEncoder
from vtaco_tpu_torch.train.trainer import Trainer

from families import family_cfg, jax_init_shapes
from test_torch_crop import crop_cfg
from test_trainer import _small_cfg
from voxel_files import write_voxels

CONFIGS = {
    "VTacO_YCB": "configs/VTacO/VTacO_YCB.yaml",
    "VTacO_YCB_fast": "configs/VTacO/VTacO_YCB_fast.yaml",
    "VTacOH_YCB": "configs/VTacOH/VTacOH_YCB.yaml",
    "VTacOH_YCB_fast": "configs/VTacOH/VTacOH_YCB_fast.yaml",
    "tactile_test": "configs/tactile/tactile_test.yaml",
    "tactile_test_fast": "configs/tactile/tactile_test_fast.yaml",
    "scene_crop": "configs/crop/scene_crop.yaml",
}
FAMILIES = ("r34", "r50", "pn2", "vox", "att")
CASES = tuple(CONFIGS) + FAMILIES
MIN_NUMEL = 64
Z_MAX = 5.0
POOLED_TOL = 0.03
# the std of a standard normal cut at ±2
TRUNC = 0.87962566103423978


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Four objects with enough query points that every crop holds some,
    and their voxel files."""
    root, mesh_root = jax_generate(str(tmp_path_factory.mktemp("synth_init")), n_models=4,
                                   n_query=4000, n_surface=1000, img_h=16, img_w=12,
                                   seed=5)
    write_voxels(root)
    return root, mesh_root


def case_cfg(synth, name):
    if name == "scene_crop":
        return crop_cfg(synth[0])
    if name in CONFIGS:
        return _small_cfg(CONFIGS[name], *synth)
    return family_cfg(synth, name)


class _HostDraw(np.ndarray):
    """A numpy draw that stays on the host through the initializer's
    scaling (``draw * std``), which would otherwise run as a JAX
    operation compiled for each shape."""

    def __mul__(self, other):
        return np.multiply(np.asarray(self), np.asarray(other))


def _standard_normals(rng):
    """numpy stand-ins for jax.random's normal and truncated_normal."""
    def normal(key, shape=(), dtype=np.float32, **_):
        return rng.standard_normal(shape).astype(dtype).view(_HostDraw)

    def truncated_normal(key, lower, upper, shape=(), dtype=np.float32, **_):
        out = rng.standard_normal(shape)
        bad = (out < lower) | (out > upper)
        while bad.any():
            out[bad] = rng.standard_normal(int(bad.sum()))
            bad = (out < lower) | (out > upper)
        return out.astype(dtype).view(_HostDraw)

    return normal, truncated_normal


def recorded_init(run, seed):
    """Run ``run`` (a jax.eval_shape of an init) with every flax parameter
    and variable initializer recorded, then evaluate each on its shape:
    {"params": tree, "batch_stats": tree}."""
    calls = {}
    param, variable = fnn.Module.param, fnn.Module.variable

    def rec_param(self, name, fn, *args, **kw):
        calls[("params",) + self.path + (name,)] = (fn, args, kw)
        return param(self, name, fn, *args, **kw)

    def rec_variable(self, col, name, fn=None, *args, **kw):
        calls[(col,) + self.path + (name,)] = (fn, args, kw)
        return variable(self, col, name, fn, *args, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(fnn.Module, "param", rec_param)
        mp.setattr(fnn.Module, "variable", rec_variable)
        run()
        mp.undo()
        normal, truncated = _standard_normals(np.random.default_rng(seed))
        mp.setattr(jax_random, "normal", normal)
        mp.setattr(jax_random, "truncated_normal", truncated)
        trees = {"params": {}, "batch_stats": {}}
        key = jax.random.PRNGKey(0)
        for path, (fn, args, kw) in calls.items():
            value = fn(key, *args, **kw) if path[0] == "params" else fn(*args, **kw)
            node = trees[path[0]]
            for comp in path[1:-1]:
                node = node.setdefault(comp, {})
            node[path[-1]] = np.asarray(value)
    finally:
        mp.undo()
    return trees


@functools.lru_cache(maxsize=None)
def case(synth, name):
    """{port name: (JAX value, port value, the port's initializer name,
    the lecun cut or None)} for one config or family."""
    cfg = case_cfg(synth, name)
    crop = cfg["data"]["input_type"] == "pointcloud_crop"
    jds = jax_get_dataset("train", copy.deepcopy(cfg))
    jmodel, _ = jax_get_model(copy.deepcopy(cfg), dataset=jds if crop else None)
    jtr = JaxTrainer.from_config(jmodel, cfg)
    np.random.seed(0)
    batch = next(iter(JaxBatchLoader(jds, batch_size=2, num_workers=1, seed=0)))
    if name == "pn2":
        trees = recorded_init(lambda: jax_init_shapes(jtr, batch), seed=1)
    else:   # what Trainer.init_state traces (vtaco_tpu/train/trainer.py:267)
        init_fn = jtr._make_init_fn(jtr.prepare_batch(batch))
        trees = recorded_init(lambda: jax.eval_shape(
            lambda: jtr.model.init(jax.random.PRNGKey(0), method=init_fn)), seed=1)
    jsd = export_state_dict(trees["params"], trees["batch_stats"])
    # each kernel's fan_in from its flax layout (*k, in, out), as a 0-d leaf
    # that the export renames without transposing
    fan_in = export_state_dict(jax.tree_util.tree_map_with_path(
        lambda path, v: np.array(math.prod(v.shape[:-1]) if path[-1].key == "kernel" else 0),
        trees["params"]), {})

    pds = get_dataset("train", cfg) if crop else None
    model = get_model(cfg, device="cpu", dataset=pds,
                      generator=torch.Generator().manual_seed(3))
    modules = dict(model.named_modules())
    out = {}
    for pname, pv in model.state_dict().items():
        if not pv.is_floating_point():
            continue
        mname, _, leaf = pname.rpartition(".")
        init = getattr(modules[mname], "kernel_init" if leaf == "weight" else "bias_init",
                       None)
        init = getattr(init, "func", init)
        init_name = getattr(init, "__name__", "norm")
        if init is I.normal_:
            init_name = "relation_normal"
        cut = (2.0 / (TRUNC * math.sqrt(fan_in[pname])) if init is I.lecun_normal_
               else None)
        out[pname] = (jsd[pname], pv.numpy(), init_name, cut)
    assert set(out) == set(jsd), set(out) ^ set(jsd)
    return out




def _std_z(a, b):
    sa, sb = a.std(dtype=np.float64), b.std(dtype=np.float64)
    se = math.sqrt(sa * sa / (2 * a.size) + sb * sb / (2 * b.size))
    return abs(sb - sa) / se, sb / sa


def check_case(tensors):
    """The per-tensor bars: [failures], and {initializer: [(n, ratio)]}."""
    bad, ratios = [], {}
    for name, (j, p, init_name, cut) in tensors.items():
        if not j.any() or np.all(j == 1):
            if not np.array_equal(j, p):
                bad.append((name, "constant", float(np.abs(p - j).max())))
            continue
        if cut is not None and np.abs(p).max() > cut:
            bad.append((name, "cut", float(np.abs(p).max()), cut))
        if j.size < MIN_NUMEL:
            continue
        z, ratio = _std_z(j, p)
        ratios.setdefault(init_name, []).append((j.size, ratio))
        if z > Z_MAX:
            bad.append((name, "std", float(j.std()), float(p.std()), z))
    return bad, ratios


@pytest.mark.parametrize("name", CASES)
def test_fresh_model_draws_as_jax(synth, name):
    """Every tensor of a fresh port model at the JAX init's distribution:
    exact zeros and ones, each std within 5 standard errors, lecun
    tensors within their cut."""
    tensors = case(synth, name)
    bad, _ = check_case(tensors)
    assert not bad, (len(bad), len(tensors), bad[:10])


def pooled_ratios(synth):
    """{initializer: (tensors, entries, pooled std ratio)} over every
    config and family."""
    pooled = {}
    for name in CASES:
        for init_name, rs in check_case(case(synth, name))[1].items():
            pooled.setdefault(init_name, []).extend(rs)
    report = {}
    for init_name, rs in pooled.items():
        n = np.array([r[0] for r in rs], np.float64)
        r = np.array([r[1] for r in rs])
        report[init_name] = (len(rs), int(n.sum()),
                             float(np.sqrt((n * r * r).sum() / n.sum())))
    return report


def test_pooled_std_ratio(synth):
    """Per initializer over every config and family, the pooled std ratio
    is within 3 % of 1; every initializer kind the port uses is seen."""
    report = pooled_ratios(synth)
    assert {"lecun_normal_", "kaiming_out_", "xavier_normal_",
            "relation_normal"} <= set(report), report
    assert all(abs(v - 1) <= POOLED_TOL for _, _, v in report.values()), report


def test_index_encoder_draws_as_flax_embed():
    """encoder: idx: flax's Embed draws a plain normal of std
    1/sqrt(features) (measured, not assumed), as the port's
    IndexEncoder."""
    jenc = JIndexEncoder(num_embeddings=300, c_dim=16)
    w = np.asarray(jax.tree_util.tree_leaves(
        jenc.init(jax.random.PRNGKey(0), jax.numpy.arange(3)))[0])
    assert w.shape == (300, 16)
    enc = I.init_params(IndexEncoder(300, 16), torch.Generator().manual_seed(0))
    p = enc.weight.detach().numpy()
    z, _ = _std_z(w, p)
    assert z <= Z_MAX, (w.std(), p.std())
    # untruncated in both: the largest entries lie past 2 stds
    assert np.abs(w).max() > 3 * w.std() and np.abs(p).max() > 3 * p.std()


def test_init_state_redraws(synth):
    """Trainer.init_state(seed) twice gives equal weights, the same as
    get_model's from a generator of that seed; another seed gives others;
    BatchNorm's statistics, Adam's moments and the step are reset."""
    cfg = case_cfg(synth, "tactile_test")
    model = get_model(cfg, device="cpu")
    tr = Trainer.from_config(model, cfg)

    def weights():
        return {k: v.clone() for k, v in model.state_dict().items()}

    for p in model.parameters():
        p.grad = torch.ones_like(p)
    tr.optimizer.step()
    tr.step = 7
    bn = next(m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    bn.running_mean.fill_(0.5)
    tr.init_state(None, 11)
    assert tr.step == 0 and not tr.optimizer.state
    assert not bn.running_mean.any() and torch.all(bn.running_var == 1)
    first = weights()
    tr.init_state(rng=11)
    assert all(torch.equal(first[k], v) for k, v in weights().items())
    fresh = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(11))
    assert all(torch.equal(first[k], v) for k, v in fresh.state_dict().items())
    tr.init_state(rng=torch.Generator().manual_seed(12))
    other = weights()
    drawn = [k for k, v in first.items() if v.is_floating_point() and v.numel() > 1
             and v.std() > 0]
    assert drawn and not any(torch.equal(first[k], other[k]) for k in drawn)
    tr.init_state()
    default = weights()
    tr.init_state(rng=tr.seed)
    assert all(torch.equal(default[k], v) for k, v in weights().items())


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_init.py
    # prints each case's tensors, those off the bars and the worst z-score,
    # then the pooled ratios
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        root, mesh_root = jax_generate(tmp, n_models=4, n_query=4000, n_surface=1000,
                                       img_h=16, img_w=12, seed=5)
        write_voxels(root)
        data = (root, mesh_root)
        for name in CASES:
            tensors = case(data, name)
            zs = [_std_z(j, p)[0] for j, p, _, _ in tensors.values()
                  if j.any() and not np.all(j == 1) and j.size >= MIN_NUMEL]
            print(name, "tensors", len(tensors), "off", len(check_case(tensors)[0]),
                  "worst_z", max(zs))
        for init_name, (n_t, n_e, ratio) in pooled_ratios(data).items():
            print(init_name, "tensors", n_t, "entries", n_e, "pooled_ratio", ratio)
