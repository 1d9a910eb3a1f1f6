"""VTacOH (fingertip gating) in the PyTorch port against the JAX package on
the CPU, on the same weights (carried across by load_jax_params) and
inputs made from numpy seeds: the fingertip gates (``gate_tips_cn``), the
fingertips in the object frame, the img path's fingertip sample and its
eval features, one train and one eval step of the img loss path, the
VTacOH mesh, ``eval_points`` with fingertip gates on the dense, gather and
window routes, VTacO's predicted-depth gates, and the train and generate
CLIs on a small synthetic VTacOH set.

torch cannot replay jax.random, so the fingertip sample's draws are
computed here with jax.random from the keys the JAX trainer uses and
handed to the port (``draws=``). The gates compare a distance with the
0.05 radius: ``gate_tips_cn`` in the expanded form ``|q|² + |p|² - 2 q·p``
(as the kernels' rows do), the training functions in the direct form
``|p - q|`` (as the JAX package does each); the two packages round either
differently by an ulp. So points within 1e-6 of the radius for some tip,
or within 1e-6 of a tie between two tips, may be decided either way and
are left out (their count is asserted small). Tolerances: gate decisions
and rows exact; tips 1e-5; the train step's loss scalars 1e-5 relative
(where the JAX value strays farther from a float64 evaluation, four
times closer to it: ``assert_batch_stat``), gradient cosine >= 0.999 with
norms within 2 % per module; IoU 1e-6; eval_points 2e-5; meshes as in
tests/test_torch_generate.py.
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.ops import fast_trunk as JFT
from vtaco_tpu.train import contact as JC
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_generator, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.train.trainer import Trainer
from vtaco_tpu_torch.utils import meshio

from test_torch_generate import FEATURE_GAIN, MAX_TRI_BOUND, _triangles, _vertex_bound
from test_torch_setup import (
    CONTACTS_PER_FINGER,
    H_IMG,
    W_IMG,
    build_pair,
    make_batch,
    random_tree,
)
from test_torch_train import assert_batch_stat, module_grads
from test_torch_window import ATOL, PADDING, Routes, _jax_window_calls, _lattice_sets
from test_torch_window import dec, gens  # noqa: F401  (fixtures)
from test_trainer import _small_cfg

R2 = 0.05 ** 2
NEAR = 1e-6


def T(x):
    return torch.as_tensor(np.array(x))


def _undecided(p_cn, tips):
    """(N,) True where a point's gate may round either way in either
    distance form: some tip's squared distance (in float64) within NEAR of
    r², or the two nearest tips' within NEAR of each other."""
    p = np.asarray(p_cn, np.float64)
    q = np.asarray(tips, np.float64)
    d2 = ((p[None, :, :] - q[:, :, None]) ** 2).sum(1)             # (5, N)
    two = np.sort(d2, axis=0)[:2]
    return (np.abs(d2 - R2) < NEAR).any(0) | (two[1] - two[0] < NEAR)


def _tips_and_points(rng, n_near=1000, n_far=2000):
    """Five fingertips in the box, and points uniform in the box plus
    points in cubes of side 0.12 around the tips (about a third of those
    within the radius)."""
    tips = rng.uniform(-0.35, 0.35, (5, 3)).astype(np.float32)
    tips[1] = tips[0] + np.float32([0.06, 0.0, 0.0])      # overlapping balls
    near = tips[rng.integers(0, 5, n_near)] + rng.uniform(-0.06, 0.06, (n_near, 3))
    far = rng.uniform(-0.55, 0.55, (n_far, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    return tips, pts[rng.permutation(len(pts))]


# ---------------------------------------------------------------------------
# the functions

@pytest.mark.parametrize("valid", ["some_invalid", "all_valid", "all_invalid"])
def test_gate_tips_cn_matches_jax(valid):
    """Equal rows outside the shell: each point takes its nearest tip's
    feature when that tip is within the radius and touching, else zeros;
    invalid tips gate nothing, and a point nearest to an invalid tip is
    not handed to the next one."""
    rng = np.random.default_rng(0)
    tips, pts = _tips_and_points(rng)
    p_cn = np.ascontiguousarray(pts.T)
    feat = rng.standard_normal((5, 16)).astype(np.float32)
    tv = {"some_invalid": np.array([True, False, True, True, False]),
          "all_valid": np.ones(5, bool), "all_invalid": np.zeros(5, bool)}[valid]
    want = np.asarray(JFT.gate_tips_cn(jnp.asarray(p_cn), jnp.asarray(tips),
                                       jnp.asarray(feat), jnp.asarray(tv)))
    got = FT.gate_tips_cn(T(p_cn), T(tips), T(feat), T(tv)).numpy()
    keep = ~_undecided(p_cn, tips)
    assert (~keep).sum() <= 5
    np.testing.assert_array_equal(got[:, keep], want[:, keep])
    gated = np.abs(got).sum(0) > 0
    assert (gated.sum() > 100) == (valid != "all_invalid")
    if valid == "some_invalid":   # tip 1 is off: its points stay ungated
        d2 = ((pts[:, None] - tips[None]) ** 2).sum(-1)
        assert not gated[(d2.argmin(1) == 1) & keep].any()


def test_tips_in_object_frame_matches_jax():
    rng = np.random.default_rng(1)
    joints = (0.08 * rng.standard_normal((3, 21, 3))).astype(np.float32)
    wpos = (0.1 * rng.standard_normal((3, 3))).astype(np.float32)
    wrot = rng.uniform(-np.pi, np.pi, (3, 3)).astype(np.float32)
    ply = (0.15 * rng.standard_normal((3, 400, 3)) + 0.05).astype(np.float32)
    want = np.asarray(JC.tips_in_object_frame(*(jnp.asarray(x) for x in
                                                (joints, wpos, wrot, ply))))
    got = C.tips_in_object_frame(T(joints), T(wpos), T(wrot), T(ply))
    assert got.shape == (3, 5, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def jax_tip_draws(points, tips, touch, num_sample, per_finger, key):
    """The draws jax's fingertip_gated_sample makes from ``key``, in the
    port's ``draws`` form: the same key splits (by batch row, then six
    ways), the same masks, top-k and randint."""
    per_finger = min(per_finger, num_sample // 5)
    cidx, ridx = [], []
    for b, kb in enumerate(jax.random.split(key, points.shape[0])):
        rngs = jax.random.split(kb, 6)
        d = jnp.linalg.norm(jnp.asarray(points[b])[:, None] - jnp.asarray(tips[b])[None],
                            axis=-1)
        near, assign = jnp.min(d, axis=1) < 0.05, jnp.argmin(d, axis=1)
        cidx.append([np.asarray(JC.random_topk_select(
            near & (assign == f) & bool(touch[b, f]), per_finger, rngs[f])[0])
            for f in range(5)])
        ridx.append(np.asarray(jax.random.randint(rngs[5], (num_sample,), 0,
                                                  points.shape[1])))
    return {"contact_idx": T(np.asarray(cidx)), "rand_idx": T(np.asarray(ridx))}


def _sample_inputs(seed):
    rng = np.random.default_rng(seed)
    tips, pts = zip(*(_tips_and_points(rng) for _ in range(2)))
    tips, pts = np.stack(tips), np.stack(pts)
    occ = (rng.random(pts.shape[:2]) > 0.5).astype(np.float32)
    touch = np.array([[1, 1, 0, 1, 1], [1, 1, 1, 1, 1]], bool)
    return pts, occ, tips, touch


@pytest.mark.parametrize("per_finger", [32, 512])
def test_fingertip_gated_sample_matches_jax(per_finger):
    """With the JAX draws fed in: the same points, labels, slot validity and
    finger ids. 512 per finger is the trainer's default, capped at
    num_sample // 5; at 32 per finger the top-k subsamples the crowded
    tips. The port's own draws fill as many slots."""
    pts, occ, tips, touch = _sample_inputs(2)
    keep = np.stack([~_undecided(p.T, q) for p, q in zip(pts, tips)])
    assert (~keep).sum() <= 6
    pts, occ = pts[:, keep.all(0)], occ[:, keep.all(0)]
    num_sample, key = 512, jax.random.PRNGKey(3)
    want, want_occ = jax.jit(JC.fingertip_gated_sample, static_argnums=(4, 5))(
        jnp.asarray(pts), jnp.asarray(occ), jnp.asarray(tips), jnp.asarray(touch),
        num_sample, per_finger, key)
    draws = jax_tip_draws(pts, tips, touch, num_sample, per_finger, key)
    got, got_occ = C.fingertip_gated_sample(T(pts), T(occ), T(tips), T(touch),
                                            num_sample, per_finger, draws=draws)
    assert 100 < int(want.valid.sum()) < 2 * num_sample
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.finger.numpy(), np.asarray(want.finger))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))
    own, own_occ = C.fingertip_gated_sample(T(pts), T(occ), T(tips), T(touch), num_sample,
                                            per_finger, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(own.valid.sum(1).numpy(), np.asarray(want.valid.sum(1)))
    assert own.points.shape == (2, num_sample, 3) and own_occ.shape == (2, num_sample)


def test_assign_features_by_proximity_matches_jax():
    pts, _, tips, touch = _sample_inputs(4)
    c_img = np.random.default_rng(5).standard_normal((2, 5, 8)).astype(np.float32)
    want = np.asarray(JC.assign_features_by_proximity(
        jnp.asarray(pts), jnp.asarray(tips), jnp.asarray(touch), jnp.asarray(c_img)))
    got = C.assign_features_by_proximity(T(pts), T(tips), T(touch), T(c_img)).numpy()
    for b in range(2):
        keep = ~_undecided(pts[b].T, tips[b])
        assert (~keep).sum() <= 3
        np.testing.assert_array_equal(got[b][keep], want[b][keep])
        assert (np.abs(got[b]).sum(1) > 0).sum() > 150


# ---------------------------------------------------------------------------
# the img loss path (configs/VTacOH/VTacOH_YCB.yaml at small widths)

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth")), n_models=4, n_query=500,
                        n_surface=1000, img_h=16, img_w=12, seed=7)


def _aim(points, tips, rng, per_tip=30):
    """``points`` (B, N, 3) with per_tip of each sample's points moved to
    within 0.07 of each of its fingertips that lies in the box (the
    synthetic set's query points rarely fall within the radius)."""
    points = points.copy()
    for b in range(len(points)):
        slots = rng.permutation(points.shape[1])
        for f, q in enumerate(tips[b]):
            if np.abs(q).max() < 0.5:
                idx = slots[f * per_tip:(f + 1) * per_tip]
                points[b, idx] = q + rng.uniform(-0.07, 0.07, (per_tip, 3))
    return points


@pytest.fixture(scope="module")
def img_setup(synth):
    """The JAX trainer and random weights (every leaf nonzero) on VTacOH at
    small widths, a train batch of two and a validation batch, each with
    query points moved next to the JAX model's fingertips."""
    cfg = _small_cfg("configs/VTacOH/VTacOH_YCB.yaml", *synth)
    cfg["training"]["matmul_precision"] = "highest"
    jmodel, _ = jax_get_model(cfg)
    jtr = JaxTrainer.from_config(jmodel, cfg)
    np.random.seed(0)
    batch = dict(next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                          num_workers=1, seed=0))))
    vb = dict(next(iter(JaxBatchLoader(jax_get_dataset("val", cfg, return_idx=True), 1,
                                       shuffle=False, num_workers=1))))
    shapes = jtr.init_state_abstract(batch)
    rng = np.random.default_rng(14)
    params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
    # the port's fingertips aim the points (the JAX ones agree to 1e-5)
    model = port_img_trainer(cfg, params, stats).model
    for b, key in ((batch, "points"), (vb, "points_iou")):
        with torch.no_grad():
            joints = model.encode_hand_inputs(T(b["inputs"]))["mano_joints"]
            tips = C.tips_in_object_frame(joints, T(b["points.mano"])[:, :3],
                                          T(b["points.wrist"]), T(b["inputs.pc_ply"]))
        b[key] = _aim(np.asarray(b[key]), tips.numpy(), rng).astype(np.float32)
    return cfg, jtr, batch, vb, params, stats


def port_img_trainer(cfg, params, stats):
    model = get_model(cfg, device="cpu")
    load_jax_params(model, params, stats)
    return Trainer.from_config(model, cfg)


def _tips(jtr, v, a):
    """The JAX model's fingertips in the object frame. The hand encoder
    holds no BatchNorm, so train and eval mode give the same."""
    model = jtr.model

    @jax.jit
    def tips(v, a):
        c_hand = model.apply(v, a["inputs"], train=False, method=model.encode_hand_inputs)
        return JC.tips_in_object_frame(c_hand["mano_joints"], a["mano"][:, :3], a["wrist"],
                                       a["pc_ply"])

    keys = ("inputs", "mano", "wrist", "pc_ply")
    return np.asarray(tips(v, {k: a[k] for k in keys}))


def test_img_tree_loads_strict(img_setup):
    """No tactile-to-depth model; the object, hand and image encoders and
    the decoder take the whole JAX tree with strict=True, nothing
    skipped."""
    cfg, _, _, _, params, stats = img_setup
    model = get_model(cfg, device="cpu")
    assert model.encoder_t2d is None and model.mano_layer is not None
    load_jax_params(model, params, stats)
    assert set(params) == {"encoder", "encoder_hand", "encoder_img", "decoder"}
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


def jax_img_step(jtr, state, batch):
    """The JAX trainer's loss, gradients and BatchNorm statistics for one
    step, as Trainer._train_step computes them, and the fingertip sample's
    key."""
    a = jtr.prepare_batch(batch)
    _, step_rng = jax.random.split(state.rng)

    def loss_fn(params):
        with jax.default_matmul_precision(jtr.matmul_precision):
            return jtr._compute_loss(params, state.batch_stats, step_rng, a)

    (_, (scalars, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    return ({k: float(v) for k, v in scalars.items()}, grads, new_bs,
            jax.random.split(step_rng)[1], a)


def test_img_train_step_matches_jax(img_setup):
    """One VTacOH img step with the JAX step's fingertip draws: the loss
    scalars, each module's gradient and ResNet-18's BatchNorm statistics
    after the step. Train-mode BatchNorm normalizes the loader's [0, 1/255]
    images with their batch statistics, so scalars and statistics are held
    by assert_batch_stat's rule against the same step in float64."""
    cfg, jtr, batch, _, params, stats = img_setup
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    want, jgrads, new_bs, key, a = jax_img_step(jtr, state, batch)
    assert not any(k.startswith("encoder_hand") for k in stats)
    tips = _tips(jtr, {"params": params, "batch_stats": stats}, a)
    draws = jax_tip_draws(np.asarray(a["points"]), tips, np.asarray(a["touch_success"]),
                          jtr.num_sample, jtr.tips_per_finger, key)
    assert int((draws["contact_idx"] >= 0).sum()) > 0
    tr = port_img_trainer(cfg, params, stats)
    assert tr.tips_per_finger == 512
    got = tr.train_step(batch, draws=draws)
    assert set(got) == set(want) == {"loss", "loss_l1", "loss_mano", "loss_pc"}

    # the same step in float64 (the loss, without the update)
    tr64 = port_img_trainer(cfg, params, stats)
    tr64.model.double().train()
    a64 = {k: v.double() if v.is_floating_point() else v
           for k, v in tr64.prepare_batch(batch).items()}
    with torch.no_grad():
        _, sc64, _ = tr64._compute_loss_img(a64, draws)
    for k in want:
        assert_batch_stat(k, got[k], want[k], float(sc64[k]))
    f64 = {k: v.numpy() for k, v in tr64.model.state_dict().items()}

    jg = TI.export_state_dict(jgrads, {})
    report = {}
    for mod, grads in module_grads(tr.model).items():
        # the decoder's fc_p (beside fc_p_img) gets no gradient here and a
        # zero one in the JAX package
        unused = [k for k, g in grads.items() if g is None]
        assert all(np.abs(jg[k]).max() == 0 for k in unused), mod
        ours = np.concatenate([np.zeros(jg[k].size) if g is None else g.numpy().ravel()
                               for k, g in grads.items()]).astype(np.float64)
        ref = np.concatenate([jg[k].ravel() for k in grads]).astype(np.float64)
        no, nr = np.linalg.norm(ours), np.linalg.norm(ref)
        report[mod] = cos = float(ours @ ref / (no * nr))
        assert cos >= 0.999 and 0.98 < no / nr < 1.02, (mod, cos, no, nr, report)
    assert set(report) == {"encoder", "encoder_hand", "encoder_img", "decoder"}

    sd_want = TI.export_state_dict({}, new_bs)
    own = tr.model.state_dict()
    assert len(sd_want) > 20 and all(k.startswith("encoder_img.") for k in sd_want)
    for k, v in sd_want.items():
        assert_batch_stat(k, own[k].numpy(), v, f64[k])


def test_img_eval_step_matches_jax(img_setup):
    """Eval mode (running statistics): the loss on the fingertip sample of
    the JAX eval key (split(fold_in(rng, 12345))[1]) and the IoU on the
    whole points_iou set, each point's feature assigned by proximity."""
    cfg, jtr, _, vb, params, stats = img_setup
    v = {"params": params, "batch_stats": stats}
    state = jtr._state_from_variables(v)
    want = jtr.eval_step(state, vb)
    a = jtr.prepare_batch(vb)
    key = jax.random.split(jax.random.fold_in(state.rng, 12345))[1]
    draws = jax_tip_draws(np.asarray(a["points"]), _tips(jtr, v, a),
                          np.asarray(a["touch_success"]), jtr.num_sample,
                          jtr.tips_per_finger, key)
    tr = port_img_trainer(cfg, params, stats)
    got = tr.eval_step(vb, draws)
    assert set(got) == set(want)
    for k in ("iou", "iou_fixed"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for k in ("loss", "loss_l1", "loss_mano", "loss_pc"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    # the IoU's features reach the decode: the proximity rows are not all zero
    tb = tr.prepare_batch(vb)
    with torch.no_grad():
        tips = C.tips_in_object_frame(tr.model.encode_hand_inputs(tb["inputs"])["mano_joints"],
                                      tb["mano"][:, :3], tb["wrist"], tb["pc_ply"])
    feats = C.assign_features_by_proximity(tb["points_iou"], tips, tb["touch_success"],
                                           torch.ones(1, 5, 1))
    assert int(feats.sum()) > 20


# ---------------------------------------------------------------------------
# serving: the mesh, eval_points, predicted-depth gates

def _vtacoh_pair(pair):
    """The VTacOH model at test_torch_setup's widths on both sides, the
    VTacO pair's weights without the t2d stack, the decoder's feature
    conditioning damped by FEATURE_GAIN."""
    cfg, _, v, _ = copy.deepcopy(pair)
    cfg["model"].update(encoder_t2d=False, encoder_t2d_kwargs=False)
    params = {k: x for k, x in v["params"].items() if k != "encoder_t2d"}
    stats = {k: x for k, x in v["batch_stats"].items() if k != "encoder_t2d"}
    dec = params["decoder"]
    for name in dec:
        if name.startswith("fc_c"):
            dec[name]["kernel"] = dec[name]["kernel"] * FEATURE_GAIN
    jmodel, _ = jax_get_model(cfg)
    tmodel = get_model(cfg, device="cpu")
    load_jax_params(tmodel, params, stats)
    return cfg, jmodel, SimpleNamespace(params=params, batch_stats=stats), tmodel


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def vtacoh(pair):
    return _vtacoh_pair(pair)


def aimed_batch(tmodel, seed):
    """test_torch_setup's batch with an object scan of the object's own size
    and the ground-truth wrist placed so that the fingertips land around
    the object, in the box (at zero wrist they lie far outside it)."""
    data = make_batch(np.random.default_rng(seed))
    data["inputs.pc_ply"] = (data["inputs"] * 1.0).astype(np.float32)
    with torch.no_grad():
        joints = tmodel.encode_hand_inputs(T(data["inputs"]))["mano_joints"]
        tips = C.tips_in_object_frame(joints, torch.zeros(1, 3), torch.zeros(1, 3),
                                      T(data["inputs.pc_ply"]))[0].numpy()
    ply = data["inputs.pc_ply"][0]
    scale = 2 * np.sqrt(((ply - ply.mean(0)) ** 2).sum(1)).max()
    data["points.mano"][0, :3] = (np.float32([0.3, 0.0, 0.0]) - tips.mean(0)) * scale
    return data


def _both_gates(jgen, state, tgen, tmodel, data):
    J = {k: jnp.asarray(v) for k, v in data.items()}
    Tt = {k: T(v) for k, v in data.items()}
    jg = jgen._build_gates(state, J["inputs"], J["inputs.img"], J["inputs.depth"],
                           J["inputs.touch_success"] > 0.5, J["inputs.pc_ply"],
                           J["points.mano"], J["points.wrist"], J["points.cam_pos"],
                           J["points.cam_rot"])
    with torch.no_grad():
        tg = tgen._build_gates(tmodel, Tt["inputs.img"], Tt["inputs.depth"],
                               Tt["inputs.touch_success"] > 0.5, Tt["inputs.pc_ply"],
                               Tt["points.cam_pos"], Tt["points.cam_rot"],
                               inputs=Tt["inputs"], mano_gt=Tt["points.mano"],
                               wrist=Tt["points.wrist"])
    return jg, tg


@pytest.mark.parametrize("nx", [32, 64])
def test_vtacoh_mesh_matches_jax(vtacoh, nx):
    """generate_obj_mesh_wnf with fingertip gates (the JAX side through its
    XLA trunk, exact float32 transfer, no iso-band): the same gates, the
    same occupancy, and every port triangle within test_torch_generate's
    bound of one JAX triangle; the decode alone on the JAX grid and gates
    within 1e-5."""
    cfg, jmodel, state, tmodel = vtacoh
    cfg = copy.deepcopy(cfg)
    cfg["generation"]["resolution_0"] = nx // 4
    data = aimed_batch(tmodel, seed=0)
    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, transfer_dtype="float32")
    tgen = get_generator(tmodel, cfg)
    np.random.seed(0)
    (jv, jf), jemd, jcd = jgen.generate_obj_mesh_wnf(state, data)
    np.random.seed(0)
    (tv, tf), temd, tcd = tgen.generate_obj_mesh_wnf(tmodel, data)

    jg, tg = _both_gates(jgen, state, tgen, tmodel, data)
    assert tg[0] == jg[0] == "tips"
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg[2].numpy(), np.asarray(jg[2]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tg[3].numpy(), np.asarray(jg[3]))
    jgrid = jgen._apply(state, jmodel.encode_inputs, jnp.asarray(data["inputs"]), train=False)
    jvals = jgen.eval_points_dense(state, nx, jgrid, *jg, transfer_dtype=jnp.float32)
    with torch.no_grad():
        tvals = tgen.eval_points_dense(tmodel, nx, tmodel.encode_inputs(T(data["inputs"])),
                                       *tg, transfer_dtype=torch.float32)
        tvals_j = tgen.eval_points_dense(
            tmodel, nx, {"grid": T(jgrid["grid"])}, "tips",
            *(T(x) for x in jg[1:]), transfer_dtype=torch.float32)
    # the rows the decode saw: some grid points gated
    p_cn = np.stack(np.meshgrid(*[(1 + PADDING) * (np.arange(nx) / (nx - 1) - 0.5)] * 3,
                                indexing="ij")).reshape(3, -1).astype(np.float32)
    rows = FT.gate_tips_cn(T(p_cn), tg[1], tg[2], tg[3])
    assert int((rows.abs().sum(0) > 0).sum()) > 10
    keep = ~_undecided(p_cn, np.asarray(jg[1]))
    np.testing.assert_allclose(tvals_j[keep], jvals[keep], atol=1e-5, rtol=0)

    def occupied(vals):
        return vals > (vals.min() + vals.max()) / 2

    np.testing.assert_array_equal(occupied(tvals), occupied(jvals))
    assert len(tf) > 100 and (len(tv), len(tf)) == (len(jv), len(jf))
    box = 1 + cfg["data"]["padding"]
    dist, idx = cKDTree_query(_triangles(jv, jf, nx, box), _triangles(tv, tf, nx, box))
    assert len(np.unique(idx)) == len(idx)
    dv = float(np.abs(tvals - jvals).max())
    bound = _vertex_bound(jv * nx / box + nx / 2, jvals.reshape(nx, nx, nx), dv)
    tri_bound = np.minimum(bound[jf].max(axis=1)[idx], MAX_TRI_BOUND)
    assert (dist <= tri_bound).all(), (dist / tri_bound).max()
    assert np.median(dist) <= 1e-4
    assert np.isfinite(tcd) and np.isfinite(temd)


def cKDTree_query(ref, pts):
    from scipy.spatial import cKDTree

    return cKDTree(ref).query(pts, p=np.inf)


def _tip_query_set(rng, route):
    """Fingertip gates on the window tests' grid (five tips, one not
    touching, (5, C) features) and a query set for ``route``: random
    points, a third of them near the tips (window); the complete 33³ cube,
    x slowest (dense); or the nodes of the R = 64 lattice nearest to points
    near the tips, with random nodes, shuffled, as f32 coords (gather)."""
    from test_torch_trunk import C as C_DIM

    tips, near = _tips_and_points(rng, n_near=1500, n_far=0)
    feat = rng.standard_normal((5, C_DIM)).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    box = 1 + PADDING
    if route == "window":
        pts = np.concatenate([near, rng.uniform(-0.6, 0.6, (3000, 3))])
    elif route == "dense":
        c = box * (-0.5 + np.arange(33) / 32)
        pts = np.stack([a.ravel() for a in np.meshgrid(c, c, c, indexing="ij")], 1)
        return tips, feat, valid, pts.astype(np.float32)
    else:
        R = 64
        nodes = np.concatenate([np.rint((near / box + 0.5) * R),
                                rng.integers(0, R + 1, (2000, 3))])
        pts = box * (np.unique(np.clip(nodes, 0, R), axis=0) / R - 0.5)
    return tips, feat, valid, pts[rng.permutation(len(pts))].astype(np.float32)


@pytest.mark.parametrize("route", ["window", "dense", "gather"])
def test_eval_points_tips_matches_jax(gens, monkeypatch, route):  # noqa: F811
    """eval_points with fingertip gates takes the JAX plan's route (the
    window route through K3's c_img rows, as the JAX package's, whose
    Pallas kernel runs in interpret mode; the dense decode and the gather
    route through K2's c_img rows, against the JAX package's XLA trunk)
    and agrees within 2e-5 outside the shell."""
    jgen, state, tgen, tmodel, jc, tc = gens
    tips, feat, valid, pts = _tip_query_set(np.random.default_rng(21), route)
    jg = (jnp.asarray(tips), jnp.asarray(feat), jnp.asarray(valid))
    tg = (T(tips), T(feat), T(valid))
    routes = Routes(tgen, monkeypatch)
    jcalls = _jax_window_calls(jgen, monkeypatch)
    want = jgen.eval_points_fast(state, pts, jc, "tips", *jg, transfer_dtype=jnp.float32,
                                 use_pallas=route == "window")
    got = tgen.eval_points(tmodel, pts, tc, "tips", *tg, transfer_dtype=torch.float32)
    assert routes.n[route] == 1 and sum(routes.n.values()) == 1, routes.n
    assert len(jcalls) == (route == "window")
    rows = FT.gate_tips_cn(T(np.ascontiguousarray(pts.T)), *tg)
    assert int((rows.abs().sum(0) > 0).sum()) > (40 if route == "dense" else 100)
    keep = ~_undecided(pts.T, tips)
    assert (~keep).sum() <= 5
    assert got.shape == (len(pts),) and got.dtype == np.float32
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)


def test_predicted_depth_gates_match_jax(pair):
    """legacy_gt_depth: false on VTacO: the contact gates come from the t2d
    model's depth maps (eval mode, running statistics), denormalized by
    × 0.005 + 0.019. With every pixel a candidate (contact_per_finger =
    H·W) both packages gate with the same contact sets, drawn in another
    order."""
    cfg, jmodel, v, tmodel = pair
    cfg = copy.deepcopy(cfg)
    cfg["training"]["legacy_gt_depth"] = False
    k = H_IMG * W_IMG
    jgen = JGen.from_config(jmodel, cfg, band_transfer=False, contact_per_finger=k)
    tgen = get_generator(tmodel, cfg, contact_per_finger=k)
    data = make_batch(np.random.default_rng(3))
    state = SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    jg, tg = _both_gates(jgen, state, tgen, tmodel, data)
    assert tg[0] == jg[0] == "contact"
    tp_, tf_, tvalid = (x.numpy() for x in tg[1:])
    jp_, jf_, jvalid = (np.asarray(x) for x in jg[1:])
    np.testing.assert_allclose(tf_, jf_, atol=1e-4, rtol=0)
    # the predicted maps, not the ground truth: more pixels than the
    # batch's CONTACTS_PER_FINGER pressed ones
    assert tvalid.sum(1).max() > CONTACTS_PER_FINGER
    for f in range(5):
        a, b = tp_[f][tvalid[f]], jp_[f][jvalid[f]]
        assert len(a) == len(b)
        np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# the CLIs

def test_vtacoh_train_and_generate_clis(synth, tmp_path, capsys):
    """configs/VTacOH/VTacOH_YCB.yaml at small widths through the port's
    CLIs on the CPU: one train step with validation (iou), a checkpoint and
    the loop's visualization (object and hand meshes), then cli.generate
    on the test split from the checkpoint."""
    from vtaco_tpu_torch.cli import generate, train

    cfg = _small_cfg("configs/VTacOH/VTacOH_YCB.yaml", *synth)
    cfg["training"].update(out_dir=str(tmp_path / "h"), batch_size=2, n_workers=1,
                           n_workers_val=1, print_every=1, validate_every=1,
                           checkpoint_every=1, visualize_every=1)
    cfg["generation"].update(resolution_0=4, mc_level="mean")
    path = tmp_path / "h.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train.main([str(path), "--cpu", "--max-iters", "1"])
    out = capsys.readouterr().out
    assert "Validation metric (iou)" in out and "visualize failed" not in out
    assert "loaded pretrained t2d" not in out and "Metrics CD:" in out
    assert os.path.exists(tmp_path / "h" / "model.ckpt")
    vis = sorted(os.listdir(tmp_path / "h" / "vis"))
    assert len(vis) == 2 and [f.split("_")[-1] for f in vis] == ["hand.off", "obj.off"]
    assert all(f.startswith("1_") for f in vis)
    generate.main([str(path), "--cpu", "--checkpoint", "model.ckpt",
                   "--out-dir", str(tmp_path / "gen")])
    line = yaml.safe_load(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["split"] == "test" and line["n"] == 1 and np.isfinite(line["cd_mean"])
    files = sorted(os.listdir(tmp_path / "gen"))
    assert [f.split("_")[-1] for f in files] == ["hand.off", "obj.off"]
    for f in files:
        v, faces = meshio.read_off(str(tmp_path / "gen" / f))
        assert len(faces) > 0 and np.isfinite(v).all()
