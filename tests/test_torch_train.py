"""The training path of the PyTorch port (vtaco_tpu_torch) against the JAX
package on the same weights, batches and random draws: the MANO layer,
the plane encoder with its MANO head, UNet2D, TactileUNet (forward and
train-mode BatchNorm statistics), winding numbers, the t2d contact
sample, IoU, one full VTacO_YCB train step (loss scalars, gradients,
BatchNorm statistics), the optimizers' updates and one eval step; and the
tactile depth-stack pretraining of configs/tactile/tactile_test.yaml (the
tree that loads strictly, one train step and one eval step). The VTacO_YCB
steps themselves (the train and eval steps, skip_unused_t2d, the TF32
flags) are in tests/test_torch_train_step.py, which imports the fixtures
and helpers here.

torch cannot replay jax.random, so the contact sample's draws are computed
here with jax.random from the keys the JAX trainer uses and handed to the
port (``draws=``). Tolerances: MANO 1e-6; module outputs 1e-5 and
BatchNorm statistics 1e-5 relative, or
where the JAX package's float32 statistics are farther than that from a
float64 evaluation, four times closer to it than they are
(assert_batch_stat; the
t2d depth map in train mode 2e-5); winding numbers 1e-5 away from the
surfaces; contact points
1e-6; the train step's loss scalars 5e-4 relative and per-module gradient
cosine >= 0.999 with norms within 2 % (the bars of
tests/test_grad_parity.py); updates 1e-7; IoU 1e-6; the tactile step's
loss scalars 1e-5 relative (in train mode by assert_batch_stat's rule:
its loss_depth normalizes with the U-Net's batch statistics), its
gradients and statistics as the VTacO step's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtaco_tpu.core import torch_import as TI
from vtaco_tpu.core.config import get_model as jax_get_model
from vtaco_tpu.data import BatchLoader as JaxBatchLoader
from vtaco_tpu.data.core import get_dataset as jax_get_dataset
from vtaco_tpu.data.synthetic import generate as jax_generate
from vtaco_tpu.ops import metrics as JM
from vtaco_tpu.ops import winding as JW
from vtaco_tpu.train import contact as JC
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu.utils import meshio as jax_meshio
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.models.mano import ManoLayer
from vtaco_tpu_torch.models.unet2d import UNet2D
from vtaco_tpu_torch.ops import metrics, winding
from vtaco_tpu_torch.ops.geometry import (
    batch_rodrigues,
    coordinate2index,
    normalize_coordinate,
)
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_setup import H_IMG, W_IMG, build_pair, random_tree
from test_trainer import _small_cfg

PER_FINGER = 32


def t(x):
    return torch.as_tensor(np.asarray(x))


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    return build_pair()


# ---------------------------------------------------------------------------
# modules

@pytest.mark.parametrize("variant", ["vtaco", "pca_flat"])
def test_mano_matches_jax(variant):
    from vtaco_tpu.models.mano import ManoLayer as JaxMano

    kw = (dict(center_idx=9, flat_hand_mean=False, ncomps=45, use_pca=False)
          if variant == "vtaco" else dict(center_idx=None, flat_hand_mean=True,
                                          ncomps=6, use_pca=True))
    n = 48 if variant == "vtaco" else 9
    pose = (np.random.default_rng(0).standard_normal((4, n)) * 0.6).astype(np.float32)
    jv, jj = JaxMano(**kw)(jnp.asarray(pose))[:2]
    with torch.no_grad():
        tv, tj = ManoLayer(**kw)(t(pose))[:2]
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-6, rtol=0)


def test_geometry_matches_jax():
    """Plane cell indices equal the JAX package's exactly (outliers and the
    [1 - 1e-5, 1) band included); batch_rodrigues within 1e-6."""
    from vtaco_tpu.ops import geometry as JG

    rng = np.random.default_rng(1)
    p = rng.uniform(-0.7, 0.7, (2, 4000, 3)).astype(np.float32)
    p[0, :8] = 0.55 * (1 + 0.1 + 10e-6) * np.array([1, -1, 1], np.float32)
    for plane in ("xz", "xy", "yz"):
        want = JG.coordinate2index(JG.normalize_coordinate(jnp.asarray(p), 0.1, plane), 16)
        got = coordinate2index(normalize_coordinate(t(p), 0.1, plane), 16, "2d")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    aa = rng.standard_normal((64, 3)).astype(np.float32)
    aa[0] = 0.0
    np.testing.assert_allclose(batch_rodrigues(t(aa)).numpy(),
                               np.asarray(JG.batch_rodrigues(jnp.asarray(aa))),
                               atol=1e-6, rtol=0)


def _cloud(rng, B=2, n=200):
    """Points in the box, with groups sharing one plane cell and exact
    duplicates (ties of the max-pool)."""
    pts = rng.uniform(-0.4, 0.4, (B, n, 3)).astype(np.float32)
    pts[:, 1:40] = pts[:, :1] + 0.002 * rng.standard_normal((B, 39, 3)).astype(np.float32)
    pts[:, 40:50] = pts[:, 60:61]
    return pts


def test_hand_encoder_with_mano_head(pair):
    """LocalPoolPointnet on three planes with UNet2D and the MANO head,
    then the MANO layer on the wrist-zeroed pose (encode_hand_inputs)."""
    _, jmodel, v, tmodel = pair
    pts = _cloud(np.random.default_rng(2))
    want = jmodel.apply(v, jnp.asarray(pts), train=False,
                        method=jmodel.encode_hand_inputs)
    with torch.no_grad():
        got = tmodel.encode_hand_inputs(t(pts))
    assert got["mano_param"].shape == (2, 51) and got["mano_verts"].shape == (2, 778, 3)
    for k in ("mano_param", "mano_verts", "mano_joints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["mano_faces"].numpy(), np.asarray(want["mano_faces"]))


def test_unet2d_matches_jax():
    from vtaco_tpu.models.unet2d import UNet2D as JaxUNet2D

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    jnet = JaxUNet2D(8, depth=3, start_filts=8)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_tree(shapes["params"], rng)
    want = jnet.apply({"params": params}, jnp.asarray(x))
    net = UNet2D(8, in_channels=8, depth=3, start_filts=8)
    sd = {k: torch.as_tensor(np.ascontiguousarray(a))
          for k, a in TI.export_state_dict(params, {}).items()}
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_t2d_forward_and_batch_stats(pair, train):
    """The nested t2d model (TactileUNet depth map + hand encoder). In
    train mode each shared BatchNorm normalizes with batch statistics and
    moves its running statistics twice per block, with the biased batch
    variance, as flax's BatchNorm does."""
    _, jmodel, v, tmodel = pair
    rng = np.random.default_rng(4)
    pts = _cloud(rng)
    imgs = rng.random((2, 5, H_IMG, W_IMG, 3)).astype(np.float32)
    out = jmodel.apply(v, jnp.asarray(pts), jnp.asarray(imgs), train=train,
                       method=jmodel.encode_t2d,
                       mutable=["batch_stats"] if train else False)
    (want_d, want_h), stats = out if train else (out, v)
    model = copy.deepcopy(tmodel).train(train)
    with torch.no_grad():
        got_d, got_h = model.encode_t2d(t(pts), t(imgs))
    assert got_d.shape == (2, 5, H_IMG * W_IMG)
    # in train mode the batch statistics of 10 small images amplify the
    # convolutions' summation-order differences: 2e-5 there
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               atol=2e-5 if train else 1e-5, rtol=0)
    np.testing.assert_allclose(got_h["mano_param"].numpy(),
                               np.asarray(want_h["mano_param"]), atol=1e-5, rtol=0)
    sd = TI.export_state_dict(v["params"], stats["batch_stats"])
    own = model.state_dict()
    keys = [k for k in sd if k.startswith("encoder_t2d.") and "running" in k]
    assert len(keys) == 6
    for k in keys:
        assert rel_err(own[k].numpy(), sd[k]) < 1e-5, k
        moved = rel_err(own[k].numpy(), TI.export_state_dict(v["params"],
                                                             v["batch_stats"])[k])
        assert (moved > 1e-3) == train, k


def test_scatter_max_gradient_at_ties(pair):
    """Gradients through the hand encoder's plane max-pool, where many
    points share a cell and duplicated points tie exactly: torch's amax
    and XLA's segment max both split a tie's gradient evenly."""
    _, jmodel, v, tmodel = pair
    pts = _cloud(np.random.default_rng(5))
    target = np.random.default_rng(6).standard_normal((2, 51)).astype(np.float32)

    def jloss(params):
        out = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                           jnp.asarray(pts), train=False, method=jmodel.encode_hand_inputs)
        return jnp.mean((out["mano_param"] - target) ** 2) + jnp.mean(out["mano_verts"] ** 2)

    jgrads = TI.export_state_dict(jax.grad(jloss)(v["params"])["encoder_hand"], {})
    model = copy.deepcopy(tmodel)
    out = model.encode_hand_inputs(t(pts))
    loss = torch.mean((out["mano_param"] - t(target)) ** 2) + torch.mean(out["mano_verts"] ** 2)
    loss.backward()
    for name, p in model.encoder_hand.named_parameters():
        want = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-3), err_msg=name)


def _winding_f64(verts, faces, points):
    """The direct van Oosterom–Strackee sum in float64."""
    tri = verts.astype(np.float64)[faces]
    r = tri[None] - points.astype(np.float64)[:, None, None, :]
    a, b, c = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    la, lb, lc = (np.linalg.norm(x, axis=-1) for x in (a, b, c))
    dot = lambda x, y: np.einsum("pfi,pfi->pf", x, y)   # noqa: E731
    det = dot(a, np.cross(b, c))
    den = la * lb * lc + dot(a, b) * lc + dot(b, c) * la + dot(c, a) * lb
    return (2 * np.arctan2(det, den)).sum(1) / (4 * np.pi)


def test_winding_numbers_match_jax():
    """A sphere far from the origin (the centering keeps it exact) and a
    box, padded to one size. Points farther than 0.05 from the surfaces
    agree with the JAX package within 1e-5. Nearer to a surface the
    expanded float32 form of both packages cancels (the solid angle of a
    near triangle is ill-conditioned), and every point, 2 % off the
    sphere's surface included, is held within 3e-4 of a float64
    evaluation, which bounds the JAX package's own error (1.2e-4 here)."""
    rng = np.random.default_rng(7)
    sv, sf = jax_meshio.icosphere(2, radius=0.3)
    half = np.array([0.25, 0.15, 0.2], np.float32)
    bv, bf = jax_meshio.box(tuple(2 * half))
    meshes = [(sv + 5.0, sf), (bv, bf)]
    pv, pf = zip(*(JW.pad_mesh(v_, f_, 200, 400) for v_, f_ in meshes))
    pv, pf = np.stack(pv), np.stack(pf)
    pts = rng.uniform(-0.4, 0.4, (2, 500, 3)).astype(np.float32)
    pts[0, :100] = sv[rng.integers(0, len(sv), 100)] * (
        1 + 0.02 * np.sign(rng.standard_normal((100, 1))))
    far = [np.abs(np.linalg.norm(pts[0], axis=1) - 0.3) > 0.05,
           np.abs(np.max(np.abs(pts[1]) - half, axis=1)) > 0.05]
    pts[0] += 5.0
    want = np.asarray(JW.winding_number_batch(jnp.asarray(pv), jnp.asarray(pf),
                                              jnp.asarray(pts)))
    got = winding.winding_number_batch(t(pv), t(pf), t(pts), face_chunk=96).numpy()
    for b in range(2):
        assert far[b].sum() > 200
        np.testing.assert_allclose(got[b][far[b]], want[b][far[b]], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[b], _winding_f64(pv[b], pf[b], pts[b]), atol=3e-4,
                                   rtol=0)
    single = winding.winding_number(t(pv[1]), t(pf[1]), t(pts[1])).numpy()
    np.testing.assert_allclose(single[far[1]], want[1][far[1]], atol=1e-5, rtol=0)


def jax_draws(depths, touch, depth_origin, n_query, num_sample, per_finger, key):
    """The draws jax's t2d_contact_sample makes from ``key``, in the port's
    ``draws`` form: the same key splits (by batch row, then six ways) and
    the same top-k and randint."""
    per_finger = min(per_finger, num_sample // 5)
    cidx, ridx = [], []
    for b, kb in enumerate(jax.random.split(key, depths.shape[0])):
        rngs = jax.random.split(kb, 6)
        rows = []
        for f in range(5):
            mask = (jnp.abs(jnp.asarray(depths[b, f]) - jnp.asarray(depth_origin))
                    > 0.0001) & bool(touch[b, f])
            rows.append(np.asarray(JC.random_topk_select(mask, per_finger, rngs[f])[0]))
        cidx.append(rows)
        ridx.append(np.asarray(jax.random.randint(rngs[5], (num_sample,), 0, n_query)))
    return {"contact_idx": t(np.asarray(cidx)), "rand_idx": t(np.asarray(ridx))}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth")), n_models=4, n_query=500,
                        n_surface=1000, img_h=16, img_w=12, seed=7)


@pytest.fixture(scope="module")
def setup(synth):
    """The JAX trainer and the port's on the same weights (random, every
    leaf nonzero), and one train batch of two samples."""
    root, mesh_root = synth
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", root, mesh_root)
    cfg["training"]["matmul_precision"] = "highest"
    jmodel, _ = jax_get_model(cfg)
    jbank = jax_build_mesh_bank(cfg)
    jtr = JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank,
                                 contact_per_finger=PER_FINGER)
    ds = jax_get_dataset("train", cfg)
    np.random.seed(0)   # the items' subsampling and noise draw from it
    batch = next(iter(JaxBatchLoader(ds, batch_size=2, num_workers=1, seed=0)))
    shapes = jtr.init_state_abstract(batch)
    rng = np.random.default_rng(8)
    params = random_tree(shapes.params, rng)
    stats = random_tree(shapes.batch_stats, rng)
    return cfg, jtr, batch, params, stats


def port_trainer(cfg, params, stats, **kw):
    model = get_model(cfg, device="cpu")
    load_jax_params(model, params, stats)
    return Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                               contact_per_finger=PER_FINGER, **kw)


def test_t2d_contact_sample_matches_jax(setup):
    cfg, jtr, batch, _, _ = setup
    a = jtr.prepare_batch(batch)
    H, W = a["imgs"].shape[2:4]
    d_origin = jtr._depth_origin_for(H * W)
    key = jax.random.PRNGKey(3)
    want = JC.t2d_contact_sample(a["depths"], a["touch_success"], a["cam_pos"],
                                 a["cam_rot"], a["pc_ply"], a["points"], d_origin,
                                 jtr._cam_f(H), H, W, jtr.num_sample, PER_FINGER, key)
    draws = jax_draws(np.asarray(a["depths"]), np.asarray(a["touch_success"]),
                      np.asarray(d_origin), a["points"].shape[1], jtr.num_sample,
                      PER_FINGER, key)
    got = C.t2d_contact_sample(t(a["depths"]), t(a["touch_success"]), t(a["cam_pos"]),
                               t(a["cam_rot"]), t(a["pc_ply"]), t(a["points"]),
                               t(d_origin), jtr._cam_f(H), H, W, jtr.num_sample,
                               PER_FINGER, draws=draws)
    assert int(want.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.finger.numpy(), np.asarray(want.finger))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-6,
                               rtol=0)
    c_img = np.random.default_rng(9).standard_normal((2, 5, 8)).astype(np.float32)
    for init in ("ones", "zeros"):
        np.testing.assert_array_equal(
            C.scatter_finger_features(t(c_img), got, init).numpy(),
            np.asarray(JC.scatter_finger_features(jnp.asarray(c_img), want, init)))
    # the port's own draws: fixed counts, contacts only where the mask holds
    own = C.t2d_contact_sample(t(a["depths"]), t(a["touch_success"]), t(a["cam_pos"]),
                               t(a["cam_rot"]), t(a["pc_ply"]), t(a["points"]),
                               t(d_origin), jtr._cam_f(H), H, W, jtr.num_sample,
                               PER_FINGER, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(own.valid.sum(1).numpy(), np.asarray(want.valid.sum(1)))


@pytest.mark.parametrize("legacy", [True, False])
def test_compute_iou_matches_jax(legacy):
    rng = np.random.default_rng(10)
    occ = (rng.random((3, 400)) > 0.6).astype(np.float32)
    logits = rng.standard_normal((3, 400)).astype(np.float32)
    want = JM.compute_iou(jnp.asarray(occ), jnp.asarray(logits), 0.2,
                          legacy_mean_threshold=legacy)
    got = metrics.compute_iou(t(occ), t(logits), 0.2, legacy_mean_threshold=legacy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the train step

def jax_step(jtr, state, batch):
    """The JAX trainer's step with its gradients: (scalars, grads, new
    state, the contact sample's key), as Trainer._train_step computes
    them."""
    a = jtr.prepare_batch(batch)
    _, step_rng = jax.random.split(state.rng)

    def loss_fn(params):
        loss, aux = jtr._compute_loss(params, state.batch_stats, step_rng, a)
        return loss, aux

    (_, (scalars, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    new_state, scalars2 = jtr.train_step(state, batch)
    for k, v in scalars.items():
        assert abs(float(v) - scalars2[k]) <= 1e-6 * max(abs(scalars2[k]), 1)
    return scalars2, grads, new_state, jax.random.split(step_rng)[1], a


def module_grads(model):
    """{top-level module: {name: grad}}, None where the loss does not reach
    the parameter."""
    out = {}
    for name, p in model.named_parameters():
        out.setdefault(name.split(".")[0], {})[name] = p.grad
    return out


def batch_stats_f64(cfg, params, stats, batch):
    """The running statistics one train-mode forward of the t2d model and
    ResNet-18 leaves, evaluated by the port in float64."""
    model = get_model(cfg, device="cpu")
    load_jax_params(model, params, stats)
    model = model.double().train()
    imgs = torch.as_tensor(np.asarray(batch["inputs.img"]), dtype=torch.float64)
    with torch.no_grad():
        model.encode_t2d(torch.as_tensor(np.asarray(batch["inputs"]), dtype=torch.float64),
                         imgs)
        model.encode_img_inputs(imgs)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def assert_batch_stat(name, got, want, exact):
    """Within 1e-5 relative of the JAX package's statistic, or, where the
    JAX package's own float32 value is farther than that from a float64
    evaluation, at least four times closer to the float64 value than the
    JAX value is. The second case is the t2d U-Net's first blocks on the
    loader's images, which the reference's double division by 255 puts in
    [0, 1/255]: there the batch variance is small beside the squared mean,
    flax's one-pass variance cancels, and XLA's reduction order leaves the
    JAX statistics about 1e-4 off, where the port's stay near 1e-5
    (measured on this test's batch: 1.1e-4 against 1.3e-5)."""
    err = rel_err(got, want)
    if err < 1e-5:
        return
    own, theirs = rel_err(got, exact), rel_err(want, exact)
    assert own <= theirs / 4, (name, err, own, theirs)


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_optimizer_update_matches_optax(opt):
    """Two updates from identical gradients: torch.optim.Adam against
    optax.adam(lr) (β 0.9/0.999, ε 1e-8), SGD against optax.sgd with
    momentum 0.9."""
    rng = np.random.default_rng(12)
    w0 = rng.standard_normal((300,)).astype(np.float32)
    grads = [rng.standard_normal((300,)).astype(np.float32) * s for s in (1.0, 1e-3)]
    tx = optax.adam(1e-4) if opt == "Adam" else optax.sgd(1e-4, momentum=0.9)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(t(w0).clone())
    holder = torch.nn.Module()
    holder.p = p
    tr = Trainer(holder, lr=1e-4, opt=opt, with_img=True, encode_t2d=True)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
        p.grad = t(g).clone()
        tr.optimizer.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# the tactile depth stack (configs/tactile/tactile_test.yaml)

@pytest.fixture(scope="module")
def tactile_setup(synth):
    """The tactile config at small widths, the JAX trainer and random
    weights for it (every leaf nonzero), and one train batch of two."""
    root, mesh_root = synth
    cfg = _small_cfg("configs/tactile/tactile_test.yaml", root, mesh_root)
    cfg["training"]["matmul_precision"] = "highest"
    jmodel, _ = jax_get_model(cfg)
    jtr = JaxTrainer.from_config(jmodel, cfg)
    np.random.seed(0)   # the items' subsampling and noise draw from it
    batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                     num_workers=1, seed=0)))
    shapes = jtr.init_state_abstract(batch)
    rng = np.random.default_rng(13)
    return cfg, jtr, batch, random_tree(shapes.params, rng), random_tree(
        shapes.batch_stats, rng)


def test_tactile_tree_loads_strict(tactile_setup):
    """No object encoder and no decoder (``encoder: false``, ``decoder:
    false``); the plane hand encoder (c_dim 512 from the defaults, shrunk
    here) and the depth U-Net take the whole JAX tree with strict=True and
    nothing skipped."""
    from vtaco_tpu_torch.models.layers import TactileUNet

    cfg, _, _, params, stats = tactile_setup
    model = get_model(cfg, device="cpu")
    assert model.encoder is None and model.decoder is None and model.encoder_t2d is None
    assert isinstance(model.encoder_img, TactileUNet) and model.hand_out_dim == 30
    load_jax_params(model, params, stats)
    assert set(params) == {"encoder_hand", "encoder_img"}
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())
    for k, v in TI.export_state_dict(params, stats).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("step", ["train", "eval"])
def test_tactile_step_matches_jax(tactile_setup, step):
    """The tactile loss: L1 of the predicted depth maps to the min-max
    normalized depths plus the sensor-pose MSE. Eval (running
    statistics): the loss scalars only, as the JAX eval step reports them,
    within 1e-5 relative. Train: the loss scalars, each module's gradient
    and the BatchNorm statistics after the step. In train mode the depth
    U-Net normalizes the loader's images (in [0, 1/255]) with their batch
    statistics, whose one-pass variance cancels, so the loss scalars and
    the statistics are held to the JAX values, or, where those are farther
    than 1e-5 from the same step evaluated by the port in float64, four
    times closer to the float64 values (assert_batch_stat; measured on a
    batch of this set: JAX's loss_depth 7.2e-6 from float64, the port's
    6.2e-7)."""
    cfg, jtr, batch, params, stats = tactile_setup
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    tr = port_trainer(cfg, params, stats)
    if step == "eval":
        want, got = jtr.eval_step(state, batch), tr.eval_step(batch)
        assert set(got) == set(want) == {"loss", "loss_depth", "loss_digit"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), (k, got[k], want[k])
        return
    want, jgrads, new_state, _, _ = jax_step(jtr, state, batch)
    got = tr.train_step(batch)
    # the same train-mode forward in float64
    model = get_model(cfg, device="cpu")
    load_jax_params(model, params, stats)
    tr64 = Trainer(model.double().train(), train_tactile=True)
    a = {k: v.double() if v.is_floating_point() else v
         for k, v in tr64.prepare_batch(batch).items()}
    with torch.no_grad():
        exact = {k: float(v) for k, v in tr64._compute_loss_tactile(a)[1].items()}
    f64 = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want) == {"loss", "loss_depth", "loss_digit"}
    for k in want:
        assert_batch_stat(k, got[k], want[k], exact[k])

    jg = TI.export_state_dict(jgrads, {})
    for mod, grads in module_grads(tr.model).items():
        ours = np.concatenate([g.numpy().ravel() for g in grads.values()]).astype(np.float64)
        ref = np.concatenate([jg[k].ravel() for k in grads]).astype(np.float64)
        no, nr = np.linalg.norm(ours), np.linalg.norm(ref)
        cos = float(ours @ ref / (no * nr))
        assert cos >= 0.999 and 0.98 < no / nr < 1.02, (mod, cos, no, nr)
    assert set(module_grads(tr.model)) == {"encoder_hand", "encoder_img"}

    sd_want = TI.export_state_dict({}, new_state.batch_stats)
    own = tr.model.state_dict()
    assert len(sd_want) == 6   # three U-Net blocks at depth 2: mean and variance
    for k, v in sd_want.items():
        assert_batch_stat(k, own[k].numpy(), v, f64[k])
