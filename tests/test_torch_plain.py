"""The loss paths without tactile images and plane feature fields in the
decode, in the PyTorch port (vtaco_tpu_torch) against the JAX package on
the CPU at small widths.

Loss paths: the plain path (object and hand encoders; no images), the
contact path (``model.with_contact``: the decoder's contact head and its
cross-entropy on ``points.contact``) and the t2d path without images (the
t2d_img step with the plain decoder head), each one train step (loss
scalars, every parameter's gradient) and one eval step, on weights
carried across with ``strict=True``. torch cannot replay jax.random, so
the t2d path's contact draws are the JAX trainer's, fed to the port.

Plane fields: a decoder over a triplane feature dict (with and without a
grid) on the dense route, the gather route (the window route declines
planes in both packages), the batched decodes, and the chunked module
decode (``eval_points(fast=False)``) with no, contact and fingertip
gates, against the JAX package's XLA trunk (``use_pallas=False``).

Tolerances: loss scalars 1e-5 relative; gradients within 1e-5 of each
parameter's largest entry or at a cosine of at least 0.99999; IoU 1e-6;
decoded logits 1e-5 at float32 transfers; points within 1e-6 of a gate's radius (squared, for
the fast routes' expanded distances) are left out.
"""

import copy

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
from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu.models.conv_onet import ConvOccupancyNetwork as JNet
from vtaco_tpu.models.decoder import LocalDecoder as JDecoder
from vtaco_tpu.train.loop import build_mesh_bank as jax_build_mesh_bank
from vtaco_tpu.train.trainer import Trainer as JaxTrainer
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.generate.generator import Generator3D as TGen
from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork as TNet
from vtaco_tpu_torch.train.loop import build_mesh_bank
from vtaco_tpu_torch.train.trainer import Trainer

from test_torch_crop import close_grads, share_cores  # noqa: F401
from test_torch_setup import random_tree
from test_torch_train import PER_FINGER, jax_draws
from test_torch_trunk import C, HID, NB, _decoders
from test_torch_window import Routes, _contacts
from test_trainer import _small_cfg

PADDING = 0.1
ATOL = 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return jax_generate(str(tmp_path_factory.mktemp("synth_plain")), n_models=4,
                        n_query=500, n_surface=1000, img_h=16, img_w=12, seed=7)


def path_cfg(synth, path):
    """VTacO_YCB at tests/test_trainer.py's small widths, without images:
    'plain' (object and hand encoders), 'contact' (the object encoder and
    the contact head), 't2d' (the tactile-to-depth model kept)."""
    cfg = _small_cfg("configs/VTacO/VTacO_YCB.yaml", *synth)
    m = cfg["model"]
    m.update(with_img=False, encoder_img=False)
    if path != "t2d":
        m["encoder_t2d"] = False
    if path == "contact":
        m.update(with_contact=True, encoder_hand=False)
    cfg["training"]["matmul_precision"] = "highest"
    return cfg


@pytest.mark.parametrize("path", ["plain", "contact", "t2d"])
def test_loss_path_steps_match_jax(synth, path):
    """One train step and one eval step of each path. The eval step's IoU
    decodes the whole points_iou set (plain, contact) or a second contact
    sample (t2d), as in the JAX package."""
    cfg = path_cfg(synth, path)
    jmodel, _ = jax_get_model(copy.deepcopy(cfg))
    kw = {"contact_per_finger": PER_FINGER} if path == "t2d" else {}
    jbank = jax_build_mesh_bank(cfg) if path == "t2d" else None
    jtr = JaxTrainer.from_config(jmodel, cfg, mesh_bank=jbank, **kw)
    np.random.seed(0)
    batch = next(iter(JaxBatchLoader(jax_get_dataset("train", cfg), batch_size=2,
                                     num_workers=1, seed=0)))
    shapes = jtr.init_state_abstract(batch)
    rng = np.random.default_rng(6)
    params, stats = random_tree(shapes.params, rng), random_tree(shapes.batch_stats, rng)
    state = jtr._state_from_variables({"params": params, "batch_stats": stats})
    a = jtr.prepare_batch(batch)
    _, step_rng = jax.random.split(state.rng)

    def loss_fn(p):
        return jtr._compute_loss(p, state.batch_stats, step_rng, a)

    (_, (want, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    model = get_model(cfg, device="cpu")
    assert (model.decoder.fc_out_contact is not None) == (path == "contact")
    load_jax_params(model, params, stats)
    tr = Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"), **kw)
    draws = iou_draws = None
    if path == "t2d":
        H, W = a["imgs"].shape[2:4]
        d0 = np.asarray(jtr._depth_origin_for(H * W))

        def draws_of(arrs, key):
            return jax_draws(np.asarray(arrs["depths"]), np.asarray(arrs["touch_success"]),
                             d0, arrs["points"].shape[1], jtr.num_sample, PER_FINGER, key)

        draws = draws_of(a, jax.random.split(step_rng)[1])
    got = tr.train_step(batch, draws=draws)
    assert set(got) == set(want)
    if path == "contact":
        assert "loss_contact" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-5, abs=1e-7), (k, got[k], float(v))
    jg = TI.export_state_dict(jgrads, {})
    grads = {n: (torch.zeros(p.shape) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    assert set(jg) == set(grads)
    report = {}
    close_grads(grads, {k: v for k, v in jg.items() if np.abs(v).max() > 0}, report)
    assert all(grads[k].abs().max() == 0 for k in jg if np.abs(jg[k]).max() == 0)
    assert any(k.startswith("encoder.") for k in report) and any(
        k.startswith("decoder.") for k in report)

    vb = next(iter(JaxBatchLoader(jax_get_dataset("val", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    jwant = jtr.eval_step(state, vb)
    if path == "t2d":
        va = jtr.prepare_batch(vb)
        key = jax.random.fold_in(state.rng, 12345)
        draws, iou_draws = draws_of(va, jax.random.split(key)[1]), draws_of(va, key)
    tr2 = Trainer.from_config(load_jax_params(get_model(cfg, device="cpu"), params, stats),
                              cfg, mesh_bank=build_mesh_bank(cfg, "cpu"), **kw)
    jgot = tr2.eval_step(vb, draws, iou_draws)
    assert set(jgot) == set(jwant)
    for k in ("iou", "iou_fixed"):
        assert jgot[k] == pytest.approx(jwant[k], abs=1e-6, nan_ok=True), k
    for k in jwant:
        if k.startswith("loss"):
            assert jgot[k] == pytest.approx(jwant[k], rel=1e-5, abs=1e-7), k


# ---------------------------------------------------------------------------
# plane fields in the decode

@pytest.fixture(scope="module")
def planes():
    """(JAX generator, state, port generator, port model, fields as JAX and
    port dicts) for a decoder at test_torch_trunk's widths over three 9²
    planes and a 7³ grid (batch axis 2: the batched decodes' objects)."""
    params, tdec = _decoders()
    jmodel = JNet(decoder=JDecoder(c_dim=C, hidden_size=HID, n_blocks=NB))

    class State:
        batch_stats = {}

    State.params = {"decoder": params}
    jgen = JGen(jmodel, padding=PADDING, points_batch_size=300)
    tmodel = TNet(decoder=tdec)
    tgen = TGen(tmodel, padding=PADDING, points_batch_size=300)
    rng = np.random.default_rng(11)
    fields = {k: rng.standard_normal((2, 9, 9, C)).astype(np.float32)
              for k in ("xz", "xy", "yz")}
    fields["grid"] = rng.standard_normal((2, 7, 7, 7, C)).astype(np.float32)
    return jgen, State(), tgen, tmodel, fields


def _fields(fields, with_grid, b=slice(0, 1)):
    keys = [k for k in fields if k != "grid" or with_grid]
    return ({k: jnp.asarray(fields[k][b]) for k in keys},
            {k: T(fields[k][b]) for k in keys})


def _gates(rng, mode):
    """(gating, JAX gates, port gates, tips or contacts as numpy)."""
    if mode == "none":
        return "none", (None, None, None), (None, None, None)
    if mode == "contact":
        q, feat, valid = _contacts(rng, spread=0.3)
    else:
        q = rng.uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
        feat = rng.standard_normal((5, C)).astype(np.float32)
        valid = np.array([True, True, False, True, True])
    return (mode, (jnp.asarray(q), jnp.asarray(feat), jnp.asarray(valid)),
            (T(q), T(feat), T(valid)))


def _keep(pts, mode, gates, squared):
    """Points not within 1e-6 of a gate's radius (of r² with ``squared``)."""
    if mode == "none":
        return np.ones(len(pts), bool)
    q, _, valid = (np.asarray(g, np.float64) for g in gates)
    r = 0.015 if mode == "contact" else 0.05
    q = q.reshape(-1, 3)[np.asarray(valid, bool).reshape(-1)] if mode == "contact" else q
    d = np.linalg.norm(np.asarray(pts, np.float64)[:, None] - q[None], axis=-1)
    near = (np.abs(d ** 2 - r * r) < 1e-6 if squared else np.abs(d - r) < 1e-6).any(axis=1)
    if mode == "tips":   # a tie of two tips decides the row either way
        srt = np.sort(d, axis=1)
        near |= np.abs(srt[:, 1] - srt[:, 0]) < 1e-6
    return ~near


@pytest.mark.parametrize("with_grid", [False, True])
@pytest.mark.parametrize("mode", ["none", "contact", "tips"])
def test_plane_fields_fast_routes_match_jax(planes, monkeypatch, mode, with_grid):
    """The dense route (nx = 12) and the gather route (2,000 random points;
    the window route declines planes) on plane-summed features, against
    the JAX package's XLA trunk."""
    jgen, state, tgen, tmodel, fields = planes
    rng = np.random.default_rng(12)
    jc, tc = _fields(fields, with_grid)
    gating, jg, tg = _gates(rng, mode)
    routes = Routes(tgen, monkeypatch)
    nx = 12
    want = jgen.eval_points_dense(state, nx, jc, gating, *jg, transfer_dtype=jnp.float32,
                                  use_pallas=False)
    got = tgen.eval_points_dense(tmodel, nx, tc, gating, *tg, transfer_dtype=torch.float32)
    ax = np.linspace(-0.5, 0.5, nx, dtype=np.float32) * (1 + PADDING)
    grid_pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    keep = _keep(grid_pts, mode, jg, squared=True)
    np.testing.assert_allclose(got[keep], np.asarray(want)[keep], atol=ATOL, rtol=0)
    pts = rng.uniform(-0.6, 0.6, (2000, 3)).astype(np.float32)
    want = jgen.eval_points_fast(state, pts, jc, gating, *jg, transfer_dtype=jnp.float32,
                                 use_pallas=False)
    got = tgen.eval_points_fast(tmodel, pts, tc, gating, *tg, transfer_dtype=torch.float32)
    keep = _keep(pts, mode, jg, squared=True)
    np.testing.assert_allclose(got[keep], np.asarray(want)[keep], atol=ATOL, rtol=0)
    assert routes.n == {"window": 0, "gather": 1, "dense": 1}, routes.n


@pytest.mark.parametrize("mode", ["none", "contact", "tips"])
def test_plane_fields_chunked_decode_matches_jax(planes, mode):
    """eval_points(fast=False): the decoder module on chunks of 300 (1,000
    points, the last chunk padded), gated per chunk by direct distances,
    on three planes and a grid."""
    jgen, state, tgen, tmodel, fields = planes
    rng = np.random.default_rng(13)
    jc, tc = _fields(fields, True)
    gating, jg, tg = _gates(rng, mode)
    pts = rng.uniform(-0.6, 0.6, (1000, 3)).astype(np.float32)
    if mode != "none":   # points near the gates, so that they take effect
        centers = np.asarray(jg[0]).reshape(-1, 3)
        pts[:400] = (centers[rng.integers(0, len(centers), 400)]
                     + rng.normal(0, 0.02, (400, 3))).astype(np.float32)
    want = np.asarray(jgen.eval_points(state, pts, jc, gating, *jg,
                                       transfer_dtype=jnp.float32, fast=False))
    got = tgen.eval_points(tmodel, pts, tc, gating, *tg, transfer_dtype=torch.float32,
                           fast=False)
    keep = _keep(pts, mode, jg, squared=False)
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)
    if mode != "none":   # the gates changed some logits
        plain = tgen.eval_points(tmodel, pts, tc, transfer_dtype=torch.float32, fast=False)
        assert (np.abs(plain - got) > 1e-4).sum() > 20


def test_plane_fields_batched_decodes_match_jax(planes):
    """decode_dense_batched (nx = 10) and decode_points_batched, fast and
    fast=False, over two objects' planes and grids."""
    jgen, state, tgen, tmodel, fields = planes
    jc, tc = _fields(fields, True, slice(None))
    want = jgen.decode_dense_batched(state, 10, jc, use_pallas=False,
                                     transfer_dtype=jnp.float32)
    got = tgen.decode_dense_batched(tmodel, 10, tc, transfer_dtype=torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    pts = np.random.default_rng(14).uniform(-0.6, 0.6, (2, 700, 3)).astype(np.float32)
    for fast in (True, False):
        want = jgen.decode_points_batched(state, pts, jc, fast=fast, use_pallas=False,
                                          transfer_dtype=jnp.float32, coord_quant=False)
        got = tgen.decode_points_batched(tmodel, pts, tc, fast=fast,
                                         transfer_dtype=torch.float32, coord_quant=False)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=fast)
