"""The option branches of the PyTorch port (vtaco_tpu_torch) that no shipped
config reaches, against the JAX package on the CPU, and the port's two host
modules.

Each branch is held in float64 on both sides (the port in double, the JAX
package under ``jax.enable_x64``) to 1e-9 of the largest entry, on JAX's
weights loaded strictly into the port (``load_jax_params``):

- UNet3D's layer orders 'b' (BatchNorm: a train-mode forward and backward,
  the moved running statistics, then eval mode), 'l' and 'e';
- ``basic_module: ext_resnet`` (ResidualUNet3D) at one level; at two
  levels its transposed conv returns 2n - 1 voxels where the skip holds 2n,
  the JAX package fails at the join, and the port raises there (F9 (c));
  the transposed conv itself against flax's;
- UNet2D's and the tactile U-Net's bilinear ``up_mode`` (a 1x1 conv after
  bilinear x2: ``F.interpolate`` clamps at the border where
  ``jax.image.resize`` renormalizes, with the same values);
- ManoLayer's 6D root rotation and ``return_transf``;
- the four decoders with ``c_dim`` 0, and F9 (a) and (b): the JAX
  package's fast trunk and its attention fusion fail on them, and the port
  raises at the same places.

Then ``data/npz_cache.py`` (the LRU, its size limit, read-only views,
threads) and ``core/registry.py``.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vtaco_tpu.core.registry import decoder_dict as jax_decoders
from vtaco_tpu.core.registry import encoder_dict as jax_encoders
from vtaco_tpu.data.npz_cache import load_npz as jax_load_npz
from vtaco_tpu.models import decoder as JD
from vtaco_tpu.models import layers as JL
from vtaco_tpu.models import unet2d as JU2
from vtaco_tpu.models import unet3d as JU3
from vtaco_tpu.models.mano import ManoLayer as JMano
from vtaco_tpu.ops import fast_trunk as JFT
from vtaco_tpu.ops.geometry import rot6d_to_rotmat as j_rot6d
from vtaco_tpu_torch.core import registry
from vtaco_tpu_torch.core.config import get_model
from vtaco_tpu_torch.core.weights import export_state_dict, load_jax_params
from vtaco_tpu_torch.data import npz_cache
from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.models import decoder as TD
from vtaco_tpu_torch.models import layers as TL
from vtaco_tpu_torch.models import unet2d as TU2
from vtaco_tpu_torch.models import unet3d as TU3
from vtaco_tpu_torch.models.mano import ManoLayer
from vtaco_tpu_torch.ops import fast_trunk as TFT
from vtaco_tpu_torch.ops.geometry import rot6d_to_rotmat
from vtaco_tpu_torch.train.trainer import check_trainer_init

from families import rel
from test_torch_setup import port_cfg, random_tree

TOL = 1e-9


def f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64))
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else x, tree)


def jax_variables(module, *args, method=None, seed=0, **kw):
    """Random float32 variables of ``module`` (random_tree on init's shapes)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                method=method, **kw))
    rng = np.random.default_rng(seed)
    return {k: random_tree(v, rng) for k, v in shapes.items()}


def port_load(module, v):
    load_jax_params(module, v.get("params", {}), v.get("batch_stats", {}))
    return module.double()


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want), (what, got.shape, np.shape(want))
    assert rel(got, want) <= TOL, (what, rel(got, want))


def nchw(x):
    """channel-last numpy → channels-first float64 tensor."""
    return torch.as_tensor(np.moveaxis(np.asarray(x, np.float64), -1, 1).copy())


def last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# UNet3D

@pytest.mark.parametrize("order", ["cbr", "bcl", "gce"])
def test_unet3d_layer_orders_match_jax(order):
    """A train-mode forward and backward (BatchNorm's batch statistics and
    the running statistics it moves), then an eval-mode forward."""
    kw = dict(num_levels=2, f_maps=4, in_channels=4, out_channels=3, layer_order=order,
              num_groups=2)
    jnet = JU3.build_unet3d(kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 4, 4))
    cot = rng.standard_normal((2, 4, 4, 4, 3))
    v = jax_variables(jnet, x.astype(np.float32), train=False)
    with jax.enable_x64(True):
        v64 = f64(v)

        def loss(params):
            y, upd = jnet.apply(dict(v64, params=params), jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd)

        (_, (y, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v64["params"])
        y_eval = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x), train=False))(
            dict(v64, **upd))
    net = port_load(TU3.build_unet3d(kw), v)
    net.train()
    xt = nchw(x)
    out = net(xt)
    (out * nchw(cot)).sum().backward()
    close(last(out), y, "train forward")
    want = export_state_dict(jax.tree.map(np.asarray, grads), {})
    for name, p in net.named_parameters():
        close(p.grad, want[name], name)
    if "b" in order:
        stats = export_state_dict({}, jax.tree.map(np.asarray, upd["batch_stats"]))
        assert stats and all(k in net.state_dict() for k in stats)
        for name, s in stats.items():
            close(net.state_dict()[name], s, name)
    net.eval()
    with torch.no_grad():
        close(last(net(xt)), y_eval, "eval forward")


def test_residual_unet3d_matches_jax():
    """basic_module ext_resnet at one level (ExtResNetBlock and the final
    conv; ResidualUNet3D alike); the transposed conv of its decoder levels
    against flax's ConvTranspose; at two levels the JAX package fails at
    the join and the port raises F9 (c) there."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 5, 5, 4))
    kw = dict(num_levels=1, f_maps=6, in_channels=4, out_channels=3, basic_module="ext_resnet",
              layer_order="gce", num_groups=2)
    jnet = JU3.build_unet3d(kw)
    v = jax_variables(jnet, x.astype(np.float32), train=False)
    with jax.enable_x64(True):
        want = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x), train=False))(f64(v))
    for net in (TU3.build_unet3d(kw),
                TU3.ResidualUNet3D(4, 3, f_maps=6, layer_order="gce", num_groups=2,
                                   num_levels=1)):
        net = port_load(net, v).eval()
        with torch.no_grad():
            close(last(net(nchw(x))), want, "ext_resnet")

    up = fnn.ConvTranspose(5, (3, 3, 3), strides=(2, 2, 2), padding=1)
    uv = jax_variables(up, x.astype(np.float32))
    with jax.enable_x64(True):
        uwant = jax.jit(lambda v: up.apply(v, jnp.asarray(x)))(f64(uv))
    tup = TU3._UpConv3d(4, 5).double()
    with torch.no_grad():
        tup.weight.copy_(torch.as_tensor(np.asarray(uv["params"]["kernel"], np.float64)
                                         .transpose(4, 3, 0, 1, 2).copy()))
        tup.bias.copy_(torch.as_tensor(np.asarray(uv["params"]["bias"], np.float64)))
        got = tup(nchw(x))
    assert got.shape[2:] == (9, 9, 9)
    close(last(got), uwant, "transposed conv")

    kw2 = dict(kw, num_levels=2, f_maps=4, in_channels=4)
    x4 = np.ones((1, 4, 4, 4, 4), np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: JU3.build_unet3d(kw2).init(jax.random.PRNGKey(0), x4))
    with pytest.raises(NotImplementedError, match=r"F9 \(c\)"):
        TU3.build_unet3d(kw2)(nchw(x4).float())


# ---------------------------------------------------------------------------
# the 2D U-Nets' bilinear up_mode

def test_bilinear_x2_border_matches_jax():
    """F.interpolate(align_corners=False) clamps the source index and
    jax.image.resize renormalizes its kernel over the taps inside: at x2
    both give the edge itself, and every other value alike."""
    x = np.random.default_rng(3).standard_normal((2, 5, 7, 3))
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), "bilinear"))
    got = last(torch.nn.functional.interpolate(nchw(x), scale_factor=2, mode="bilinear",
                                               align_corners=False))
    close(got, want, "bilinear x2")
    for out in (got, want):
        np.testing.assert_allclose(out[:, 0, 0], x[:, 0, 0], rtol=0, atol=1e-14)
        np.testing.assert_allclose(out[:, -1, -1], x[:, -1, -1], rtol=0, atol=1e-14)


@pytest.mark.parametrize("net", ["unet2d", "tactile"])
def test_unet_bilinear_up_mode_matches_jax(net):
    """UNet2D (the hand encoder's plane U-Net) and the tactile depth U-Net
    with up_mode 'upsample': ``upconv_1x1`` loads as a plain conv, and the
    forwards agree (the tactile one in train mode, then in eval mode on the
    running statistics that its train forward moved)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4, 3))
    if net == "unet2d":
        jnet = JU2.UNet2D(num_classes=5, in_channels=3, depth=3, start_filts=4,
                          up_mode="upsample")
        tnet = TU2.UNet2D(5, in_channels=3, depth=3, start_filts=4, up_mode="upsample")
        kw = {}
    else:
        jnet = JL.TactileUNet(num_classes=1, depth=3, start_filts=4, up_mode="upsample")
        tnet = TL.TactileUNet(1, depth=3, start_filts=4, up_mode="upsample")
        kw = {"train": True}
    v = jax_variables(jnet, x.astype(np.float32), **kw)
    assert "upconv_1x1" in v["params"]["up0"]
    with jax.enable_x64(True):
        if kw:
            want, upd = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x), train=True,
                                                     mutable=["batch_stats"]))(f64(v))
            want_eval = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x), train=False))(
                dict(f64(v), **upd))
        else:
            want = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x)))(f64(v))
    tnet = port_load(tnet, v).train()
    with torch.no_grad():
        close(last(tnet(nchw(x))), want, net)
        if kw:
            close(last(tnet.eval()(nchw(x))), want_eval, f"{net} eval")


# ---------------------------------------------------------------------------
# MANO

@pytest.fixture(scope="module")
def mano_pose():
    rng = np.random.default_rng(5)
    return rng.standard_normal((3, 6 + 45)) * 0.3, rng.standard_normal((3, 3)) * 0.1


@pytest.mark.parametrize("case", ["rotmat", "rotmat_trans", "axisang_no_center"])
def test_mano_options_match_jax(mano_pose, case):
    """The 6D root rotation (root_rot_mode 'rotmat') and return_transf:
    vertices, joints, the (B, 16, 4, 4) transforms and the full pose."""
    pose, trans = mano_pose
    kw = dict(center_idx=None if case == "axisang_no_center" else 9, use_pca=False,
              flat_hand_mean=False, return_transf=True, return_full_pose=True,
              root_rot_mode="axisang" if case == "axisang_no_center" else "rotmat")
    pose = pose[:, :48] if case == "axisang_no_center" else pose
    t = trans if case == "rotmat_trans" else None
    jl = JMano(**kw)
    with jax.enable_x64(True):
        for k, a in list(vars(jl).items()):
            if isinstance(a, jax.Array) and np.issubdtype(a.dtype, np.floating):
                setattr(jl, k, jnp.asarray(np.asarray(a, np.float64)))
        want = jax.jit(lambda x, t: jl(x, trans=t))(
            jnp.asarray(pose), None if t is None else jnp.asarray(t))
    got = ManoLayer(**kw).double()(torch.as_tensor(pose),
                                   trans=None if t is None else torch.as_tensor(t))
    assert len(got) == len(want) == 4
    for name, g, w in zip(("verts", "joints", "transf", "full_pose"), got, want):
        close(g, w, name)


def test_rot6d_and_mano_modes_match_jax():
    x = np.random.default_rng(6).standard_normal((4, 6))
    with jax.enable_x64(True):
        want = j_rot6d(jnp.asarray(x))
    close(rot6d_to_rotmat(torch.as_tensor(x)), want, "rot6d")
    for kw, err in ((dict(root_rot_mode="quat"), KeyError),
                    (dict(use_pca=True, joint_rot_mode="rotmat"), TypeError)):
        with pytest.raises(err):
            JMano(**kw)
        with pytest.raises(err):
            ManoLayer(**kw)


# ---------------------------------------------------------------------------
# the decoders with c_dim 0

def _decoder_case(name):
    """(JAX decoder, port decoder, query, field, the methods to compare)."""
    rng = np.random.default_rng(7)
    p = rng.uniform(-0.5, 0.5, (1, 12, 3))
    field = {"grid": rng.standard_normal((1, 4, 4, 4, 8))}
    kw = dict(c_dim=0, hidden_size=8, n_blocks=2)
    if name == "simple_local":
        return (JD.LocalDecoder(with_contact=True, **kw), TD.LocalDecoder(with_contact=True, **kw),
                p, field, ("__call__", "forward_img", "forward_contact"))
    if name == "attention_local":
        return (JD.AttentionDecoder(with_contact=True, input_size=12, **kw),
                TD.AttentionDecoder(with_contact=True, **kw), p, field,
                ("__call__", "forward_contact"))
    if name == "simple_local_crop":
        return (JD.PatchLocalDecoder(**kw), TD.PatchLocalDecoder(**kw),
                {"p": p, "p_n": {"grid": p + 0.5}}, field, ("__call__",))
    return (JD.LocalPointDecoder(**kw), TD.LocalPointDecoder(**kw), p,
            (p, rng.standard_normal((1, 12, 8))), ("__call__",))


def _args(method, p, c, c_img, conv):
    return (conv(p), conv(c)) + ((conv(c_img),) if method == "forward_img" else ())


def _conv32(t):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), t)


def _decoder_pair(name):
    """_decoder_case's with the JAX variables of every compared head, the
    port decoder loaded from them strictly, and the JAX heads in float64."""
    jdec, tdec, p, field, methods = _decoder_case(name)
    c_img = np.zeros((1, 12, 0))

    def init_fn(m, p, c, c_img):
        return [getattr(m, meth)(*((p, c) + ((c_img,) if meth == "forward_img" else ())))
                for meth in methods]

    v = jax_variables(jdec, *(_conv32(a) for a in (p, field, c_img)), method=init_fn)
    assert not any(k.startswith("fc_c") for k in v["params"])
    tdec = port_load(tdec, v)
    with jax.enable_x64(True):
        want = jax.jit(lambda v, *a: jdec.apply(v, *a, method=init_fn))(
            f64(v), *(jax.tree.map(jnp.asarray, a) for a in (p, field, c_img)))
    return jdec, tdec, v, p, field, c_img, methods, want


@pytest.mark.parametrize("name", ["simple_local", "attention_local", "simple_local_crop",
                                  "simple_local_point"])
def test_decoders_without_features_match_jax(name):
    """No fc_c and no feature sampling: every head the decoder has against
    the JAX package's; AttentionDecoder's forward_img fails in the JAX
    package (ZeroDivisionError in the fusion) and raises F9 (b) in the
    port."""
    jdec, tdec, v, p, field, c_img, methods, want = _decoder_pair(name)
    assert tdec.fc_c is None
    tconv = lambda t: jax.tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float64)), t,
                                   is_leaf=lambda a: isinstance(a, np.ndarray))
    with torch.no_grad():
        for meth, w in zip(methods, want):
            fn = tdec if meth == "__call__" else getattr(tdec, meth)
            got = fn(*_args(meth, p, field, c_img, tconv))
            for g, ww in zip(*((got, w) if isinstance(got, tuple) else ((got,), (w,)))):
                close(g, ww, f"{name}.{meth}")
    if name == "attention_local":
        with pytest.raises(ZeroDivisionError):
            jdec.init(jax.random.PRNGKey(0), *(_conv32(a) for a in (p, field, c_img)),
                      method=jdec.forward_img)
        with pytest.raises(NotImplementedError, match=r"F9 \(b\)"):
            tdec.forward_img(*_args("forward_img", p, field, c_img, tconv))
        holder = torch.nn.Module()
        holder.decoder = tdec
        with pytest.raises(NotImplementedError, match=r"F9 \(b\)"):
            check_trainer_init(holder)


def test_fast_routes_without_features_raise_as_jax_fails():
    """F9 (a): the JAX package's extract_trunk_params needs fc_c0 (a
    KeyError on a c_dim 0 LocalDecoder); the port's raises F9 (a), and so
    does eval_points on its fast route, while the legacy decode runs."""
    jdec, tdec, v, p, field, _, _, want = _decoder_pair("simple_local")
    with pytest.raises(KeyError, match="fc_c0"):
        JFT.extract_trunk_params(v["params"], 2, with_img=False)
    model = torch.nn.Module()
    model.decoder = tdec.float()
    model.decode = lambda pts, c: model.decoder(pts, c)
    with pytest.raises(NotImplementedError, match=r"F9 \(a\)"):
        TFT.extract_trunk_params(model.decoder, with_img=False)
    gen = Generator3D(model)
    c = {"grid": torch.as_tensor(field["grid"], dtype=torch.float32)}
    with pytest.raises(NotImplementedError, match=r"F9 \(a\)"):
        gen.eval_points(model, p[0].astype(np.float32), c)
    out = gen.eval_points(model, p[0].astype(np.float32), c, fast=False,
                          transfer_dtype=torch.float32)
    np.testing.assert_allclose(out, np.asarray(want[0])[0], atol=1e-5)


# ---------------------------------------------------------------------------
# the host modules

def test_npz_cache_lru(tmp_path, monkeypatch):
    """Within VTACO_NPZ_CACHE_MB the least recently used file goes first;
    cached arrays are read-only and equal to the JAX package's load; one
    entry per file under concurrent loads; 0 turns the cache off."""
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f{i}.npz"))
        np.savez(paths[-1], a=np.full(100_000, i, np.float32), b=np.arange(3))
    monkeypatch.setenv("VTACO_NPZ_CACHE_MB", "1")
    npz_cache.clear()
    d0 = npz_cache.load_npz(paths[0])
    assert npz_cache.load_npz(paths[0]) is d0 and not d0["a"].flags.writeable
    with pytest.raises(ValueError):
        d0["a"][0] = 1.0
    for k, v in jax_load_npz(paths[0]).items():
        np.testing.assert_array_equal(d0[k], v)
    npz_cache.load_npz(paths[1])
    npz_cache.load_npz(paths[0])                 # 0 is now the most recent
    npz_cache.load_npz(paths[2])                 # over 1 MB: 1 goes
    assert list(npz_cache._CACHE) == [paths[0], paths[2]]
    assert npz_cache._SIZE == 2 * (400_000 + 3 * 8) <= 1 << 20
    npz_cache.clear()
    got = []
    threads = [threading.Thread(target=lambda: got.append(npz_cache.load_npz(paths[1])))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(npz_cache._CACHE) == 1 and npz_cache._SIZE == 400_024
    assert len(got) == 8 and all(g is npz_cache._CACHE[paths[1]] for g in got)
    monkeypatch.setenv("VTACO_NPZ_CACHE_MB", "0")
    npz_cache.clear()
    d = npz_cache.load_npz(paths[1])
    assert d["a"].flags.writeable and not npz_cache._CACHE
    assert npz_cache.load_npz(paths[1]) is not d


def test_registry_builds_a_registered_decoder():
    """The registries hold the JAX package's names, and a decoder
    registered by name is what get_model builds for that name."""
    assert set(registry.encoder_dict) == set(jax_encoders)
    assert set(registry.decoder_dict) == set(jax_decoders)

    @registry.register_decoder("test_plain_local")
    class Plain(TD.LocalDecoder):
        pass

    try:
        cfg = copy.deepcopy(port_cfg())
        cfg["model"]["decoder"] = "test_plain_local"
        model = get_model(cfg, device="cpu")
        assert type(model.decoder) is Plain
    finally:
        del registry.decoder_dict["test_plain_local"]
