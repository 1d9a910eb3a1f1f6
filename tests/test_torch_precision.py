"""generation.matmul_precision and generation.use_pallas in the port's
Generator3D, on the CPU.

Forward hooks on the object encoder, the ResNet-18 tactile encoder, the
tactile-to-depth stack, the hand encoder and the tactile depth U-Net, and
spies on the trunk wrappers (K1-K4, K2 batched), record cuBLAS's and
cuDNN's TF32 flags at every call: inside every generator entry point they
are what ``matmul_precision`` names (off for 'highest', on for 'default'),
whatever the process's own are, and the process's own are back after.
The flags change nothing on the CPU; on the card they decide TF32.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from vtaco_tpu.generate.generator import Generator3D as JGen
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model
from vtaco_tpu_torch.core.precision import TF32
from vtaco_tpu_torch.data import synthetic
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.generate import generator as G
from vtaco_tpu_torch.generate.inferencer import Inferencer

from test_trainer import _small_cfg

KERNELS = ("fused_trunk_cn", "fused_trunk_gated_cn", "fused_trunk_cn_batched",
           "fused_trunk_window_cn")
MODULES = {"vtaco": ("encoder", "encoder_img", "encoder_t2d.encoder_img", "encoder_hand"),
           "tactile": ("encoder_img",)}


def flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root, mesh_root = synthetic.generate(str(tmp_path_factory.mktemp("synth")), n_models=4,
                                         n_query=300, n_surface=500, img_h=16, img_w=12,
                                         seed=3)
    out = {}
    for name, path in (("vtaco", "configs/VTacO/VTacO_YCB.yaml"),
                       ("tactile", "configs/tactile/tactile_test.yaml")):
        cfg = _small_cfg(path, root, mesh_root)
        cfg["generation"]["resolution_0"] = 4
        cfg["generation"]["upsampling_steps"] = 1
        # the predicted-depth gates, so that the t2d stack runs in _build_gates
        cfg["training"]["legacy_gt_depth"] = False
        torch.manual_seed(0)
        model = get_model(cfg, device="cpu").eval()
        np.random.seed(0)
        batch = next(iter(BatchLoader(get_dataset("test", cfg, return_idx=True), 1,
                                      shuffle=False, num_workers=1)))
        out[name] = (cfg, model, batch)
    return out


@pytest.fixture
def recorded(setup, monkeypatch):
    """{(model, module or kernel): [(matmul flag, cuDNN flag) per call]}."""
    seen = {}
    handles = []
    for name, mods in MODULES.items():
        model = setup[name][1]
        for mod in mods:
            def hook(_m, _i, _o, key=(name, mod)):
                seen.setdefault(key, []).append(flags())
            handles.append(model.get_submodule(mod).register_forward_hook(hook))
    for k in KERNELS:
        orig = getattr(G, k)

        def spy(*a, _orig=orig, _k=k, **kw):
            seen.setdefault(("kernel", _k), []).append(flags())
            return _orig(*a, **kw)
        monkeypatch.setattr(G, k, spy)
    yield seen
    for h in handles:
        h.remove()


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_every_generator_forward_runs_at_matmul_precision(setup, recorded, precision,
                                                          tmp_path):
    want = TF32[precision]
    own = (not want, not want)          # the process's flags: the other way
    old = flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not want
    try:
        cfg, model, batch = setup["vtaco"]
        cfg = copy.deepcopy(cfg)
        cfg["generation"]["matmul_precision"] = precision
        gen = get_generator(model, cfg)
        assert gen.matmul_precision == precision
        with torch.no_grad():
            c = model.encode_inputs(torch.as_tensor(np.asarray(batch["inputs"])))
        c2 = {k: torch.cat([v, v]) for k, v in c.items()}
        pts = np.random.default_rng(0).uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
        calls = {
            "generate_obj_mesh_wnf": lambda: gen.generate_obj_mesh_wnf(model, batch),
            "generate_obj_mesh_mise": lambda: gen.generate_obj_mesh_mise(model, batch),
            "generate_hand_mesh": lambda: gen.generate_hand_mesh(model, batch),
            "eval_points": lambda: gen.eval_points(model, pts, c),
            "decode_dense_batched": lambda: gen.decode_dense_batched(model, 8, c2),
            "decode_points_batched": lambda: gen.decode_points_batched(
                model, np.stack([pts[:500], pts[500:1000]]), c2),
            "run_batched": lambda: Inferencer(model, gen).run_batched(
                model, BatchLoader(get_dataset("test", cfg, return_idx=True), 1,
                                   shuffle=False, num_workers=1),
                batch_size=2, out_dir=str(tmp_path)),
        }
        tcfg, tmodel, tbatch = setup["tactile"]
        tcfg = copy.deepcopy(tcfg)
        tcfg["generation"]["matmul_precision"] = precision
        tgen = get_generator(tmodel, tcfg)
        calls["generate_tactile_pc"] = lambda: tgen.generate_tactile_pc(tmodel, tbatch)
        for name, call in calls.items():
            recorded.clear()
            call()
            assert recorded, name
            for key, got in recorded.items():
                assert set(got) == {(want, want)}, (name, key, got)
            assert flags() == own, name
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_each_module_and_kernel_is_reached(setup, recorded):
    """Such calls reach every hooked module and the trunk kernels of the
    contact-gated mesh (K1), the batched decodes (K2 batched) and the
    window route (K3)."""
    cfg, model, batch = setup["vtaco"]
    gen = get_generator(model, cfg)
    c = gen._encode_sample(model, batch, 0, gates=False)[0]
    gen.generate_obj_mesh_wnf(model, batch)
    gen.generate_hand_mesh(model, batch)
    gen.decode_dense_batched(model, 8, {k: torch.cat([v, v]) for k, v in c.items()})
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    gen.eval_points(model, pts, c)
    tcfg, tmodel, tbatch = setup["tactile"]
    get_generator(tmodel, tcfg).generate_tactile_pc(tmodel, tbatch)
    seen = set(recorded)
    want = {("vtaco", m) for m in MODULES["vtaco"]} | {("tactile", "encoder_img")}
    want |= {("kernel", k) for k in ("fused_trunk_gated_cn", "fused_trunk_cn_batched",
                                     "fused_trunk_window_cn")}
    assert want <= seen, want - seen


def test_from_config_reads_matmul_precision(setup):
    cfg, model, _ = setup["vtaco"]
    cfg = copy.deepcopy(cfg)
    cfg["generation"].pop("matmul_precision", None)
    assert get_generator(model, cfg).matmul_precision == "highest"
    assert JGen.from_config(None, cfg).matmul_precision == "highest"
    for name in ("default", "high", "float32"):
        cfg["generation"]["matmul_precision"] = name
        assert get_generator(model, cfg).matmul_precision == name


@pytest.mark.parametrize("name", ["default", "high", "highest", "float32", "bfloat16",
                                  "tensorfloat32", "fastest", "bfloat16_3x", "bf16",
                                  "HIGHEST"])
def test_matmul_precision_names_as_jax(name):
    """The port takes exactly the names jax.default_matmul_precision takes."""
    try:
        with jax.default_matmul_precision(name):
            pass
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        assert G.Generator3D(None, matmul_precision=name).matmul_precision == name
    else:
        with pytest.raises(ValueError, match="matmul_precision"):
            G.Generator3D(None, matmul_precision=name)


@pytest.mark.parametrize("value", ["auto", True, False, "true", "no", 2, None])
def test_use_pallas_validated_as_jax(value):
    try:
        JGen(None, use_pallas=value)
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        assert G.Generator3D(None, use_pallas=value).use_kernels == (value is not False)
    else:
        with pytest.raises(ValueError, match="use_pallas"):
            G.Generator3D(None, use_pallas=value)


def test_use_pallas_false_takes_the_plain_trunk(setup, monkeypatch):
    """use_pallas false: no kernel wrapper is called on the mesh, gather,
    window and batched routes, and the logits equal the kernels' route
    (on the CPU the wrappers compute the plain version too)."""
    cfg, model, batch = setup["vtaco"]
    auto = get_generator(model, cfg)
    plain = get_generator(model, cfg, use_pallas=False)
    c = auto._encode_sample(model, batch, 0, gates=False)[0]
    c2 = {k: torch.cat([v, v]) for k, v in c.items()}
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    np.random.seed(0)
    (av, af), aemd, acd = auto.generate_obj_mesh_wnf(model, batch)
    want = [auto.eval_points(model, pts, c, transfer_dtype=torch.float32),
            auto.decode_dense_batched(model, 8, c2, transfer_dtype=torch.float32)]

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called under use_pallas false")
    for k in KERNELS:
        monkeypatch.setattr(G, k, refuse)
    np.random.seed(0)
    (pv, pf), pemd, pcd = plain.generate_obj_mesh_wnf(model, batch)
    got = [plain.eval_points(model, pts, c, transfer_dtype=torch.float32),
           plain.decode_dense_batched(model, 8, c2, transfer_dtype=torch.float32)]
    np.testing.assert_array_equal(pv, av)
    np.testing.assert_array_equal(pf, af)
    assert (pemd, pcd) == (aemd, acd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        auto.eval_points(model, pts, c)
