"""The CUDA trunk kernels (K1, K2 and K2 over an object axis in
csrc/trunk.cu; K3, K4 in csrc/window.cu; all on the tile chain of
csrc/tile_chain.cuh) against their plain PyTorch versions on the card,
and the training path on the card: one VTacO_YCB train step and one
tactile depth-stack step against the same steps on the CPU, a bfloat16
step against the card's float32 one, a fused block of steps with no host
sync, a mesh reconstructed through K1 from the checkpoint that
train.loop.train writes, and the generation CLI on the card
reconstructing a split through K1 (all at small widths on the port's
synthetic set).

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a GPU every test here skips (the kernels have no CPU mode). The
tolerance is 1e-4 on logits of order 1: the kernels compute each product
in 3xTF32 on the tensor cores (about 2^-22 relative per product) and sum
in their own order where cuBLAS picks another. Contact gating
compares an expanded squared distance with r²; points within 1e-6 of r²
for some valid contact may round to the other side and are left out.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model, load_config
from vtaco_tpu_torch.data import synthetic
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.models.decoder import LocalDecoder
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops.cuda import decode as K
from vtaco_tpu_torch.ops.dense_decode import dense_query_grid_cn, supercell_keys
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.trainer import Trainer

from voxel_files import write_voxels

ATOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_decoder(device, width=32, n_blocks=5, seed=0):
    """A LocalDecoder with every weight random (fc_1 included, which the
    module zero-initializes)."""
    g = torch.Generator().manual_seed(seed)
    dec = LocalDecoder(c_dim=width, hidden_size=width, n_blocks=n_blocks)
    with torch.no_grad():
        for p in dec.parameters():
            fan_in = p.shape[-1] if p.dim() > 1 else width
            p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return dec.to(device)


def _inputs(device, N, seed=1, width=32):
    g = torch.Generator().manual_seed(seed)
    p = (torch.rand((3, N), generator=g) * 1.1 - 0.55).to(device)
    f = torch.randn((width, N), generator=g).to(device)
    return p, f


def _contacts(device, case, K_=128, seed=2):
    g = torch.Generator().manual_seed(seed)
    if case in ("clustered", "patch"):     # a tight cluster, a fingertip's patch
        q = 0.25 + (0.02 if case == "clustered" else 0.05) * torch.randn(
            (5, K_, 3), generator=g)
    else:
        q = torch.rand((5, K_, 3), generator=g) * 0.8 - 0.4
    valid = torch.rand((5, K_), generator=g) > 0.3
    if case == "all_invalid":
        valid[:] = False
    feat = torch.randn((5, 32), generator=g)
    return q.to(device), feat.to(device), valid.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [100_000, 100_003, 77])
@pytest.mark.parametrize("variant", ["coords", "c_img", "bf16"])
def test_fused_trunk_cn(cuda, N, variant):
    dec = random_decoder(cuda)
    p, f = _inputs(cuda, N)
    tp = FT.extract_trunk_params(dec, with_img=variant == "c_img")
    ci = torch.randn((32, N), device=cuda) if variant == "c_img" else None
    store = torch.bfloat16 if variant == "bf16" else None
    with torch.no_grad():
        before = K.fused_trunk_cn.launches
        got = K.fused_trunk_cn(tp, p, f, ci, store_dtype=store)
        assert K.fused_trunk_cn.launches == before + 1
        want = FT.trunk_cn(tp, K._stored(p, store), K._stored(f, store),
                           None if ci is None else K._stored(ci, store))
        torch.cuda.synchronize()
    assert got.shape == (N,) and got.dtype == torch.float32
    assert float(torch.max(torch.abs(got - want))) < ATOL


def _batched_plain(tp, p, f, store):
    """K2 batched's plain version: trunk_cn per object."""
    return torch.stack([FT.trunk_cn(tp, K._stored(p if p.dim() == 2 else p[b], store),
                                    K._stored(f[b], store)) for b in range(len(f))])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [100_003, 77])
@pytest.mark.parametrize("coords", ["shared", "per_object"])
@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_fused_trunk_cn_batched(cuda, N, coords, store):
    """K2 over B = 3 objects in one launch against trunk_cn per object: an
    odd N and one below a tile per object, coordinates shared by every
    object (the dense grid) or each object's own."""
    B = 3
    tp = FT.extract_trunk_params(random_decoder(cuda), with_img=False)
    g = torch.Generator().manual_seed(4)
    f = torch.randn((B, 32, N), generator=g).to(cuda)
    shape = (3, N) if coords == "shared" else (B, 3, N)
    p = (torch.rand(shape, generator=g) * 1.1 - 0.55).to(cuda)
    with torch.no_grad():
        before = K.fused_trunk_cn_batched.launches
        got = K.fused_trunk_cn_batched(tp, p, f, store_dtype=store)
        assert K.fused_trunk_cn_batched.launches == before + 1
        want = _batched_plain(tp, p, f, store)
        torch.cuda.synchronize()
    assert got.shape == (B, N) and got.dtype == torch.float32
    assert float(torch.max(torch.abs(got - want))) < ATOL


@pytest.mark.cuda
def test_fused_trunk_cn_batched_inference_tensors(cuda):
    """Weights and inputs made under torch.inference_mode (as the batched
    decodes make them) go through batched K2 like any others."""
    with torch.inference_mode():
        tp = FT.extract_trunk_params(random_decoder(cuda), with_img=False)
        p, _ = _inputs(cuda, 5000)
        f = torch.randn((4, 32, 5000), device=cuda)
        got = K.fused_trunk_cn_batched(tp, p, f)
        want = _batched_plain(tp, p, f, None)
        torch.cuda.synchronize()
    assert float(torch.max(torch.abs(got - want))) < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["invalid_rows", "clustered", "all_invalid"])
@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_fused_trunk_gated_cn(cuda, case, store):
    N, radius = 100_003, 0.05
    dec = random_decoder(cuda)
    p, f = _inputs(cuda, N)
    q, feat, valid = _contacts(cuda, case)
    tp = FT.extract_trunk_params(dec, with_img=True)
    with torch.no_grad():
        before = K.fused_trunk_gated_cn.launches
        got = K.fused_trunk_gated_cn(tp, p, f, q, feat, valid, radius=radius,
                                     store_dtype=store)
        assert K.fused_trunk_gated_cn.launches == before + 1
        ps = K._stored(p, store)
        c_img = FT.gate_contact_cn(ps, q, feat, valid, radius)
        want = FT.trunk_cn(tp, ps, K._stored(f, store), c_img)
        d2 = FT.contact_sq_dist(ps, q, valid)
        near = torch.any(torch.abs(d2 - radius * radius) < 1e-6, dim=0)
        torch.cuda.synchronize()
    gated = int(torch.any(c_img != 0, dim=0).sum())
    if case != "all_invalid":
        assert gated > 100
    # the shell |d2 - r^2| < 1e-6 is 2e-6 / (2 r) thick: 0.12 % of a lone
    # contact ball at r = 0.05, more where balls overlap; at most 5 % leaves
    # 95 % of the gated points in the comparison
    assert int(near.sum()) * 20 <= gated
    assert float(torch.max(torch.abs(got - want)[~near])) < ATOL


def _lattice(device, planes=16, z=0.25, nx=128):
    """The `planes` z-planes nearest z of the mesh path's nx³ query lattice
    (dense_query_grid_cn: x fastest, z slowest), so that each tile of 128
    points is one x-row."""
    g = dense_query_grid_cn(nx, 1.1, device=device)
    i0 = int(torch.argmin(torch.abs(g[2, ::nx * nx] - z))) - planes // 2
    return g[:, i0 * nx * nx:(i0 + planes) * nx * nx].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case,gated", [
    ("lattice", False), ("small_N", False), ("inference", False),
    ("lattice", True), ("small_N", True), ("many_contacts", True),
    ("inference", True)])
def test_fused_trunk_cases(cuda, case, gated):
    """K2 and K1 on the mesh path's lattice order (K1 with a patch of
    contacts: most tiles keep none; the tight cluster would put 6 % of the
    gated lattice points in the near shell), on fewer points than one tile, with
    4,096 contacts per finger (K1 reads them from global memory, so any
    count fits), and with weights and gates made under
    torch.inference_mode, as eval_points makes them."""
    radius = 0.05
    N = {"small_N": 77, "many_contacts": 20_000}.get(case, 100_003)
    p, f = _inputs(cuda, N)
    if case == "lattice":
        p = _lattice(cuda)
        N = p.shape[1]
        f = torch.randn((32, N), device=cuda)
    with torch.inference_mode(case == "inference"):
        tp = FT.extract_trunk_params(random_decoder(cuda), with_img=gated)
        q, feat, valid = _contacts(cuda, "patch" if case == "lattice" else
                                   "invalid_rows",
                                   K_=4096 if case == "many_contacts" else 128)
    fn = K.fused_trunk_gated_cn if gated else K.fused_trunk_cn
    keep = torch.ones(N, dtype=torch.bool, device=cuda)
    with torch.no_grad():
        before = fn.launches
        got = fn(tp, p, f, q, feat, valid, radius=radius) if gated else fn(tp, p, f)
        assert fn.launches == before + 1
        c_img = FT.gate_contact_cn(p, q, feat, valid, radius) if gated else None
        want = FT.trunk_cn(tp, p, f, c_img)
        if gated:
            d2 = FT.contact_sq_dist(p, q, valid)
            keep = ~torch.any(torch.abs(d2 - radius * radius) < 1e-6, dim=0)
        torch.cuda.synchronize()
    if gated and N > 1000:
        n_gated = int(torch.any(c_img != 0, dim=0).sum())
        assert n_gated > 100
        assert int((~keep).sum()) * 20 <= n_gated
    assert got.shape == (N,) and got.dtype == torch.float32
    assert float(torch.max(torch.abs(got - want)[keep])) < ATOL


@pytest.mark.cuda
def test_wrapper_rejects_other_widths(cuda):
    dec = random_decoder(cuda, width=16)
    p, f = _inputs(cuda, 1000, width=16)
    with pytest.raises(NotImplementedError):
        K.fused_trunk_cn(FT.extract_trunk_params(dec, with_img=False), p, f)


def _window_inputs(device, N, L, R=64, seed=3):
    """A random (R, R, R, 32) grid and N points in [-0.62, 0.62]³ (border
    outliers included), sorted by their super-cell keys at L."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn((R, R, R, 32), generator=g).to(device)
    p = (torch.rand((3, N), generator=g) * 1.24 - 0.62).to(device)
    order = torch.sort(supercell_keys(p, R, 0.1, L), stable=True)[1]
    return grid, p[:, order].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["coords", "c_img", "invalid_rows",
                                     "clustered", "all_invalid", "box_edge"])
@pytest.mark.parametrize("L,S", [(1, 128), (2, 128), (1, 8)])
def test_fused_trunk_window_cn(cuda, variant, L, S):
    """K3 (coords, c_img rows) and K4 (gated) against window_trunk_plain:
    logits, the overflow count (positive for the undersized S = 8; these
    100,003 points are sparse enough to overflow S = 128 too), and the
    kernel's keys against the torch keys on the card."""
    grid, p = _window_inputs(cuda, 100_003, L)
    _check_window(cuda, variant, grid, p, L, S)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["coords", "c_img", "invalid_rows",
                                     "clustered", "box_edge"])
@pytest.mark.parametrize("case", ["unsorted", "small_N"])
def test_fused_trunk_window_cn_any_order_and_size(cuda, variant, case):
    """The window kernels are right on points in any order (each tile then
    spans the box and keeps every contact) and on fewer points than one
    tile."""
    grid, p = _window_inputs(cuda, 100_003, 1)
    if case == "unsorted":
        p = p[:, torch.randperm(p.shape[1], device=cuda)].contiguous()
    else:
        p = p[:, :77].contiguous()
    _check_window(cuda, variant, grid, p, 1, 128)


def _check_window(cuda, variant, grid, p, L, S):
    N, R, radius = p.shape[1], 64, 0.05
    dec = random_decoder(cuda)
    gated = variant not in ("coords", "c_img")
    tp = FT.extract_trunk_params(dec, with_img=variant != "coords")
    kw = dict(reso=R, padding=0.1, L=L, S=S, tile=256)
    if variant == "c_img":
        kw["c_img_cn"] = torch.randn((32, N), device=cuda)
    if gated:
        q, feat, valid = _contacts(cuda, "invalid_rows" if variant == "box_edge"
                                   else variant)
        if variant == "box_edge":
            q = K.window_box_edge_contacts(p, 4, radius=radius)
            valid = torch.ones_like(valid)
        kw.update(gate_pts=q, gate_feat=feat, gate_valid=valid, radius=radius)
    keys = torch.empty(N, dtype=torch.int32, device=cuda)
    counter = "launches_gated" if gated else "launches"
    with torch.no_grad():
        before = getattr(K.fused_trunk_window_cn, counter)
        got, n_over = K.fused_trunk_window_cn(tp, grid, p, keys_out=keys, **kw)
        assert getattr(K.fused_trunk_window_cn, counter) == before + 1
        want, want_over = K.window_trunk_plain(tp, grid, p, **kw)
        torch.cuda.synchronize()
    assert torch.equal(keys, supercell_keys(p, R, 0.1, L))
    assert int(n_over) == int(want_over)
    assert int(n_over) > 0 or S != 8 or N < 1000
    assert got.shape == (N,) and got.dtype == torch.float32
    keep = torch.ones(N, dtype=torch.bool, device=cuda)
    if gated:
        d2 = FT.contact_sq_dist(p, q, valid)
        keep = ~torch.any(torch.abs(d2 - radius * radius) < 1e-6, dim=0)
    assert int((~keep).sum()) * 100 <= max(N, 100)
    assert float(torch.max(torch.abs(got - want)[keep])) < ATOL


def _tip_gates(p, seed=9):
    """Five fingertips among the points (a point plus up to 0.03 per
    axis), finger 2 not touching, and their (5, 32) features."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, p.shape[1], (5,), generator=g)
    tips = p[:, idx.to(p.device)].T + (torch.rand((5, 3), generator=g) * 0.06
                                      - 0.03).to(p.device)
    feat = torch.randn((5, 32), generator=g).to(p.device)
    valid = torch.tensor([True, True, False, True, True], device=p.device)
    return tips.contiguous(), feat, valid


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "lattice"])
def test_fused_trunk_cn_tip_rows(cuda, order):
    """K2 in its c_img mode on the rows of fingertip gating (gate_tips_cn,
    as VTacOH's mesh and gather route make them) against trunk_cn on the
    same rows; and the card's rows equal the CPU's outside the 1e-6 shell
    around r² = 0.0025 and around ties between two tips."""
    if order == "random":
        p, f = _inputs(cuda, 100_003)
    else:
        p = dense_query_grid_cn(64, 1.1, device=cuda)
        f = torch.randn((32, p.shape[1]), device=cuda)
    tips, feat, valid = _tip_gates(p)
    dec = random_decoder(cuda)
    tp = FT.extract_trunk_params(dec, with_img=True)
    with torch.no_grad():
        rows = FT.gate_tips_cn(p, tips, feat, valid)
        before = K.fused_trunk_cn.launches, K.fused_trunk_cn.launches_cimg
        got = K.fused_trunk_cn(tp, p, f, rows)
        assert (K.fused_trunk_cn.launches, K.fused_trunk_cn.launches_cimg) == (
            before[0] + 1, before[1] + 1)
        want = FT.trunk_cn(tp, p, f, rows)
        cpu_rows = FT.gate_tips_cn(p.cpu(), tips.cpu(), feat.cpu(), valid.cpu())
    gated = rows.abs().sum(0) > 0
    assert int(gated.sum()) > 20
    assert float(torch.max(torch.abs(got - want))) < ATOL
    d2 = ((p.double().T[:, None] - tips.double()[None]) ** 2).sum(-1)    # (N, 5)
    two = torch.sort(d2, dim=1).values[:, :2]
    keep = ~(torch.any(torch.abs(d2 - 0.0025) < 1e-6, dim=1)
             | (two[:, 1] - two[:, 0] < 1e-6))
    assert torch.equal(rows.cpu()[:, keep.cpu()], cpu_rows[:, keep.cpu()])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2])
def test_fused_trunk_window_cn_tip_rows(cuda, L):
    """K3 in its c_img mode on the fingertip rows of points sorted by
    super-cell (VTacOH's window route) against window_trunk_plain with the
    same rows."""
    grid, p = _window_inputs(cuda, 100_003, L)
    tips, feat, valid = _tip_gates(p)
    dec = random_decoder(cuda)
    tp = FT.extract_trunk_params(dec, with_img=True)
    kw = dict(reso=64, padding=0.1, L=L, S=128, tile=256)
    with torch.no_grad():
        rows = FT.gate_tips_cn(p, tips, feat, valid)
        before = (K.fused_trunk_window_cn.launches,
                  K.fused_trunk_window_cn.launches_cimg)
        got, n_over = K.fused_trunk_window_cn(tp, grid, p, c_img_cn=rows, **kw)
        assert (K.fused_trunk_window_cn.launches,
                K.fused_trunk_window_cn.launches_cimg) == (before[0] + 1, before[1] + 1)
        want, want_over = K.window_trunk_plain(tp, grid, p, c_img_cn=rows, **kw)
    assert int((rows.abs().sum(0) > 0).sum()) > 20
    assert int(n_over) == int(want_over)
    assert float(torch.max(torch.abs(got - want))) < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["coords", "invalid_rows"])
def test_fused_trunk_window_cn_inference_tensors(cuda, variant):
    """Weights and contacts made under torch.inference_mode (as
    eval_points makes them) go through K3/K4 like any others."""
    grid, p = _window_inputs(cuda, 100_003, 1)
    with torch.inference_mode():
        dec = random_decoder(cuda)
        gated = variant != "coords"
        tp = FT.extract_trunk_params(dec, with_img=gated)
        kw = dict(reso=64, padding=0.1, L=1, S=128, tile=256, radius=0.05)
        if gated:
            q, feat, valid = _contacts(cuda, variant)
            kw.update(gate_pts=q, gate_feat=feat, gate_valid=valid)
        got, n_over = K.fused_trunk_window_cn(tp, grid, p, **kw)
        want, want_over = K.window_trunk_plain(tp, grid, p, **kw)
        keep = torch.ones(p.shape[1], dtype=torch.bool, device=cuda)
        if gated:
            d2 = FT.contact_sq_dist(p, q, valid)
            keep = ~torch.any(torch.abs(d2 - 0.05 ** 2) < 1e-6, dim=0)
        torch.cuda.synchronize()
    assert int(n_over) == int(want_over)
    assert float(torch.max(torch.abs(got - want)[keep])) < ATOL


@pytest.mark.cuda
def test_fused_trunk_window_cn_many_contacts(cuda):
    """K4 takes any number of contacts per finger: its shared memory does
    not grow with them (here 2,048 per finger, ten thousand rows)."""
    grid, p = _window_inputs(cuda, 20_000, 1)
    q, feat, valid = _contacts(cuda, "invalid_rows", K_=2048)
    radius = 0.02
    dec = random_decoder(cuda)
    tp = FT.extract_trunk_params(dec, with_img=True)
    kw = dict(reso=64, padding=0.1, L=1, S=128, tile=256, gate_pts=q,
              gate_feat=feat, gate_valid=valid, radius=radius)
    with torch.no_grad():
        got, _ = K.fused_trunk_window_cn(tp, grid, p, **kw)
        want, _ = K.window_trunk_plain(tp, grid, p, **kw)
        d2 = FT.contact_sq_dist(p, q, valid)
        near = torch.any(torch.abs(d2 - radius * radius) < 1e-6, dim=0)
        gated = int(torch.any(d2 < radius * radius, dim=0).sum())
        torch.cuda.synchronize()
    assert gated > 1000
    assert int(near.sum()) * 20 <= gated
    assert float(torch.max(torch.abs(got - want)[~near])) < ATOL


@pytest.fixture(scope="module")
def train_cfg(tmp_path_factory):
    """VTacO_YCB at small widths on the port's synthetic set (32x24
    images), three models in the train split, trained in full float32."""
    out = tmp_path_factory.mktemp("train")
    root, mesh = synthetic.generate(str(out / "data"), n_models=4, n_query=4000,
                                    n_surface=2000, img_h=32, img_w=24, seed=3,
                                    splits=(("train", 0.75), ("val", 0.25), ("test", 0.25)))
    cfg = load_config("configs/VTacO/VTacO_YCB.yaml", "configs/default.yaml")
    cfg["data"].update(path=root, points_subsample=2048, pointcloud_n=512, num_sample=512,
                       mesh_dir=os.path.join(mesh, "mesh_obj"),
                       depth_origin=os.path.join(mesh, "depth_origin.txt"))
    m = cfg["model"]
    m["encoder_kwargs"].update(hidden_dim=16, grid_resolution=16)
    m["encoder_kwargs"]["unet3d_kwargs"].update(num_levels=2, f_maps=16)
    for kw in (m["encoder_hand_kwargs"], m["encoder_t2d_kwargs"]["encoder_hand_kwargs"]):
        kw.update(hidden_dim=16, plane_resolution=16)
        kw["unet_kwargs"].update(depth=2, start_filts=16)
    m["encoder_t2d_kwargs"]["encoder_img_kwargs"].update(depth=2, start_filts=16)
    cfg["training"].update(out_dir=str(out / "run"), n_workers=1, n_workers_val=1,
                           print_every=1, validate_every=2, checkpoint_every=2,
                           backup_every=-1, matmul_precision="highest")
    cfg["generation"].update(resolution_0=16, mc_level="mean")
    return cfg


@pytest.mark.cuda
def _step_card_vs_cpu(cuda, cfg, batch_size):
    """One train step from the same weights and batch on the CPU and on the
    card: (scalars on the CPU, on the card, {module: (gradient cosine, norm
    ratio)})."""
    torch.manual_seed(0)
    cpu_model = get_model(cfg, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    cpu = Trainer.from_config(cpu_model, cfg)
    card = Trainer.from_config(card_model, cfg)
    batch = next(iter(BatchLoader(get_dataset("train", cfg), batch_size, num_workers=1,
                                  seed=0)))
    want, got = cpu.train_step(batch), card.train_step(batch)
    card_params = dict(card_model.named_parameters())
    grads = {}
    for mod in dict(cpu_model.named_children()):
        named = [(n, p) for n, p in cpu_model.named_parameters()
                 if n.split(".")[0] == mod and p.grad is not None]
        if named:
            g = torch.cat([card_params[n].grad.flatten().double().cpu() for n, _ in named])
            w = torch.cat([p.grad.flatten().double() for _, p in named])
            grads[mod] = (float(g @ w / (g.norm() * w.norm())), float(g.norm() / w.norm()))
    return want, got, grads


@pytest.mark.cuda
def test_tactile_step_card_matches_cpu(cuda, train_cfg):
    """One step of the tactile depth stack (configs/tactile/tactile_test.yaml
    at small widths, full float32) from the same weights and batch: loss
    scalars within 1e-4 relative, each module's gradient cosine >= 0.999
    with norms within 2 %."""
    cfg = load_config("configs/tactile/tactile_test.yaml", "configs/default.yaml")
    cfg["data"].update({k: train_cfg["data"][k] for k in (
        "path", "points_subsample", "pointcloud_n", "mesh_dir", "depth_origin")})
    m = cfg["model"]
    m["encoder_hand_kwargs"].update(hidden_dim=16, plane_resolution=16)
    m["encoder_hand_kwargs"]["unet_kwargs"].update(depth=2, start_filts=16)
    m["encoder_img_kwargs"].update(depth=2, start_filts=16)
    cfg["training"]["matmul_precision"] = "highest"
    want, got, grads = _step_card_vs_cpu(cuda, cfg, 3)
    assert set(want) == {"loss", "loss_depth", "loss_digit"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert set(grads) == {"encoder_hand", "encoder_img"}
    for mod, (cos, ratio) in grads.items():
        assert cos >= 0.999 and 0.98 < ratio < 1.02, (mod, cos, ratio)


@pytest.mark.cuda
def test_generate_cli_on_card(cuda, train_cfg, tmp_path, capsys):
    """cli.generate on the card from a checkpoint of train.loop.train: the
    JSON line, an object and a hand mesh per sample, and K1's launch
    counter rising by at least one per object."""
    from vtaco_tpu_torch.cli.generate import main

    import yaml

    cfg = copy.deepcopy(train_cfg)
    cfg["training"]["out_dir"] = str(tmp_path / "run")
    loop.train(cfg, max_iters=1, device="cuda")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    capsys.readouterr()
    K.fused_trunk_gated_cn.launches = 0
    main([str(path), "--split", "val", "--checkpoint", "model.ckpt",
          "--out-dir", str(tmp_path / "gen")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["split"] == "val" and line["n"] >= 1 and np.isfinite(line["cd_mean"])
    assert K.fused_trunk_gated_cn.launches >= line["n"]
    assert len(os.listdir(tmp_path / "gen")) == 2 * line["n"]


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda, train_cfg):
    """One t2d_img step from the same weights, batch and contact draws:
    loss scalars within 1e-4 relative, each module's gradient cosine >=
    0.999 with norms within 2 %, BatchNorm statistics within 1e-5
    relative (the t2d U-Net's 1e-4: on images in [0, 1/255] the one-pass
    batch variance cancels, see tests/test_torch_train.py)."""
    torch.manual_seed(0)
    cpu_model = get_model(train_cfg, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    bank = loop.build_mesh_bank(train_cfg, "cpu")
    cpu = Trainer.from_config(cpu_model, train_cfg, mesh_bank=bank)
    card = Trainer.from_config(card_model, train_cfg,
                               mesh_bank=loop.build_mesh_bank(train_cfg, cuda))
    batch = next(iter(BatchLoader(get_dataset("train", train_cfg), 3, num_workers=1,
                                  seed=0)))
    a = cpu.prepare_batch(batch)
    H, W = a["imgs"].shape[2:4]
    draws = C.contact_draws(a["depths"], a["touch_success"], cpu._depth_origin_for(H * W),
                            a["points"].shape[1], cpu.num_sample, cpu.contact_per_finger,
                            torch.Generator().manual_seed(1))
    assert int(C.contact_mask(a["depths"], a["touch_success"],
                              cpu._depth_origin_for(H * W)).sum()) > 0
    want = cpu.train_step(batch, draws)
    got = card.train_step(batch, {k: v.to(cuda) for k, v in draws.items()})
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    card_params = dict(card_model.named_parameters())
    for mod in dict(cpu_model.named_children()):
        names = [n for n, p in cpu_model.named_parameters()
                 if n.split(".")[0] == mod and p.grad is not None]
        if not names:
            continue
        g = torch.cat([card_params[n].grad.flatten().double().cpu() for n in names])
        w = torch.cat([dict(cpu_model.named_parameters())[n].grad.flatten().double()
                       for n in names])
        assert float(g @ w / (g.norm() * w.norm())) >= 0.999, mod
        assert 0.98 < float(g.norm() / w.norm()) < 1.02, mod
    own = card_model.state_dict()
    for k, v in cpu_model.state_dict().items():
        if "running" in k:
            bar = 1e-4 if k.startswith("encoder_t2d.encoder_img.") else 1e-5
            err = float((own[k].cpu() - v).abs().max() / v.abs().max())
            assert err < bar, (k, err)


@pytest.mark.cuda
def test_train_then_mesh(cuda, train_cfg):
    """train.loop.train on the card writes a checkpoint; a model restored
    from it reconstructs a mesh in contact mode through K1."""
    cfg = copy.deepcopy(train_cfg)
    _, it = loop.train(cfg, max_iters=2, device="cuda")
    assert it == 2
    model = get_model(cfg)
    scalars = CheckpointIO(cfg["training"]["out_dir"], model=model).load("model.ckpt")
    assert scalars["it"] == 2
    model.eval()
    batch = next(iter(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    gen = get_generator(model, cfg)
    K.fused_trunk_gated_cn.launches = 0
    with torch.no_grad():
        (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
    assert K.fused_trunk_gated_cn.launches >= 1
    assert len(faces) > 0 and np.isfinite(verts).all() and np.isfinite(cd)


@pytest.mark.cuda
def test_bf16_step_card_within_bars(cuda, train_cfg):
    """One bfloat16 step (keep_f32_modules: the decoder) against the card's
    float32 'highest' step from the same weights, batch and contact draws,
    held to the step bars for VTacO (tests/bf16_checks.step_bars: twice the
    JAX package's own bfloat16-to-float32 gap on the CPU): the loss
    scalars' relative gaps and each module's relative gradient distance
    (less the exact_zero biases); every parameter, BatchNorm buffer and
    Adam moment float32 after it."""
    from bf16_checks import exact_zero, step_bars

    loss_rtol, grad_rel = step_bars("vtaco")
    torch.manual_seed(0)
    base = get_model(train_cfg, device="cpu").state_dict()
    bank = loop.build_mesh_bank(train_cfg, cuda)
    batch = next(iter(BatchLoader(get_dataset("train", train_cfg), 3, num_workers=1,
                                  seed=0)))
    runs = {}
    for dt in ("bfloat16", None):
        model = get_model(train_cfg, device="cuda")
        model.load_state_dict(base)
        tr = Trainer.from_config(model, train_cfg, mesh_bank=bank, compute_dtype=dt)
        a = tr.prepare_batch(batch)
        H, W = a["imgs"].shape[2:4]
        draws = C.contact_draws(a["depths"], a["touch_success"], tr._depth_origin_for(H * W),
                                a["points"].shape[1], tr.num_sample, tr.contact_per_finger,
                                torch.Generator(device="cuda").manual_seed(1))
        sc = tr.train_step(batch, draws)
        runs[dt] = sc, {n: p.grad.double() for n, p in model.named_parameters()
                        if p.grad is not None}, tr
    (s16, g16, tr16), (s32, g32, _) = runs["bfloat16"], runs[None]
    for k in s32:
        assert abs(s16[k] - s32[k]) <= loss_rtol * abs(s32[k]), (k, s16[k], s32[k])
    assert g16.keys() == g32.keys()
    live = set(g32) - exact_zero(g32)
    for mod in {n.split(".")[0] for n in live}:
        names = [n for n in live if n.split(".")[0] == mod]
        g = torch.cat([g16[n].flatten() for n in names])
        w = torch.cat([g32[n].flatten() for n in names])
        assert float((g - w).norm() / w.norm()) <= grad_rel[mod], mod
    assert all(v.dtype == torch.float32 for v in tr16.model.state_dict().values()
               if v.is_floating_point())
    assert all(v.dtype == torch.float32 for st in tr16.optimizer.state.values()
               for v in st.values() if v.is_floating_point() and v.dim() > 0)


@pytest.mark.cuda
def test_fused_block_has_no_host_sync(cuda, train_cfg):
    """K = 4 fused bfloat16 steps on a device-resident split (VTacO_YCB at
    small widths): after a warm-up block, a block runs under
    utils.syncs.host_syncs and none of its steps may wait for the card
    (the failure lists the file:line of each wait); its scalars stay on
    the card until the one read after it."""
    from vtaco_tpu_torch.data.device_data import DeviceDataset
    from vtaco_tpu_torch.utils.syncs import host_syncs

    cfg = copy.deepcopy(train_cfg)
    cfg["training"]["compute_dtype"] = "bfloat16"
    torch.manual_seed(0)
    tr = Trainer.from_config(get_model(cfg), cfg, mesh_bank=loop.build_mesh_bank(cfg, cuda))
    dds = DeviceDataset(get_dataset("train", cfg), device="cuda")
    fused = tr.make_fused_train_fn(dds, cfg["data"]["points_subsample"],
                                   cfg["data"]["pointcloud_n"])
    ids = np.array([[i % dds.n_models, (i + 1) % dds.n_models] for i in range(4)])
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr.read_scalars(fused(ids, gen))
    torch.cuda.synchronize()
    stacked, syncs = host_syncs(fused, ids, gen)
    assert not syncs, syncs
    out = tr.read_scalars(stacked)
    assert all(v.shape == (4,) and np.isfinite(v).all() for v in out.values())


@pytest.mark.cuda
@pytest.mark.parametrize("gating", ["none", "contact"])
def test_trunk_kernels_on_plane_features(cuda, gating):
    """K2 and K1 on features summed from three planes and a grid (the
    dense decode's dense_feature_volume_cn at nx = 48, and the gather
    route's scattered_feature_volume_cn at 100,003 points) against their
    plain versions."""
    from vtaco_tpu_torch.ops.dense_decode import (dense_feature_volume_cn,
                                                  scattered_feature_volume_cn)

    dec = random_decoder(cuda)
    g = torch.Generator().manual_seed(5)
    fields = {k: torch.randn((1, 24, 24, 32), generator=g).to(cuda)
              for k in ("xz", "xy", "yz")}
    fields["grid"] = torch.randn((1, 12, 12, 12, 32), generator=g).to(cuda)
    tp = FT.extract_trunk_params(dec, with_img=gating == "contact")
    q, feat, valid = _contacts(cuda, "spread")
    nx = 48
    p_dense = dense_query_grid_cn(nx, 1.1, device=cuda)
    p_pts, _ = _inputs(cuda, 100_003)
    with torch.no_grad():
        for p, f in ((p_dense, dense_feature_volume_cn(fields, nx, 1.1, 0.1)),
                     (p_pts, scattered_feature_volume_cn(fields, p_pts, 0.1))):
            keep = None
            if gating == "contact":
                got = K.fused_trunk_gated_cn(tp, p, f, q, feat, valid)
                want = FT.trunk_cn(tp, p, f, FT.gate_contact_cn(p, q, feat, valid))
                d2 = FT.contact_sq_dist(p, q, valid)
                keep = ~torch.any(torch.abs(d2 - 0.015 ** 2) < 1e-6, dim=0)
            else:
                got = K.fused_trunk_cn(tp, p, f)
                want = FT.trunk_cn(tp, p, f)
            torch.cuda.synchronize()
            d = torch.abs(got - want)
            assert float((d if keep is None else d[keep]).max()) < ATOL


@pytest.mark.cuda
def test_crop_eval_points_card_matches_cpu(cuda, tmp_path):
    """configs/crop/scene_crop.yaml at small widths (hidden 8, U-Net depth
    2): eval_points on 50,000 scene points, chunked by 20,000 through the
    crop decoder, on the card against the CPU from the same weights and
    test batch; no kernel launches (the crop decode is the module's)."""
    root, _ = synthetic.generate(str(tmp_path / "data"), n_models=4, n_query=4000,
                                 n_surface=2000, img_h=16, img_w=12, seed=3)
    cfg = load_config("configs/crop/scene_crop.yaml", "configs/default.yaml")
    cfg["data"].update(path=root, points_subsample=512, pointcloud_n=512, query_vol_size=16)
    enc = cfg["model"]["encoder_kwargs"]
    enc["hidden_dim"] = 8
    enc["unet_kwargs"].update(depth=2, start_filts=8)
    enc["unet3d_kwargs"]["num_levels"] = 1
    cfg["generation"]["batch_size"] = 20_000
    ds = get_dataset("test", cfg)
    torch.manual_seed(0)
    cpu_model = get_model(cfg, device="cpu", dataset=ds)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    batch = next(iter(BatchLoader(ds, 1, shuffle=False, num_workers=1)))
    pts = np.random.default_rng(1).uniform(-0.55, 0.55, (50_000, 3)).astype(np.float32)
    out = {}
    before = {k: getattr(K, k).launches for k in ("fused_trunk_cn", "fused_trunk_gated_cn",
                                                  "fused_trunk_window_cn")}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        enc_in = {"points": torch.as_tensor(batch["inputs"], device=dev),
                  "index": {k.split(".")[-1]: torch.as_tensor(v[:, 0], device=dev).long()
                            for k, v in batch.items() if k.startswith("inputs.ind.")}}
        with torch.no_grad():
            c = model.encode_inputs(enc_in)
        out[dev] = get_generator(model, cfg).eval_points(model, pts, c,
                                                         transfer_dtype=torch.float32)
    assert {k: getattr(K, k).launches for k in before} == before
    assert np.isfinite(out["cuda"]).all()
    assert float(np.abs(out["cuda"] - out["cpu"]).max()) < ATOL


# ---------------------------------------------------------------------------
# the other model families (no kernel of their own): modules and steps on
# the card against the CPU at 'highest'

def _family_modules():
    from vtaco_tpu_torch.models import decoder as D
    from vtaco_tpu_torch.models import fusion, layers, pointnetpp, voxels

    g = torch.Generator().manual_seed(5)
    imgs = torch.rand(4, 3, 48, 64, generator=g)
    cloud = torch.rand(2, 600, 3, generator=g) - 0.5
    fea = torch.randn(2, 600, 8, generator=g)
    q = torch.rand(2, 300, 3, generator=g) * 1.1 - 0.55
    vox = (torch.rand(2, 32, 32, 32, generator=g) > 0.7).float()
    grid = {"grid": torch.randn(2, 8, 8, 8, 8, generator=g)}
    c_img = torch.randn(2, 300, 8, generator=g)
    u3 = dict(num_levels=2, f_maps=8, in_channels=8, out_channels=8)
    return {
        "Resnet50": (layers.Resnet50(16), (imgs,)),
        "Resnet34": (layers.Resnet34(16), (imgs,)),
        "PointNetPlusPlus": (pointnetpp.PointNetPlusPlus(c_dim=8), (cloud,)),
        "LocalPointDecoder": (D.LocalPointDecoder(c_dim=8, hidden_size=16), (q, (cloud, fea))),
        "LocalVoxelEncoder": (voxels.LocalVoxelEncoder(
            c_dim=8, plane_type=["grid"], grid_resolution=16, unet3d=True,
            unet3d_kwargs=u3), (vox,)),
        "VoxelEncoder": (voxels.VoxelEncoder(c_dim=8), (vox,)),
        "TransformerFusion": (fusion.TransformerFusion(d_model=8, num_layers=2,
                                                       key_feature_dim=4),
                              (c_img, q, torch.randn(2, 300, 8, generator=g), q)),
        "AttentionDecoder": (D.AttentionDecoder(c_dim=8, hidden_size=16),
                             (q, grid, c_img)),
    }


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return type(x)(_to(v, dev) for v in x)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [t for v in x for t in _leaves(v)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Resnet50", "Resnet34", "PointNetPlusPlus",
                                  "LocalPointDecoder", "LocalVoxelEncoder",
                                  "VoxelEncoder", "TransformerFusion", "AttentionDecoder"])
def test_family_module_card_matches_cpu(cuda, name):
    """Each module of the families on random weights (seeded), in eval mode
    (the BatchNorms on random running statistics), on the card against
    the CPU: every output within 1e-4 of its largest entry. No kernel
    launches."""
    torch.manual_seed(0)
    module, args = _family_modules()[name]
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    module.eval()
    call = module.forward_img if name == "AttentionDecoder" else module
    before = {k: getattr(K, k).launches for k in ("fused_trunk_cn", "fused_trunk_gated_cn",
                                                  "fused_trunk_window_cn")}
    with torch.no_grad():
        want = _leaves(call(*args))
        card = copy.deepcopy(module).to(cuda)
        call = card.forward_img if name == "AttentionDecoder" else card
        got = _leaves(call(*_to(args, cuda)))
    assert {k: getattr(K, k).launches for k in before} == before
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        err = float((g_.cpu() - w_).abs().max() / w_.abs().max().clamp(min=1e-30))
        assert err < 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pn2", "vox"])
def test_family_step_card_matches_cpu(cuda, train_cfg, family):
    """One plain-path step of fam_pn2 (PointNet++ and the point decoder)
    and fam_vox (32³ voxel inputs, the voxel encoder) at train_cfg's
    widths, from the same weights and batch: loss scalars within 1e-4
    relative, each module's gradient cosine >= 0.999 with norms within
    2 %."""
    cfg = copy.deepcopy(train_cfg)
    m = cfg["model"]
    m.update(with_img=False, encoder_t2d=False)
    if family == "pn2":
        m.update(encoder="pointnet_plus_plus", decoder="simple_local_point")
    else:
        write_voxels(cfg["data"]["path"])
        cfg["data"].update(input_type="voxels", voxels_file="model.binvox")
        m.update(encoder="voxel_simple_local", encoder_hand=False)
        m["encoder_kwargs"] = {"plane_type": ["grid"], "grid_resolution": 16,
                               "unet3d": True,
                               "unet3d_kwargs": m["encoder_kwargs"]["unet3d_kwargs"]}
    want, got, grads = _step_card_vs_cpu(cuda, cfg, 3)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert "encoder" in grads and "decoder" in grads
    for mod, (cos, ratio) in grads.items():
        assert cos >= 0.999 and 0.98 < ratio < 1.02, (mod, cos, ratio)
