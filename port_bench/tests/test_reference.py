"""The plain reference (port_bench/reference/) against the port at tiny
widths on the CPU, on the same drawn weights and inputs: each stage that
the grasp cells' check compares."""

import numpy as np
import pytest
import torch

from port_bench.harness import grasps, judge_grasp, weights
from port_bench.reference import gates as ref_gates
from port_bench.reference import model as ref_model
from port_bench.tests import tiny

CONFIGS = ("vtaco_ycb", "vtacoh_ycb")


def _pair(name, seed=5):
    from vtaco_tpu_torch.core.factory import get_generator, get_model
    from vtaco_tpu_torch.train.contact import tips_in_object_frame
    from port_bench.loops.grasp import tips_fn

    conf = tiny.config(name)
    cfg = conf["config"]
    model = get_model(cfg, device="cpu")
    drawn = weights.draw(model.state_dict(), seed, "cpu")
    weights.shape_decoder(drawn, **conf["weights"]["decoder_field"])
    weights.load(model, drawn)
    ref = ref_model.build(cfg)
    weights.load(ref, drawn, strict_names=False)
    pool = grasps.make_pool(seed, tiny.traffic("grasp"), cfg)
    contact = bool(cfg["model"]["encoder_t2d"])
    if not contact:
        grasps.aim_hands(pool, tips_fn(model, torch.device("cpu"), tips_in_object_frame),
                         tiny.traffic("grasp"))
    return cfg, model, get_generator(model, cfg), ref, pool, contact


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    return _pair(request.param)


def _x(g, key):
    return torch.as_tensor(g[key])


def test_object_encoder(pair):
    _, model, _, ref, pool, _ = pair
    with torch.no_grad():
        got = model.encode_inputs(_x(pool[0], "inputs"))
        want = ref.encode_inputs(_x(pool[0], "inputs"))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_tactile_features_and_hand(pair):
    _, model, _, ref, pool, contact = pair
    with torch.no_grad():
        torch.testing.assert_close(model.encode_img_inputs(_x(pool[1], "inputs.img")),
                                   ref.encode_img_inputs(_x(pool[1], "inputs.img")),
                                   rtol=0, atol=1e-5)
        if not contact:
            got = model.encode_hand_inputs(_x(pool[1], "inputs"))["mano_joints"]
            want = ref.encode_hand_inputs(_x(pool[1], "inputs"))["mano_joints"]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_gates(pair):
    _, model, gen, ref, pool, contact = pair
    for gid in range(2):
        with torch.no_grad():
            _, got = gen._encode_sample(model, pool[gid], gid)
            want = ref_gates.grasp_gates(ref, pool[gid], gid, torch.device("cpu"), contact)
        nums = judge_grasp.gate_numbers(got, want)
        assert got[0] == ("contact" if contact else "tips")
        assert nums["gates"] < 1e-6 and nums["c_img"] < 1e-6


def test_dense_logits_and_mesh(pair):
    cfg, model, gen, ref, pool, contact = pair
    from vtaco_tpu_torch.generate.marching_cubes import marching_cubes

    nx = gen.resolution0 * 4
    box = 1 + cfg["data"]["padding"]
    with torch.no_grad():
        c, gates = gen._encode_sample(model, pool[0], 0)
        values = gen.eval_points_dense(model, nx, c, *gates, transfer_dtype=gen.transfer_dtype)
        rc = ref.encode_inputs(_x(pool[0], "inputs"))
        rg = ref_gates.grasp_gates(ref, pool[0], 0, torch.device("cpu"), contact)
        logits, settled = ref_gates.dense_logits(ref, rc, rg, nx, box)
    got = torch.as_tensor(values)
    assert bool(settled.any())
    rel = float((got - logits)[settled].abs().max() / logits.abs().max())
    assert rel < 1e-5
    # the port's native marching cubes against the plain one on the same logits
    verts, faces = marching_cubes(values.reshape(nx, nx, nx), level=None, gradient="ascent")
    verts = (verts - np.float32(nx / 2)) * np.float32(box / nx)
    nums = judge_grasp.mesh_numbers(values, verts, faces, logits.numpy(), nx, box)
    assert len(faces) > 0
    assert nums["mesh_count"] == 0 and nums["mesh_verts"] < 1e-6
    assert nums["mesh_chamfer"] < 1e-5 and nums["mesh_volume"] < 1e-4


def test_settled_points_leave_out_the_gate_boundary():
    pts = torch.tensor([[0.0, 0.0, 0.015], [0.0, 0.0, 0.0], [0.0, 0.0, 0.2]])
    gate_pts = torch.zeros((5, 2, 3))
    valid = torch.zeros((5, 2), dtype=torch.bool)
    valid[3, 0] = True
    feat = torch.arange(10.0).reshape(5, 2)
    rows, settled = ref_gates.gate_rows(pts, "contact", gate_pts, feat, valid)
    assert settled.tolist() == [False, True, True]
    assert rows[1].tolist() == feat[3].tolist() and rows[2].tolist() == [0.0, 0.0]
