"""The harness's pieces on the CPU: weights, grasps, BENCHMARK.json and
the files it names, and the result line's rules."""

import json
import math
import os

import numpy as np
import torch

from port_bench import run
from port_bench.harness import grasps, weights
from port_bench.tests import tiny

BENCH = tiny.benchmark()
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


def test_draw_is_the_seeds_alone():
    sd = {"a.weight": torch.zeros(4, 3), "bn.weight": torch.zeros(3),
          "b.bias": torch.zeros(2), "n": torch.zeros(1, dtype=torch.long)}
    one = weights.draw(sd, 2 ** 40 + 1, "cpu")
    two = weights.draw(sd, 2 ** 40 + 1, "cpu")
    other = weights.draw(sd, 2 ** 40 + 2, "cpu")
    assert set(one) == {"a.weight", "bn.weight", "b.bias"}
    for k in one:
        assert torch.equal(one[k], two[k])
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert bool(((one["bn.weight"] >= 0.5) & (one["bn.weight"] < 1.5)).all())


def test_shaped_decoder_field():
    from port_bench.reference.decoder import LocalDecoder

    dec = LocalDecoder(c_dim=4, hidden_size=16, n_blocks=2)
    drawn = weights.draw({"decoder." + k: v for k, v in dec.state_dict().items()}, 3, "cpu")
    weights.shape_decoder(drawn, scale=4.0, noise=0.0)
    with torch.no_grad():
        for k, v in dec.state_dict().items():
            v.copy_(drawn["decoder." + k])
        p = torch.rand(1, 50, 3) - 0.5
        c = torch.randn(1, 50, 4)
        got = dec.forward_feats(p, c)
    want = -4.0 * (p[0] @ weights._AXES.T).abs().sum(-1) + drawn["decoder.fc_out.bias"]
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)


def test_pool_is_the_seeds_and_in_the_loaders_layout():
    cfg = tiny.config("vtaco_ycb")["config"]
    p = tiny.traffic("grasp")
    a, b = grasps.make_pool(2 ** 35, p, cfg), grasps.make_pool(2 ** 35, p, cfg)
    H, W = p["image_hw"]
    assert len(a) == p["pool"]
    for g, h in zip(a, b):
        assert g["inputs"].shape == (1, cfg["data"]["pointcloud_n"], 3)
        assert g["inputs.img"].shape == (1, 5, H, W, 3)
        assert g["inputs.depth"].shape == (1, 5, H * W)
        pressed = (np.abs(g["inputs.depth"][0] - grasps.DEPTH_REST) > 1e-4).any(1)
        assert pressed.tolist() == (g["inputs.touch_success"][0] > 0.5).tolist()
        for k in g:
            assert np.array_equal(g[k], h[k])
    order = grasps.request_order(2 ** 35, 4, 10)
    assert sorted(order[:4].tolist()) == [0, 1, 2, 3] and len(order) == 10
    assert len(grasps.make_pool(-3, p, cfg)) == p["pool"]   # a seed of any sign


def test_aim_puts_the_tips_mean_on_the_target():
    cfg = tiny.config("vtacoh_ycb")["config"]
    p = tiny.traffic("grasp")
    pool = grasps.make_pool(9, p, cfg)
    rng = np.random.default_rng(0)
    tips0 = rng.normal(size=(len(pool), 5, 3)) * 0.3

    def tips_fn(gs):
        return tips0

    def normalized(g, t):
        ply = g["inputs.pc_ply"][0].astype(np.float64)
        c = ply.mean(0)
        s = 2 * np.sqrt(((ply - c) ** 2).sum(1)).max()
        return t, c, s

    before = [normalized(g, None)[1:] for g in pool]
    grasps.aim_hands(pool, tips_fn, p)
    for g, t, (c0, s0) in zip(pool, tips0, before):
        world = t * s0 + c0 + g["points.mano"][0, :3]
        ply = g["inputs.pc_ply"][0].astype(np.float64)
        c, s = ply.mean(0), 2 * np.sqrt(((ply - ply.mean(0)) ** 2).sum(1)).max()
        tips = (world - c) / s
        np.testing.assert_allclose(tips.mean(0), g["surface_point"], atol=1e-4)
        spread = max(np.linalg.norm(a - b) for a in tips for b in tips)
        assert abs(spread - p["tip_span"]) < 1e-4


def test_benchmark_names_its_files():
    import re

    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(re.match(NAME, n) for n in names)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
        assert json.load(open(os.path.join(tiny.ROOT, c["file"])))["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(tiny.BENCH, "metrics", m["name"] + ".py"))
        assert 0.01 <= m.get("bound", 0.01) <= 0.25
    for w in BENCH["workloads"]:
        traffic = tiny.load(tiny.BENCH, "traffic", w["traffic"] + ".json")
        assert os.path.exists(os.path.join(tiny.BENCH, "loops", traffic["loop"] + ".py"))
        assert os.path.exists(os.path.join(tiny.BENCH, "checks", w["name"] + ".json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m for m in BENCH["end_to_end"] if run._applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert any(run._applies(m, w["name"]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert run._applies(e2e[m["moves"]], w)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_limits_lie_under_nothing_but_numbers():
    for w in BENCH["workloads"]:
        lim = tiny.load(tiny.BENCH, "checks", w["name"] + ".json")["limits"]
        assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
                   for v in lim.values())


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_unknown_metric_values_are_left_out():
    from port_bench.run import reader

    assert reader("grasp_p95_ms")({"family": "split", "unprofiled_ms": [1.0]}) is None
    assert reader("grasp_p95_ms")({"family": "grasp", "unprofiled_ms": [1.0, 3.0]}) == 2.9
    assert reader("k1_roofline")({"profile": None}) is None
    assert reader("device_idle_pct.grasp")({"family": "grasp", "profile": None}) is None
