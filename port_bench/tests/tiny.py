"""Tiny widths of the benchmark's configurations and traffic, for runs on
the CPU in the tests: every module and path of the cells, at sizes a test
run holds (decoder 8 wide, a grid of 8, tactile images of 32 x 24,
nx = 32)."""

from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return load(ROOT, "BENCHMARK.json")


def benchmark_cell(name):
    return next(w for w in benchmark()["workloads"] if w["name"] == name)


def config(name):
    c = copy.deepcopy(load(BENCH, "configs", name + ".json"))
    m = c["config"]["model"]
    m["c_dim"] = 8
    m["decoder_kwargs"]["hidden_size"] = 16
    m["encoder_kwargs"].update(hidden_dim=8, grid_resolution=8)
    m["encoder_kwargs"]["unet3d_kwargs"].update(num_levels=2, f_maps=8, in_channels=8,
                                                 out_channels=8)
    m["encoder_hand_kwargs"].update(hidden_dim=8, plane_resolution=8)
    m["encoder_hand_kwargs"]["unet_kwargs"].update(depth=2, start_filts=8)
    m["encoder_img_kwargs"]["num_classes"] = 8
    if m["encoder_t2d"]:
        t = m["encoder_t2d_kwargs"]
        t["encoder_img_kwargs"].update(start_filts=8, depth=2)
        t["encoder_hand_kwargs"].update(c_dim=8, hidden_dim=8, plane_resolution=8)
        t["encoder_hand_kwargs"]["unet_kwargs"].update(depth=2, start_filts=8)
    c["config"]["data"].update(pointcloud_n=300, points_subsample=2000, num_sample=256)
    c["config"]["generation"]["resolution_0"] = 8
    return c


def traffic(name):
    t = load(BENCH, "traffic", name + ".json")
    if t["loop"] == "grasp":
        t.update(pool=4, hand_points=60, scan_points=500, image_hw=[32, 24],
                 dome_radius_px=[3, 6], warmup_requests=1, check_grasps=2,
                 profiled_requests=2)
    else:
        t.update(models=6, query_points=2000, surface_points=2000, image_hw=[32, 24],
                 warmup_steps=1, profiled_steps=2)
    return t
