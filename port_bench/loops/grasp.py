"""The grasp loop: one client reconstructs a mesh per grasp and waits for
it before sending the next (a closed loop).

Each request drives the steps of ``Generator3D.generate_obj_mesh_wnf`` up
to its mesh, without its chamfer and EMD (scores against ground truth
that a grasp does not wait for): ``_encode_sample`` (the object encoder
and the configuration's gates), ``eval_points_dense`` at nx =
resolution_0 · 4 (K1 under contact gates, K2 with c_img rows under
fingertip gates), the native marching cubes at the midpoint level, and
the vertices moved into the object's frame. A request is timed from the
moment its host arrays are handed over to the moment its mesh is on the
host.

After the window the outputs of a seeded sample of the pool's grasps (the
last time each was served) are judged against the plain reference
(port_bench/reference/) on the same weights and inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import grasps, weights
from port_bench.harness.device import peak_bytes, sync
from port_bench.harness.trace import Profiled, Spans, warm_profiler
from port_bench.harness import judge_grasp


def _program():
    """The port's entry points this loop drives."""
    from vtaco_tpu_torch.core.factory import get_generator, get_model
    from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
    from vtaco_tpu_torch.train.contact import tips_in_object_frame
    return get_model, get_generator, marching_cubes, tips_in_object_frame


class Served:
    """One request's outputs: the mesh, and what the check compares on
    the way (the feature grid, the gates, the shipped logits)."""

    __slots__ = ("verts", "faces", "c", "gates", "values")

    def __init__(self, verts, faces, c, gates, values):
        self.verts, self.faces, self.c, self.gates, self.values = verts, faces, c, gates, values


def serve(gen, model, g, nx, seed, spans, marching_cubes):
    """One request: host arrays in, the mesh on the host out."""
    with torch.inference_mode():
        c, gates = gen._encode_sample(model, g, seed)
        with spans.device("grasp.decode"):
            values = gen.eval_points_dense(model, nx, c, *gates,
                                           transfer_dtype=gen.transfer_dtype)
        with spans.host_clock("grasp.mc"):
            verts, faces = marching_cubes(values.reshape(nx, nx, nx), level=None,
                                          gradient="ascent")
        box = 1 + gen.padding
        verts = (verts - np.float32(nx / 2)) * np.float32(box / nx)
    return Served(verts, faces, c, gates, values)


def tips_fn(model, dev, tips_in_object_frame):
    """The fingertips (G, 5, 3) of a list of grasps as they stand, with
    their wrists at the origin: the program's hand encoder in one call, at
    set-up, to aim the hands."""
    def tips(pool):
        with torch.inference_mode():
            x = torch.as_tensor(np.concatenate([g["inputs"] for g in pool]), device=dev)
            joints = model.encode_hand_inputs(x)["mano_joints"]
            wrist = torch.as_tensor(np.concatenate([g["points.wrist"] for g in pool]),
                                    device=dev)
            ply = torch.as_tensor(np.concatenate([g["inputs.pc_ply"] for g in pool]),
                                  device=dev)
            return tips_in_object_frame(joints, torch.zeros_like(wrist), wrist,
                                        ply).cpu().numpy()
    return tips


def decoder_widths(cfg):
    """The simple_local decoder's widths as the configuration states them
    (n_blocks: the decoder's default of 5 where it states none)."""
    kw = cfg["model"].get("decoder_kwargs") or {}
    return {"hidden": kw.get("hidden_size", 256), "c_dim": cfg["model"]["c_dim"],
            "n_blocks": kw.get("n_blocks", 5)}


class Setup:
    """The program, its drawn weights and the cell's inputs."""

    def __init__(self, ctx):
        get_model, get_generator, self.marching_cubes, tips_in_object_frame = _program()
        cfg, p, dev = ctx.model_cfg, ctx.traffic, ctx.device
        self.contact = bool(cfg["model"]["encoder_t2d"])
        self.model = get_model(cfg, device=dev)
        self.drawn = weights.draw(self.model.state_dict(), ctx.seed, dev)
        weights.shape_decoder(self.drawn, **ctx.config["weights"]["decoder_field"])
        weights.load(self.model, self.drawn)
        self.gen = get_generator(self.model, cfg)
        self.nx = self.gen.resolution0 * p["nx_per_resolution_0"]
        self.pool = grasps.make_pool(ctx.seed, p, cfg)
        if not self.contact:
            grasps.aim_hands(self.pool, tips_fn(self.model, dev, tips_in_object_frame), p)
        rng = grasps.seeded(ctx.seed, 3)
        self.checked = [int(i) for i in rng.choice(len(self.pool), p["check_grasps"],
                                                   replace=False)]


def run(ctx) -> dict:
    cfg, p, dev = ctx.model_cfg, ctx.traffic, ctx.device
    s = Setup(ctx)
    model, gen, nx, pool, contact = s.model, s.gen, s.nx, s.pool, s.contact
    marching_cubes, drawn, checked = s.marching_cubes, s.drawn, s.checked
    del s

    spans = Spans(ctx.trace)
    spans.wrap(model, "encode_inputs", "grasp.encode")
    spans.wrap(gen, "_build_gates", "grasp.gates")
    off = Spans(False)
    for i in range(p["warmup_requests"]):
        serve(gen, model, pool[i], nx, i, off, marching_cubes)
    if ctx.trace:
        warm_profiler(dev)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    spans.reset()
    order = grasps.request_order(ctx.seed, len(pool), 1 << 20)
    latency, outside, kept, profiled, faceless = [], [], {}, [], 0
    prof = Profiled() if ctx.trace else None
    p0, p1 = 2, 2 + p["profiled_requests"]      # the profiled block of requests
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while t_end - t_start < ctx.seconds:
        gid = int(order[i])
        if prof is not None and i == p0:
            prof.__enter__()
        t0 = time.perf_counter()
        out = serve(gen, model, pool[gid], nx, gid, spans, marching_cubes)
        t_end = time.perf_counter()
        latency.append((t_end - t0) * 1e3)
        if prof is not None and p0 <= i < p1:
            profiled.append(gid)
            if i == p1 - 1:
                prof.__exit__(None, None, None)
        else:
            outside.append(latency[-1])      # the requests the profiler did not slow
        faceless += len(out.faces) == 0
        if gid in checked:
            kept[gid] = out
        i += 1
    if prof is not None and not p0 < i < p1:
        prof = prof if i >= p1 else None
    elif prof is not None:
        prof.__exit__(None, None, None)     # the window closed inside the block
    window_s = t_end - t_start
    peak = peak_bytes(dev)
    if prof is not None:
        prof.read()
    record = {"family": "grasp", "setup_s": setup_s, "window_s": window_s,
              "completed": len(latency), "latency_ms": latency, "unprofiled_ms": outside,
              "spans": spans.device_ms() if ctx.trace else {}, "host_spans": spans.host,
              "profile": prof, "profiled": profiled,
              "gating": "contact" if contact else "tips", "decoder": decoder_widths(cfg)}
    del model, gen, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference, once the window has closed and the peak is read
    verdict = judge_grasp.judge(ctx, kept, pool, drawn, nx, contact,
                                profiled=profiled if ctx.trace else ())
    record.update(verdict["record"])
    return {"record": record, "attempted": len(latency), "failed": faceless,
            "checks": verdict["checks"], "peak_bytes": peak}
