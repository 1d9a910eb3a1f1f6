"""The train loop: ``Trainer.train_step`` at the configuration's batch and
training precision, fed by the port's ``BatchLoader`` (the configuration's
workers) over a synthetic split written at set-up under the run's TMPDIR
by the frozen generator (harness/synthetic.py) and deleted at the end.

Set-up builds one trainer from the drawn weights and drives it from the
seed through its first steps with the window's own call and feed (whole
batches of distinct models). It keeps those steps' batches, losses, the
first gradient as Adam holds it (its first moment after one step over
1 - beta1) and the parameters after the third step; the reference
follows the same three steps afterwards (harness/judge_train.py). The
window then runs steps until its time is up; a step is timed from asking
the loader for its batch to the host holding its scalars (the step ends
in that read, a synchronize).
"""

from __future__ import annotations

import contextlib
import copy
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench.harness import judge_train, synthetic, weights
from port_bench.harness.device import peak_bytes, sync
from port_bench.harness.trace import Profiled, warm_profiler


def _program():
    from vtaco_tpu_torch.core.factory import get_model, get_trainer
    from vtaco_tpu_torch.data.core import BatchLoader, get_dataset
    return get_model, get_trainer, BatchLoader, get_dataset


def endless(loader):
    """Epochs of the loader, one after another."""
    while True:
        yield from loader


class TrainSetup:
    """The split on disk, the program's model and trainer on the drawn
    weights, and its loader."""

    def __init__(self, ctx):
        get_model, get_trainer, BatchLoader, get_dataset = _program()
        p, dev = ctx.traffic, ctx.device
        seed32 = ctx.seed % (1 << 32)
        self.tmp = tempfile.mkdtemp(prefix="port_bench_split_",
                                    dir=os.environ.get("TMPDIR") or None)
        data_root, mesh_root = synthetic.generate(
            self.tmp, n_models=p["models"], n_query=p["query_points"],
            n_surface=p["surface_points"], img_h=p["image_hw"][0], img_w=p["image_hw"][1],
            seed=seed32, splits=(("train", 1.0),))
        cfg = copy.deepcopy(ctx.model_cfg)
        cfg["data"].update(path=data_root, mesh_dir=os.path.join(mesh_root, "mesh_obj"),
                           depth_origin=os.path.join(mesh_root, "depth_origin.txt"))
        self.cfg = cfg
        # the loader's fields draw their subsamples from NumPy's global generator
        np.random.seed(seed32)
        self.model = get_model(cfg, device=dev)
        self.drawn = weights.draw(self.model.state_dict(), ctx.seed, dev)
        weights.load(self.model, self.drawn)
        self.trainer = get_trainer(self.model, cfg, seed=ctx.seed % (1 << 63))
        self.batch_size = cfg["training"]["batch_size"]
        loader = BatchLoader(get_dataset("train", cfg), self.batch_size, shuffle=True,
                             num_workers=cfg["training"]["n_workers"], seed=seed32)
        self.batches = endless(loader)

    def first_steps(self, n):
        """The first n steps through the window's call: their batches,
        scalars, Adam's view of the first gradient and the parameters
        after the last of them."""
        kept, scalars, grad1 = [], [], None
        for i in range(n):
            batch = next(self.batches)
            kept.append(batch)
            scalars.append(self.trainer.train_step(batch))
            if i == 0:
                grad1 = adam_first_gradient(self.trainer.optimizer, self.model)
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        return kept, scalars, grad1, params

    def close(self):
        self.batches.close()

    def remove(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def adam_first_gradient(opt, model):
    """{name: the gradient Adam took in its first step}: its first moment
    over 1 - beta1 (the moment starts at zero)."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in model.named_parameters():
        st = opt.state.get(p)
        out[k] = (st["exp_avg"] / (1 - beta1)).clone() if st and "exp_avg" in st \
            else torch.zeros_like(p)
    return out


def run(ctx) -> dict:
    p, dev = ctx.traffic, ctx.device
    s = TrainSetup(ctx)
    try:
        return _run(ctx, s, p, dev)
    finally:
        s.close()
        s.remove()


def _run(ctx, s, p, dev):
    kept, scalars, grad1, params3 = s.first_steps(p["checked_steps"])
    for _ in range(p["warmup_steps"]):
        s.trainer.train_step(next(s.batches))
    if ctx.trace:
        warm_profiler(dev)
        s.trainer.stage_events = []
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    prof = Profiled() if ctx.trace else None
    span = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
    p0, p1 = 2, 2 + p["profiled_steps"]
    step_ms = []
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while t_end - t_start < ctx.seconds:
        if prof is not None and i == p0:
            prof.__enter__()
        t0 = time.perf_counter()
        with span("train.loader"):
            batch = next(s.batches)
        with span("train.step"):
            s.trainer.train_step(batch)
        t_end = time.perf_counter()
        if prof is not None and i == p1 - 1:
            prof.__exit__(None, None, None)
        step_ms.append((t_end - t0) * 1e3)
        i += 1
    if prof is not None and not p0 < i < p1:
        prof = prof if i >= p1 else None
    elif prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t_start
    peak = peak_bytes(dev)
    if prof is not None:
        prof.read()
    stages = stage_ms(s.trainer.stage_events) if ctx.trace else {}
    s.trainer.stage_events = None
    record = {"family": "train", "setup_s": setup_s, "window_s": window_s,
              "steps": len(step_ms), "batch_size": s.batch_size, "step_ms": step_ms,
              "stages": stages, "profile": prof,
              "profiled_steps": min(max(i - p0, 0), p["profiled_steps"])}
    s.close()
    del s.trainer, s.model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge_train.judge(ctx, s.cfg, s.drawn, kept, scalars, grad1, params3)
    record.update(verdict["record"])
    return {"record": record, "attempted": len(step_ms), "failed": 0,
            "checks": verdict["checks"], "peak_bytes": peak}


def stage_ms(events):
    """{stage: [ms per step]} from the trainer's (name, event) marks: each
    stage runs from the mark before it to its own."""
    torch.cuda.synchronize()
    out, prev = {}, None
    for name, ev in events:
        if name != "start" and prev is not None:
            out.setdefault(name, []).append(prev.elapsed_time(ev))
        prev = ev
    return out
