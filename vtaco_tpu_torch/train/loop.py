"""Training loop with the reference's cadences (port of
vtaco_tpu/train/loop.py:33-416).

An endless epoch loop with modulo-iteration triggers for print, validate,
checkpoint, backup and visualize (through the ``generator_factory``'s
hook, generate.generator.make_loop_generator in the CLI; a failed
visualization is printed and training goes on); model_best selection by
the configured metric; and the ``exit_after`` preemption contract (save
model.ckpt, exit with code 3). Metrics stream to stdout and to
``<out_dir>/logs/metrics.jsonl``, and with ``training.tensorboard`` also to
TensorBoard event files in ``<out_dir>/logs`` through tensorboardX (where
it is not installed, a warning and jsonl only). The pretrained
tactile-to-depth parameters are grafted from
``encoder_t2d_kwargs.model_file`` before a resume, so a resumed
checkpoint's own encoder_t2d wins.

Observability (utils/profiling.py): ``training.profile_dir`` writes a
torch.profiler trace of iterations 10 to 20 there (fused blocks
included: the trace starts with the first block that reaches 10);
``training.debug_nans`` runs the loop in autograd's anomaly mode and stops
it with FloatingPointError, naming the iteration, at the first step whose
loss is not finite or whose backward pass makes a NaN. The train steps
already read their scalars on the host, so the check adds no sync.

With ``data.on_device`` the train and val splits are stacked on the
device (data.device_data) and validation runs through
``Trainer.evaluate_device``; with ``training.steps_per_dispatch`` K > 1 as
well, the steps run in blocks of K through ``Trainer.make_fused_train_fn``
(one host read per block), cut to blocks of one step before each
validate, checkpoint, backup and visualize cadence and before
``max_iters``, so that every cadence fires at its iteration; each
block's length is logged as ``train/steps_per_block`` at its first
iteration. A block's ``exit_after`` check comes after its last step.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.factory import get_model
from vtaco_tpu_torch.data.core import BatchLoader, get_dataset
from vtaco_tpu_torch.data.device_data import DeviceBatchLoader, DeviceDataset
from vtaco_tpu_torch.ops.winding import MeshBank
from vtaco_tpu_torch.train.trainer import Trainer, check_trainer_init
from vtaco_tpu_torch.utils import meshio
from vtaco_tpu_torch.utils.profiling import (ProfiledRegion, StepTimer, check_finite,
                                             debug_nans)


class JsonlLogger:
    """Scalar logger writing one JSON object per line, and with
    ``tensorboard`` TensorBoard event files beside it (the reference's
    ``SummaryWriter(os.path.join(out_dir, 'logs'))``) through tensorboardX
    where it is installed."""

    def __init__(self, path, tensorboard=False):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")
        self.tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("Warning: training.tensorboard=true but tensorboardX "
                      "is not installed; writing jsonl only")
            else:
                self.tb = SummaryWriter(os.path.dirname(path))

    def add_scalar(self, tag, value, step):
        self.f.write(json.dumps({"tag": tag, "value": float(value), "it": int(step)}) + "\n")
        self.f.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


@contextlib.contextmanager
def _nan_errors(enable, its):
    """Under ``debug_nans``: anomaly mode's NaN in a backward pass becomes
    FloatingPointError naming the step's iterations ``its``."""
    try:
        yield
    except RuntimeError as e:
        if enable and "returned nan values" in str(e):
            raise FloatingPointError(f"training.debug_nans: {e} (iteration {its})") from e
        raise


def build_mesh_bank(cfg, device="cuda") -> Optional[MeshBank]:
    """Every ground-truth object mesh (.off, .obj) of data.mesh_dir in one
    MeshBank on ``device``, or None without the directory."""
    mesh_dir = cfg["data"].get("mesh_dir")
    if not mesh_dir or not os.path.isdir(mesh_dir):
        return None
    meshes = {}
    for path in sorted(glob.glob(os.path.join(mesh_dir, "*"))):
        base, ext = os.path.splitext(os.path.basename(path))
        if ext.lower() in (".off", ".obj") and base not in meshes:
            meshes[base] = meshio.read_triangle_mesh(path)
    return MeshBank(meshes, device=device) if meshes else None


def graft_t2d(model, t2d_file, checkpoint_dir):
    """Copy the parameters of encoder_t2d.{encoder_hand, encoder_img} from
    the encoder_hand and encoder_img of a checkpoint's model (a tactile
    experiment's), the file resolved against ``checkpoint_dir``. Parameters
    only, as the JAX package grafts its ``params``: the BatchNorm running
    statistics and counters stay as built. A missing file warns; a
    structure that differs raises ValueError."""
    try:
        payload, _ = CheckpointIO(checkpoint_dir).load_raw(t2d_file)
    except FileNotFoundError:
        print(f"Warning: pretrained t2d checkpoint {t2d_file} not found")
        return
    src_sd = payload.get("model", {})
    grafted = []
    for sub in ("encoder_hand", "encoder_img"):
        src = {k[len(sub) + 1:]: v for k, v in src_sd.items() if k.startswith(sub + ".")}
        if not src:
            continue
        dst = getattr(model.encoder_t2d, sub)
        params = dict(dst.named_parameters())
        buffers = set(dict(dst.named_buffers()))
        src = {k: v for k, v in src.items() if k not in buffers}
        want = {k: tuple(v.shape) for k, v in params.items()}
        got = {k: tuple(v.shape) for k, v in src.items()}
        if want != got:
            bad = [k for k in want.keys() | got.keys() if want.get(k) != got.get(k)][:4]
            raise ValueError(f"t2d checkpoint {sub} does not match the model's "
                             f"encoder_t2d.{sub} (config mismatch?): first differing "
                             f"entries {bad}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(src[k])
        grafted.append(sub)
    print(f"=> loaded pretrained t2d weights from {t2d_file} ({', '.join(grafted)})")


def train(cfg, exit_after: int = -1, max_iters: Optional[int] = None,
          device="cuda", seed=0, generator_factory=None):
    """Run training per cfg on ``device``. ``generator_factory(model, cfg,
    mesh_bank)`` makes the hook whose ``visualize(model, val_loader,
    out_dir, it)`` runs every ``training.visualize_every`` iterations.
    Returns (trainer, it) on a normal stop; raises SystemExit(3) after
    saving once ``exit_after`` seconds have passed."""
    tcfg = cfg["training"]
    out_dir = tcfg["out_dir"]
    batch_size = tcfg["batch_size"]
    print_every, validate_every = tcfg["print_every"], tcfg["validate_every"]
    visualize_every = tcfg["visualize_every"]
    checkpoint_every, backup_every = tcfg["checkpoint_every"], tcfg["backup_every"]
    metric = tcfg["model_selection_metric"]
    sign = {"maximize": 1, "minimize": -1}.get(tcfg["model_selection_mode"])
    if sign is None:
        raise ValueError("model_selection_mode must be maximize or minimize")
    os.makedirs(out_dir, exist_ok=True)

    train_dataset = get_dataset("train", cfg)
    val_dataset = get_dataset("val", cfg, return_idx=True)
    if len(train_dataset) == 0:
        raise ValueError("train split %r of %s contains no models"
                         % (cfg["data"]["train_split"], cfg["data"]["path"]))
    if batch_size > len(train_dataset):
        print("Warning: batch_size %d > train split size %d; clamping"
              % (batch_size, len(train_dataset)))
        batch_size = len(train_dataset)
    val_dds = None
    if cfg["data"].get("on_device"):
        noise = cfg["data"]["pointcloud_noise"]
        dds = DeviceDataset(train_dataset, pointcloud_noise=noise, device=device)
        val_dds = DeviceDataset(val_dataset, pointcloud_noise=noise, device=device)
        print("device-resident dataset: %d models, %.1f MB on %s (val: %d models, %.1f MB)"
              % (dds.n_models, dds.nbytes() / 1e6, device, val_dds.n_models,
                 val_dds.nbytes() / 1e6))
        train_loader = DeviceBatchLoader(dds, batch_size, seed=seed,
                                         n_points=cfg["data"]["points_subsample"],
                                         n_cloud=cfg["data"]["pointcloud_n"])
    else:
        train_loader = BatchLoader(train_dataset, batch_size, shuffle=True,
                                   num_workers=tcfg["n_workers"], seed=seed)

    def val_loader():
        return BatchLoader(val_dataset, 1, shuffle=False,
                           num_workers=tcfg["n_workers_val"])

    torch.manual_seed(seed)
    model, aux = get_model(cfg, device=device, return_aux=True, dataset=train_dataset)
    check_trainer_init(model)
    bank = build_mesh_bank(cfg, device)
    trainer = Trainer.from_config(model, cfg, mesh_bank=bank, seed=seed)
    if aux["t2d_pretrained_file"]:
        graft_t2d(model, aux["t2d_pretrained_file"], out_dir)
    ckpt = CheckpointIO(out_dir, model=model, optimizer=trainer.optimizer)
    epoch_it, it = 0, 0
    metric_val_best = -sign * np.inf
    try:
        scalars = ckpt.load(cfg["test"]["model_file"])
        epoch_it = int(scalars.get("epoch_it", 0))
        it = int(scalars.get("it", 0))
        metric_val_best = float(scalars.get("loss_val_best", metric_val_best))
        trainer.step = it
        print(f"=> resumed at it={it} (best {metric}={metric_val_best:.6f})")
    except FileNotFoundError:
        pass
    if not np.isfinite(metric_val_best):
        metric_val_best = -sign * np.inf

    print("Total number of parameters: %d" % sum(p.numel() for p in model.parameters()))
    print("output path: ", out_dir)
    logger = JsonlLogger(os.path.join(out_dir, "logs", "metrics.jsonl"),
                         tensorboard=tcfg.get("tensorboard", False))
    generator = generator_factory(model, cfg, bank) if generator_factory else None
    n_points, n_cloud = cfg["data"]["points_subsample"], cfg["data"]["pointcloud_n"]
    fused_val = None
    if val_dds is not None and val_dds.n_models:
        fused_val = trainer.make_fused_eval_fn(val_dds, n_points, n_cloud)
    nans = bool(tcfg.get("debug_nans"))
    profiler = ProfiledRegion(tcfg.get("profile_dir"))
    timer = StepTimer()
    t0 = time.time()
    stop = False

    def save(filename):
        ckpt.save(filename, epoch_it=epoch_it, it=it, loss_val_best=metric_val_best)

    def post_step(scalars, exit_ok=True, rate=None):
        """Everything after step ``it``: logging and the cadences. A fused
        block passes exit_ok False for all but its last step: the model
        already holds the whole block, so an exit_after save there would
        record an ``it`` behind it; and its steps/s as ``rate``, since its
        steps are logged together after it."""
        nonlocal metric_val_best, stop
        timer.tick()
        if nans:
            check_finite(scalars, it)
        for k, v in scalars.items():
            logger.add_scalar(f"train/{k}", v, it)
        if print_every > 0 and it % print_every == 0:
            msg = ", ".join(f"{k}={v:.4f}" for k, v in scalars.items())
            print("[Epoch %02d] it=%03d, %s, %.2f it/s, time: %.2fs"
                  % (epoch_it, it, msg, timer.steps_per_sec if rate is None else rate,
                     time.time() - t0))
        if validate_every > 0 and it % validate_every == 0:
            if fused_val is not None:
                eval_dict = trainer.evaluate_device(fused_val, val_dds.n_models)
            else:
                eval_dict = trainer.evaluate(val_loader())
            metric_val = eval_dict[metric]
            print("Validation metric (%s): %.4f" % (metric, metric_val))
            for k, v in eval_dict.items():
                logger.add_scalar(f"val/{k}", v, it)
            if sign * (metric_val - metric_val_best) > 0:
                metric_val_best = metric_val
                print("New best model (%s %.4f)" % (metric, metric_val_best))
                save("model_best.ckpt")
        if checkpoint_every > 0 and it % checkpoint_every == 0:
            print("Saving checkpoint at iteration: %d" % it)
            save("model.ckpt")
        if backup_every > 0 and it % backup_every == 0:
            print("Backup checkpoint at iteration: %d" % it)
            save("model_%d.ckpt" % it)
        if generator is not None and visualize_every > 0 and it % visualize_every == 0:
            try:
                generator.visualize(model, val_loader(), out_dir, it)
            except Exception as e:   # visualization must not stop training
                print("visualize failed:", e)
        if exit_ok and exit_after > 0 and (time.time() - t0) >= exit_after:
            print("Time limit reached. Exiting.")
            save("model.ckpt")
            raise SystemExit(3)
        if max_iters is not None and it >= max_iters:
            stop = True

    fused_k = int(tcfg.get("steps_per_dispatch", 1) or 1)

    def run():
        nonlocal it, epoch_it
        if val_dds is not None and fused_k > 1:
            fused = trainer.make_fused_train_fn(train_loader.ds, n_points, n_cloud)
            steps_per_epoch = max(1, train_loader.ds.n_models // batch_size)

            def dist_to_cadence(it):
                ds_ = [fused_k]
                for c in (validate_every, checkpoint_every, backup_every, visualize_every):
                    if c and c > 0:
                        ds_.append(c - it % c)
                if max_iters is not None:
                    ds_.append(max_iters - it)
                return max(1, min(ds_))

            while not stop:
                k = fused_k if dist_to_cadence(it) >= fused_k else 1
                logger.add_scalar("train/steps_per_block", k, it + 1)
                t_block = time.time()
                profiler.maybe_start(it + 1)
                with _nan_errors(nans, f"{it + 1}-{it + k}"):
                    scal = trainer.read_scalars(fused(train_loader.take_ids(k),
                                                      train_loader.next_key()))
                profiler.maybe_stop(it + 1)
                rate = k / max(time.time() - t_block, 1e-9)
                for j in range(k):
                    it += 1
                    epoch_it = 1 + (it - 1) // steps_per_epoch
                    post_step({name: float(v[j]) for name, v in scal.items()},
                              exit_ok=j == k - 1, rate=rate)
                    if stop:
                        break
        else:
            while not stop:
                epoch_it += 1
                for batch in train_loader:
                    it += 1
                    profiler.maybe_start(it)
                    with _nan_errors(nans, it):
                        scalars = trainer.train_step(batch)
                    profiler.maybe_stop(it)
                    post_step(scalars)
                    if stop:
                        break

    try:
        with debug_nans(nans):
            run()
        save("model.ckpt")
    finally:
        logger.close()
    return trainer, it
