"""Trainer: the train and eval steps of the VTacO t2d_img loss path, the
VTacOH img loss path and the tactile depth-stack pretraining (port of
vtaco_tpu/train/trainer.py:71-860, ``compute_loss_t2d_img``,
``compute_loss_img`` and ``compute_loss_tactile``).

The tactile path (``model.train_tactile``, configs/tactile/) trains the
depth U-Net and the sensor-pose head alone: the L1 distance of the
predicted depth maps to the batch's min-max normalized ground-truth
depths, plus the MSE of the hand encoder's parameters against the
concatenated sensor positions and rotations. It needs no ground-truth
meshes, and its eval step reports the loss scalars only.

One step: the nested tactile-to-depth model runs (with a pretrained t2d
and ground-truth depths, the defaults, its outputs reach no loss: it runs
only so that its BatchNorm statistics move, under ``torch.no_grad``);
contact points back-projected from the depth maps are mixed into a
``num_sample``-point decode sample; winding numbers of the ground-truth
meshes label it; the object, hand and tactile encoders and the decoder
give the L1 occupancy loss, and the hand encoder's MANO head the pose and
hand-vertex losses.

The img path (VTacOH: images, no tactile-to-depth model) samples its
decode points by fingertip proximity instead: the hand encoder's MANO
fingertips, moved into the object frame by the ground-truth wrist, pick
at most ``tips_per_finger`` query points per touching finger (within 0.05
of the tip), the rest uniformly, with the dataset's own occupancy labels;
a point near a tip takes that finger's tactile feature, any other zeros.
Its eval step decodes the whole ``points_iou`` set, each point's feature
assigned by proximity, with no resampling.

Gradients come from autograd over the plain modules,
as the JAX package differentiates its plain XLA path; the optimizer is
torch.optim.Adam (optax ``adam(lr)``'s β 0.9/0.999 and ε 1e-8) or SGD
with momentum 0.9. ``training.matmul_precision`` decides whether the
steps' float32 matmuls and convolutions on the card run in TF32, as JAX
maps its precision names on a GPU: 'default' and 'high' (the config
default is 'default') allow TF32, 'highest' runs full float32.

The JAX package's other loss paths (plain, contact, t2d without images),
mixed precision, rematerialization and its device-resident fused steps
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch

from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.winding import MeshBank, winding_number_batch
from vtaco_tpu_torch.train import contact as C

DEPTH_NEAR = 0.019
DEPTH_REST = 0.0215
# predicted-depth denormalization slope (wider than DEPTH_FAR - DEPTH_NEAR,
# as in the reference)
DEPTH_SCALE = 0.005
CAM_FOV = 60.0
# JAX precision name → TF32 allowed on the card (jax.lax.Precision on a GPU:
# DEFAULT and HIGH use TF32 where the card has it, HIGHEST full float32)
TF32 = {"default": True, "fastest": True, "bfloat16": True, "high": True,
        "bfloat16_3x": True, "tensorfloat32": True, "highest": False, "float32": False}


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


@contextlib.contextmanager
def matmul_precision(name):
    """Set cuBLAS's and cuDNN's TF32 flags from a JAX precision name for
    the block, then restore the process's own. Float32 work on the CPU is
    unaffected."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = TF32[name]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _minmax_norm(x):
    return (x - torch.min(x)) / (torch.max(x) - torch.min(x))


class Trainer:
    """Runs the train and eval steps on the device of ``model``'s
    parameters. ``stage_events``, when set to a list, collects
    (stage name, recorded torch.cuda.Event) pairs at the step's stage
    boundaries. Train and eval steps run at ``matmul_precision``."""

    def __init__(self, model, optimizer=None, *, lr=1e-4, opt="Adam",
                 num_sample=2048, threshold=0.5, with_img=False,
                 train_tactile=False, encode_t2d=False, pretrained_t2d=True,
                 mesh_bank: Optional[MeshBank] = None,
                 depth_origin: Optional[np.ndarray] = None, legacy_gt_depth=True,
                 contact_per_finger=128, tips_per_finger=512, seed=0,
                 skip_unused_t2d=False, compute_dtype=None, remat=False,
                 matmul_precision="default"):
        if matmul_precision not in TF32:
            raise ValueError(f"training.matmul_precision {matmul_precision!r} is "
                             f"none of {sorted(TF32)}")
        if not (train_tactile or with_img):
            raise NotImplementedError(
                "Only the t2d_img, img and tactile loss paths are ported; the "
                "plain, contact and t2d-without-images loss paths (model.with_img "
                "false) are not ported yet (ROADMAP.md, items 5 and 7)")
        if compute_dtype is not None:
            _not_ported("training.compute_dtype")
        if remat:
            _not_ported("training.remat")
        self.model = model
        self.device = next(model.parameters()).device
        if optimizer is None:
            params = model.parameters()
            optimizer = (torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
                         if opt == "Adam" else torch.optim.SGD(params, lr=lr, momentum=0.9))
        self.optimizer = optimizer
        self.num_sample = num_sample
        self.threshold = threshold
        self.train_tactile = train_tactile
        self.encode_t2d = encode_t2d
        self.pretrained_t2d = pretrained_t2d
        self.mesh_bank = mesh_bank
        self.depth_origin = (None if depth_origin is None
                             else torch.as_tensor(depth_origin, device=self.device))
        self.legacy_gt_depth = legacy_gt_depth
        self.contact_per_finger = contact_per_finger
        self.tips_per_finger = tips_per_finger
        self.seed = seed
        self.skip_unused_t2d = skip_unused_t2d
        self.matmul_precision = matmul_precision
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.stage_events = None

    @classmethod
    def from_config(cls, model, cfg, mesh_bank=None, **kw):
        mcfg = cfg["model"]
        try:
            pretrained_t2d = mcfg["encoder_t2d_kwargs"]["pretrained"]
        except (KeyError, TypeError):
            pretrained_t2d = False
        depth_origin = None
        dpath = cfg["data"].get("depth_origin")
        if dpath and os.path.exists(dpath):
            depth_origin = np.loadtxt(dpath).astype(np.float32)
        tcfg = cfg["training"]
        return cls(
            model, lr=tcfg["lr"], opt=tcfg.get("opt", "Adam"),
            num_sample=cfg["data"]["num_sample"], threshold=cfg["test"]["threshold"],
            with_img=mcfg["with_img"], train_tactile=mcfg["train_tactile"],
            encode_t2d=bool(mcfg["encoder_t2d"]), pretrained_t2d=pretrained_t2d,
            mesh_bank=mesh_bank, depth_origin=depth_origin,
            **{"legacy_gt_depth": tcfg.get("legacy_gt_depth", True),
               "skip_unused_t2d": tcfg.get("skip_unused_t2d", False),
               "compute_dtype": tcfg.get("compute_dtype"),
               "remat": tcfg.get("remat", False),
               "matmul_precision": tcfg.get("matmul_precision", "default"), **kw})

    def make_fused_train_fn(self, *args, **kw):
        _not_ported("Fused multi-step training (make_fused_train_fn)")

    def make_fused_eval_fn(self, *args, **kw):
        _not_ported("Fused validation (make_fused_eval_fn)")

    def evaluate_device(self, *args, **kw):
        _not_ported("Validation on a device-resident split (evaluate_device)")

    # ------------------------------------------------------------------
    def prepare_batch(self, batch):
        """Loader batch dict → tensors on the trainer's device, with the
        samples' padded ground-truth meshes on the t2d paths (the img path
        takes the dataset's labels)."""
        def put(key, dtype=torch.float32):
            return torch.as_tensor(np.asarray(batch[key]), dtype=dtype, device=self.device)

        a = {"points": put("points"), "occ": put("points.occ"),
             "inputs": put("inputs")}
        for k in ("mano", "pc_hand", "wrist", "cam_pos", "cam_rot"):
            a[k] = put(f"points.{k}")
        a["pc_ply"] = put("inputs.pc_ply")
        a["imgs"] = put("inputs.img")
        a["depths"] = put("inputs.depth")
        a["touch_success"] = put("inputs.touch_success") > 0.5
        if "points_iou" in batch:
            a["points_iou"], a["occ_iou"] = put("points_iou"), put("points_iou.occ")
        if self.train_tactile or not self.encode_t2d:
            return a
        if self.mesh_bank is None:
            raise ValueError("the t2d loss paths need ground-truth meshes "
                             "(data.mesh_dir, a MeshBank)")
        a["mesh_verts"], a["mesh_faces"] = self.mesh_bank.gather(
            self.mesh_bank.ids_for(batch["points.name"]))
        return a

    def _depth_origin_for(self, hw):
        if self.depth_origin is not None and self.depth_origin.shape[0] == hw:
            return self.depth_origin
        return torch.full((hw,), DEPTH_REST, device=self.device)

    def _mark(self, name):
        if self.stage_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((name, ev))

    def _labelled_sample(self, a, depth_for_contact, draws, generator):
        """The contact sample of the batch and its winding-number labels."""
        H, W = a["imgs"].shape[2], a["imgs"].shape[3]
        sample = C.t2d_contact_sample(
            depth_for_contact, a["touch_success"], a["cam_pos"], a["cam_rot"],
            a["pc_ply"], a["points"], self._depth_origin_for(H * W),
            H / (2 * math.tan(math.radians(CAM_FOV / 2))), H, W, self.num_sample,
            self.contact_per_finger, generator, draws)
        return sample, winding_number_batch(a["mesh_verts"], a["mesh_faces"], sample.points)

    def _compute_loss_tactile(self, a):
        """The tactile depth-stack loss at the model's train/eval mode:
        (loss, {name: scalar})."""
        m = self.model
        self._mark("start")
        pred_depth = m.encode_img_inputs(a["imgs"])
        loss_depth = torch.mean(torch.abs(pred_depth - _minmax_norm(a["depths"])))
        loss, scalars = loss_depth, {"loss_depth": loss_depth}
        self._mark("depth_unet")
        if m.encoder_hand is not None:
            B = a["cam_pos"].shape[0]
            c_hand = m.encode_hand_inputs(a["inputs"])
            cam_info = torch.cat([a["cam_pos"].reshape(B, -1),
                                  a["cam_rot"].reshape(B, -1)], 1)
            loss_digit = torch.mean((c_hand["mano_param"] - cam_info) ** 2)
            loss = loss + loss_digit
            scalars["loss_digit"] = loss_digit
        scalars["loss"] = loss
        self._mark("pose_head")
        return loss, scalars

    def _compute_loss(self, a, draws=None, generator=None):
        """The t2d_img loss at the model's train/eval mode: (loss,
        {name: scalar}, {"c", "c_img", "depth_for_contact"})."""
        m = self.model
        B = a["points"].shape[0]
        self._mark("start")
        t2d_needed = (not self.legacy_gt_depth) or (not self.pretrained_t2d)
        pred_depth = digit_param = None
        if t2d_needed or (m.training and not self.skip_unused_t2d):
            with torch.set_grad_enabled(t2d_needed and torch.is_grad_enabled()):
                pred_depth, c_hand_d = m.encode_t2d(a["inputs"], a["imgs"])
            digit_param = c_hand_d["mano_param"]
        self._mark("t2d")
        if self.legacy_gt_depth:
            depth_for_contact = a["depths"]
        else:
            depth_for_contact = pred_depth.float() * DEPTH_SCALE + DEPTH_NEAR
        sample, occ = self._labelled_sample(a, depth_for_contact, draws,
                                            generator or self.generator)
        self._mark("contact_labels")
        c = m.encode_inputs(a["inputs"])
        c_hand = m.encode_hand_inputs(a["inputs"])
        c_img = m.encode_img_inputs(a["imgs"])
        self._mark("encoders")
        logits = m.decode_img(sample.points, c,
                              C.scatter_finger_features(c_img, sample, init="ones"))
        loss_l1 = torch.mean(torch.abs(logits - occ))
        loss_mano = torch.mean((c_hand["mano_param"] - a["mano"]) ** 2)
        loss_pc = torch.mean((c_hand["mano_verts"] - a["pc_hand"]) ** 2)
        loss = loss_l1 + loss_mano + loss_pc
        scalars = {"loss_l1": loss_l1, "loss_mano": loss_mano, "loss_pc": loss_pc}
        if not self.pretrained_t2d:
            loss_depth = torch.mean(torch.abs(pred_depth - _minmax_norm(a["depths"])))
            cam_info = torch.cat([a["cam_pos"].reshape(B, -1),
                                  a["cam_rot"].reshape(B, -1)], 1)
            loss_digit = torch.mean((digit_param - cam_info) ** 2)
            loss = loss + loss_depth + loss_digit
            scalars.update(loss_depth=loss_depth, loss_digit=loss_digit)
        scalars["loss"] = loss
        self._mark("decode")
        return loss, scalars, {"c": c, "c_img": c_img,
                               "depth_for_contact": depth_for_contact}

    def _compute_loss_img(self, a, draws=None, generator=None):
        """The img loss (VTacOH) at the model's train/eval mode: (loss,
        {name: scalar}, {"c", "c_img", "tips"})."""
        m = self.model
        self._mark("start")
        c = m.encode_inputs(a["inputs"])
        c_hand = m.encode_hand_inputs(a["inputs"])
        c_img = m.encode_img_inputs(a["imgs"])
        self._mark("encoders")
        # the tips only choose the sample: no gradient reaches them
        tips = C.tips_in_object_frame(c_hand["mano_joints"].detach(), a["mano"][:, :3],
                                      a["wrist"], a["pc_ply"])
        sample, occ = C.fingertip_gated_sample(
            a["points"], a["occ"], tips, a["touch_success"], self.num_sample,
            self.tips_per_finger, generator or self.generator, draws)
        self._mark("contact_labels")
        logits = m.decode_img(sample.points, c,
                              C.scatter_finger_features(c_img, sample, init="zeros"))
        loss_l1 = torch.mean(torch.abs(logits - occ))
        loss_mano = torch.mean((c_hand["mano_param"] - a["mano"]) ** 2)
        loss_pc = torch.mean((c_hand["mano_verts"] - a["pc_hand"]) ** 2)
        loss = loss_l1 + loss_mano + loss_pc
        scalars = {"loss": loss, "loss_l1": loss_l1, "loss_mano": loss_mano,
                   "loss_pc": loss_pc}
        self._mark("decode")
        return loss, scalars, {"c": c, "c_img": c_img, "tips": tips}

    @staticmethod
    def _host(scalars):
        vals = torch.stack([v.detach() for v in scalars.values()]).tolist()
        return dict(zip(scalars, vals))

    def train_step(self, batch, draws=None):
        """One optimization step in train mode. ``draws`` gives the decode
        sample's draws (train.contact.contact_draws' dict on the t2d path,
        tips_draws' on the img path) instead of the trainer's generator.
        The gradients stay in the parameters' .grad until the next step.
        Returns {scalar: float}."""
        a = self.prepare_batch(batch)
        self.model.train()
        with matmul_precision(self.matmul_precision):
            if self.train_tactile:
                loss, scalars = self._compute_loss_tactile(a)
            elif self.encode_t2d:
                loss, scalars, _ = self._compute_loss(a, draws)
            else:
                loss, scalars, _ = self._compute_loss_img(a, draws)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._mark("backward")
            self.optimizer.step()
            self._mark("optimizer")
        self.step += 1
        return self._host(scalars)

    @torch.no_grad()
    def eval_step(self, batch, draws=None, iou_draws=None):
        """Loss scalars and an IoU in eval mode: on the t2d path of the
        decode on a second winding-labelled contact sample (as the JAX
        package draws the loss's sample and the IoU's from different keys),
        on the img path of the decode on the whole ``points_iou`` set, each
        point's tactile feature assigned by fingertip proximity. ``iou``
        with the reference's mean threshold, ``iou_fixed`` at the value
        threshold. The draws come from a generator seeded by the trainer's
        seed and step, so one validation sees the same samples for every
        batch; ``draws`` and (t2d) ``iou_draws`` give them explicitly. On
        the tactile path: the loss scalars only."""
        a = self.prepare_batch(batch)
        self.model.eval()
        if self.train_tactile:
            with matmul_precision(self.matmul_precision):
                return self._host(self._compute_loss_tactile(a)[1])
        gen = torch.Generator(device=self.device).manual_seed(
            12345 + 1_000_003 * self.step + self.seed)
        with matmul_precision(self.matmul_precision):
            if self.encode_t2d:
                _, scalars, enc = self._compute_loss(a, draws, gen)
                sample, occ = self._labelled_sample(a, enc["depth_for_contact"],
                                                    iou_draws, gen)
                logits = self.model.decode_img(
                    sample.points, enc["c"],
                    C.scatter_finger_features(enc["c_img"], sample, init="ones"))
            else:
                _, scalars, enc = self._compute_loss_img(a, draws, gen)
                occ = a["occ_iou"]
                logits = self.model.decode_img(
                    a["points_iou"], enc["c"], C.assign_features_by_proximity(
                        a["points_iou"], enc["tips"], a["touch_success"], enc["c_img"]))
        out = self._host(scalars)
        out["iou"] = float(metrics.compute_iou(occ, logits, self.threshold)[0])
        out["iou_fixed"] = float(metrics.compute_iou(
            occ, (logits >= self.threshold).float(), 0.5,
            legacy_mean_threshold=False)[0])
        return out

    def evaluate(self, val_loader):
        """Mean of eval_step's dicts over the loader."""
        eval_list = {}
        for batch in val_loader:
            for k, v in self.eval_step(batch).items():
                eval_list.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in eval_list.items()}
