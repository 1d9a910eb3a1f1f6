"""Trainer: the train and eval steps of every loss path of the JAX
package (port of vtaco_tpu/train/trainer.py:71-860): ``t2d_img``
(VTacO), ``t2d`` (the same without images), ``img`` (VTacOH), the plain
and contact paths (``compute_loss``, ``compute_loss_contact``; the
scene_crop config), and the tactile depth-stack pretraining
(``compute_loss_tactile``).

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

Mixed precision (``compute_dtype: bfloat16``, the ``*_fast`` configs)
follows the JAX trainer's policy, not torch.autocast's per-op casts: each
top-level module that is not in ``keep_f32_modules`` (default: the
decoder) runs on bfloat16 copies of its parameters (torch.func.
functional_call on a differentiably cast parameter dict, so the gradients
reach the float32 masters); only the batch's ``inputs`` and ``imgs`` are
cast; BatchNorm reduces in float32 and keeps float32 statistics; the loss
and its scalars are float32, and so are Adam's moments. Where a bfloat16
feature meets a float32 module, which JAX does by dtype promotion and
torch's linear and convolution layers refuse, it is cast to float32 at
the call (``_call``): the object grid ``c`` and the scattered finger rows
``c_img`` entering the decoder, and (in ManoLayer) the hand encoder's
coefficients entering the MANO layer. Evaluation runs in float32, as the
JAX eval step does. ``remat`` recomputes each encoder and decoder call in
the backward pass (torch.utils.checkpoint), and the recomputation leaves
the BatchNorm statistics alone (models.layers.frozen_batch_stats).

``make_fused_train_fn`` runs K steps on batches gathered and augmented on
the device from a data.device_data.DeviceDataset, with one host read of
the K steps' scalars; ``make_fused_eval_fn`` and ``evaluate_device``
validate a device-resident split the same way.

With ``device_mesh`` (parallel.mesh.Mesh) a train step is data-parallel
and equals the one-device step on the global batch: each rank takes its
rows of the batch (parallel.mesh.batch_rows; a batch that does not divide
the data axis is replicated), draws every random sample for the global
batch and keeps its rows, and reduces over the data group whatever
couples rows: train-mode BatchNorm's statistics
(models.layers.batch_stats_group), the depth maps' min-max normalization,
the gradients (one coalesced all-reduce after the backward pass, whose
mean over ranks is the gradient of the global mean loss) and the logged
scalars. The parameters are broadcast from the first rank at
construction. Evaluation runs replicated: every rank evaluates the whole
batch, as the IoU's mean threshold couples its rows. Tensor parallelism
over the model axis is parallel.tp.shard_state's, applied to the model
after the Trainer is built.

The t2d path without images (``model.with_img`` false with a
tactile-to-depth model) is the t2d_img step with the decoder's plain head
on the contact sample. The plain path encodes the object (and, where the
model has one, the hand: its MANO losses join the loss) and decodes the
batch's own query points against their labels; with ``model.with_contact``
the decoder's contact head adds the mean sigmoid cross-entropy against
``points.contact``. Its eval step decodes the whole ``points_iou`` set. A
crop batch (``pointcloud_crop``: the loader's ``inputs.ind.<field>`` and
``points.normalized.<field>``) trains through the crop encoder's and
decoder's dict forms; its eval step raises (F6 (a), ROADMAP.md §3): the
JAX package's eval step hands the crop encoder the bare cloud there and
fails, so nothing defines the crop model's IoU.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vtaco_tpu_torch.core.precision import TF32, matmul_precision
from vtaco_tpu_torch.models.decoder import AttentionDecoder, LocalPointDecoder
from vtaco_tpu_torch.models.init import init_params
from vtaco_tpu_torch.models.layers import batch_stats_group, frozen_batch_stats
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.geometry import make_3d_grid
from vtaco_tpu_torch.ops.winding import MeshBank, winding_number_batch
from vtaco_tpu_torch.parallel.mesh import batch_rows, broadcast_module, data_group
from vtaco_tpu_torch.parallel.tp import unsharded
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.utils import profiling

DEPTH_NEAR = 0.019
DEPTH_FAR = 0.022
DEPTH_REST = 0.0215
# predicted-depth denormalization slope (wider than DEPTH_FAR - DEPTH_NEAR,
# as in the reference)
DEPTH_SCALE = 0.005
CAM_FOV = 60.0
# the model method → the top-level module whose parameters it runs
METHOD_MODULE = {"encode_inputs": "encoder", "encode_hand_inputs": "encoder_hand",
                 "encode_img_inputs": "encoder_img", "encode_t2d": "encoder_t2d",
                 "decode": "decoder", "decode_img": "decoder",
                 "decode_contact": "decoder"}


def check_trainer_init(model):
    """Raise where the JAX package's Trainer cannot initialize ``model``,
    which its train and generate CLIs do first: the initialization traces
    ``decode_img`` for every decoder (vtaco_tpu/train/trainer.py:261), and
    the point decoder of ``simple_local_point`` has no tactile head (F8
    (d), ROADMAP.md §3), and the attention decoder with c_dim 0 cannot fuse
    (F9 (b)). The Trainer's steps and the Generator stay open
    to such a model, as the JAX package's do on weights from ``init``."""
    if isinstance(model.decoder, AttentionDecoder) and model.decoder.fuser is None:
        raise NotImplementedError(
            "training or serving attention_local with c_dim 0 from the CLIs: the JAX "
            "package's Trainer initializes through decode_img, whose fusion of a "
            "0-channel field fails with a ZeroDivisionError at "
            "vtaco_tpu/train/trainer.py:261 (F9 (b), ROADMAP.md §3)")
    if isinstance(model.decoder, LocalPointDecoder):
        raise NotImplementedError(
            "training or serving simple_local_point from the CLIs: the JAX "
            "package's Trainer initializes through decode_img, which the point "
            "decoder lacks, and fails at vtaco_tpu/train/trainer.py:261 (F8 (d), "
            "ROADMAP.md §3)")


# the eval sample's base seed (the JAX package folds PRNGKey(12345))
EVAL_SEED = 12345
# batch keys of a device-resident sample (data.device_data) → the step's keys
DEVICE_KEYS = {"points": "points", "occ": "points.occ", "pc_hand": "points.pc_hand",
               "mano": "points.mano", "wrist": "points.wrist",
               "cam_pos": "points.cam_pos", "cam_rot": "points.cam_rot",
               "inputs": "inputs", "pc_ply": "inputs.pc_ply", "imgs": "inputs.img",
               "depths": "inputs.depth", "touch_success": "inputs.touch_success"}


@contextlib.contextmanager
def cpu_reduced_precision_convs(active):
    """Turn oneDNN off for the block when ``active``: on the CPU its
    bfloat16 convolution (PyTorch 2.13) leaves the weight gradient of the
    kernel taps that see only padding uninitialized when a stride-2 conv
    meets a 1x1 input (ResNet-18's last stage on small images), and the
    step then trains on garbage. The fallback is exact and slower; float32
    steps and the card are unaffected."""
    old = torch.backends.mkldnn.enabled
    if active:
        torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = old


def _minmax_norm(x, group=None):
    """x scaled by its min and max, those of the whole batch across
    ``group``'s ranks when it is set."""
    lo, hi = torch.min(x), torch.max(x)
    if group is not None:
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return (x - lo) / (hi - lo)


def _cast_floats(x, dtype):
    """Floating tensors of x (a tensor, or a dict, list or tuple of them)
    cast to dtype; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _cast_floats(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_floats(v, dtype) for v in x)
    return x


def _remat_contexts():
    """torch.utils.checkpoint's (forward, recomputation) contexts: the
    recomputation leaves the BatchNorm statistics alone."""
    return contextlib.nullcontext(), frozen_batch_stats()


class _Bound(nn.Module):
    """Runs one of the model's methods, for torch.func.functional_call to
    swap the model's parameters under it."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, method, *args):
        return getattr(self.model, method)(*args)


class Trainer:
    """Runs the train and eval steps on the device of ``model``'s
    parameters. ``stage_events``, when set to a list, collects
    (stage name, recorded torch.cuda.Event) pairs at the step's stage
    boundaries. Train and eval steps run at ``matmul_precision``."""

    def __init__(self, model, optimizer=None, *, lr=1e-4, opt="Adam",
                 num_sample=2048, threshold=0.5, with_img=False, with_contact=False,
                 train_tactile=False, encode_t2d=False, pretrained_t2d=True,
                 mesh_bank: Optional[MeshBank] = None,
                 depth_origin: Optional[np.ndarray] = None, legacy_gt_depth=True,
                 contact_per_finger=128, tips_per_finger=512, seed=0,
                 skip_unused_t2d=False, compute_dtype=None, keep_f32_modules=("decoder",),
                 remat=False, matmul_precision="default", device_mesh=None):
        if matmul_precision not in TF32:
            raise ValueError(f"training.matmul_precision {matmul_precision!r} is "
                             f"none of {sorted(TF32)}")
        if compute_dtype is not None:
            if not isinstance(compute_dtype, str):
                compute_dtype = str(compute_dtype).replace("torch.", "")
            dt = getattr(torch, compute_dtype, None)
            if not (isinstance(dt, torch.dtype) and dt.is_floating_point):
                raise ValueError(f"training.compute_dtype {compute_dtype!r} is not a "
                                 "floating dtype")
        self.compute_dtype = compute_dtype
        if isinstance(keep_f32_modules, str):
            # a bare string would tuple() into characters and silently
            # drop the float32 decoder
            keep_f32_modules = (keep_f32_modules,)
        self.keep_f32_modules = tuple(keep_f32_modules or ())
        self.remat = bool(remat)
        self.model = model
        self.device = next(model.parameters()).device
        if optimizer is None:
            params = model.parameters()
            optimizer = (torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
                         if opt == "Adam" else torch.optim.SGD(params, lr=lr, momentum=0.9))
        self.optimizer = optimizer
        self.num_sample = num_sample
        self.threshold = threshold
        self.with_img = with_img
        self.with_contact = with_contact
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
        self._stage = None    # the open stage's span (_mark)
        self._bound = _Bound(model)
        self._params = None   # the train step's cast parameters by module (mixed precision)
        self.mesh = device_mesh
        self._rows = self._group = None   # a data-parallel train step's rows and group
        if device_mesh is not None:
            broadcast_module(model, device_mesh)

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
            with_img=mcfg["with_img"], with_contact=mcfg["with_contact"],
            train_tactile=mcfg["train_tactile"],
            encode_t2d=bool(mcfg["encoder_t2d"]), pretrained_t2d=pretrained_t2d,
            mesh_bank=mesh_bank, depth_origin=depth_origin,
            **{"legacy_gt_depth": tcfg.get("legacy_gt_depth", True),
               "skip_unused_t2d": tcfg.get("skip_unused_t2d", False),
               "compute_dtype": tcfg.get("compute_dtype"),
               "keep_f32_modules": tcfg.get("keep_f32_modules", ("decoder",)),
               "remat": tcfg.get("remat", False),
               "matmul_precision": tcfg.get("matmul_precision", "default"), **kw})

    def init_state(self, batch=None, rng=None):
        """Start training afresh, as the JAX Trainer's init_state
        (vtaco_tpu/train/trainer.py:267) does: every parameter drawn again
        as get_model draws it (models/init.py) from ``rng`` (a seed, or a
        torch.Generator on the trainer's device; default the trainer's
        seed), BatchNorm's running statistics, the optimizer's moments,
        the step and the sample generator reset. ``batch`` is accepted and
        unused: flax traced it for the parameters' shapes. Under a mesh
        every rank calls it, and the first rank's draws are broadcast.
        Returns the model."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=self.device).manual_seed(
                self.seed if rng is None else int(rng))
        with unsharded(self.model, self.optimizer):
            init_params(self.model, rng)
            if self.mesh is not None:
                broadcast_module(self.model, self.mesh)
        self.optimizer.state.clear()
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0
        return self.model

    # ------------------------------------------------------------------
    def prepare_batch(self, batch, shard=True):
        """Loader batch dict → tensors on the trainer's device, with the
        samples' padded ground-truth meshes on the t2d paths (the other
        paths take the dataset's labels). A crop batch adds
        ``inputs_index`` ({field: (B, N) int64}) and ``points_normalized``
        ({field: (B, N, 2|3)}). Under a mesh with ``shard``, this rank's
        rows, and ``rows`` (parallel.mesh.Rows) says which. The span
        ``trainer.upload``."""
        with profiling.span("trainer.upload"):
            rows = (batch_rows(len(batch["points"]), self.mesh)
                    if self.mesh is not None and shard else None)

            def put(key, dtype=torch.float32):
                v = batch[key]   # a host array, or a tensor (a device-resident batch)
                v = v if isinstance(v, torch.Tensor) else np.asarray(v)
                if rows is not None:
                    v = rows.take(v)
                return torch.as_tensor(v, dtype=dtype, device=self.device)

            a = {"points": put("points"), "occ": put("points.occ"),
                 "inputs": put("inputs")}
            if "points.mano" in batch:
                for k in ("mano", "pc_hand", "wrist", "cam_pos", "cam_rot"):
                    a[k] = put(f"points.{k}")
            if "points.contact" in batch:
                a["contact"] = put("points.contact")
            if "inputs.pc_ply" in batch:
                a["pc_ply"] = put("inputs.pc_ply")
            if "inputs.img" in batch:
                a["imgs"] = put("inputs.img")
                a["depths"] = put("inputs.depth")
                a["touch_success"] = put("inputs.touch_success") > 0.5
            if "points_iou" in batch:
                a["points_iou"], a["occ_iou"] = put("points_iou"), put("points_iou.occ")
            if "voxels" in batch:
                a["voxels"] = put("voxels")
            ind = {k.split(".")[-1]: put(k, torch.int64)[:, 0]
                   for k in batch if k.startswith("inputs.ind.")}
            if ind:
                a["inputs_index"] = ind
            normalized = {k.split(".")[-1]: put(k)
                          for k in batch if k.startswith("points.normalized.")}
            if normalized:
                a["points_normalized"] = normalized
            if rows is not None:
                a["rows"] = rows
            if self.train_tactile or not self.encode_t2d:
                return a
            if self.mesh_bank is None:
                raise ValueError("the t2d loss paths need ground-truth meshes "
                                 "(data.mesh_dir, a MeshBank)")
            names = batch["points.name"]
            a["mesh_verts"], a["mesh_faces"] = self.mesh_bank.gather(
                self.mesh_bank.ids_for(names if rows is None else rows.take(names)))
            return a

    def _depth_origin_for(self, hw):
        if self.depth_origin is not None and self.depth_origin.shape[0] == hw:
            return self.depth_origin
        return torch.full((hw,), DEPTH_REST, device=self.device)

    # ------------------------------------------------------------------
    # mixed precision and rematerialization
    def _cast_params(self, params):
        """Selective mixed precision on a {name: tensor} dict of parameters
        (dotted names): with compute_dtype, each floating entry of a
        top-level module not in keep_f32_modules is cast to it
        (differentiably, so that gradients reach the float32 masters), the
        others are kept; without it, params as they are."""
        if self.compute_dtype is None:
            return params
        dt = getattr(torch, self.compute_dtype)
        return {k: (v if k.split(".")[0] in self.keep_f32_modules
                    or not v.is_floating_point() else v.to(dt))
                for k, v in params.items()}

    def _cast_batch(self, a):
        """Mixed precision casts only the networks' input tensors, the
        point cloud and the images; the geometry and label paths (depths,
        camera poses, query points, winding labels) stay float32."""
        if self.compute_dtype is None:
            return a
        dt = getattr(torch, self.compute_dtype)
        return {k: (_cast_floats(v, dt) if k in ("inputs", "imgs") else v)
                for k, v in a.items()}

    @staticmethod
    def _module_params(params):
        """{name: tensor} → {top-level module: {"model." + name: tensor}},
        the dicts that functional_call swaps in for each module's calls."""
        out = {}
        for k, v in params.items():
            out.setdefault(k.split(".")[0], {})["model." + k] = v
        return out

    def _call(self, method, *args):
        """The model's ``method`` (METHOD_MODULE) on args. In a train step
        with compute_dtype, a module kept in float32 takes its floating
        arguments in float32 (the cast where bfloat16 features enter the
        decoder), any other module runs on the step's cast parameters with
        its floating arguments in compute_dtype. With ``remat`` in train
        mode the call is recomputed in the backward pass, its parameters
        passed along so that the recomputation sees the same ones."""
        module = METHOD_MODULE[method]
        params = self._params
        if params is not None:
            if module in self.keep_f32_modules:
                args, params = _cast_floats(args, torch.float32), None
            else:
                args = _cast_floats(args, getattr(torch, self.compute_dtype))
                params = params.get(module, {})
        if self.remat and self.model.training and torch.is_grad_enabled():
            return checkpoint(self._run, method, params, *args, use_reentrant=False,
                              context_fn=_remat_contexts)
        return self._run(method, params, *args)

    def _run(self, method, params, *args):
        if params is None:
            return getattr(self.model, method)(*args)
        return torch.func.functional_call(self._bound, params, (method,) + args,
                                          strict=False)

    def _mark(self, name=None, then=None):
        """A stage boundary of a step: the stage ``name`` ends here (its
        recorded CUDA event joins ``stage_events`` when that is a list) and
        the stage ``then`` begins. The open stage's span closes, and
        ``then`` opens the span ``trainer.<then>``; ``_mark()`` closes the
        open stage alone."""
        if name is not None and self.stage_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((name, ev))
        if self._stage is not None:
            self._stage.__exit__(None, None, None)
            self._stage = None
        if then is not None:
            self._stage = profiling.span("trainer." + then)
            self._stage.__enter__()

    def _labelled_sample(self, a, depth_for_contact, draws, generator):
        """The contact sample of the batch and its winding-number labels."""
        H, W = a["imgs"].shape[2], a["imgs"].shape[3]
        sample = C.t2d_contact_sample(
            depth_for_contact, a["touch_success"], a["cam_pos"], a["cam_rot"],
            a["pc_ply"], a["points"], self._depth_origin_for(H * W),
            H / (2 * math.tan(math.radians(CAM_FOV / 2))), H, W, self.num_sample,
            self.contact_per_finger, generator, draws, self._rows)
        return sample, winding_number_batch(a["mesh_verts"], a["mesh_faces"], sample.points)

    def _compute_loss_tactile(self, a):
        """The tactile depth-stack loss at the model's train/eval mode:
        (loss, {name: scalar})."""
        m = self.model
        self._mark("start", then="depth_unet")
        pred_depth = self._call("encode_img_inputs", a["imgs"])
        loss_depth = torch.mean(torch.abs(pred_depth - _minmax_norm(a["depths"],
                                                                    self._group)))
        loss, scalars = loss_depth, {"loss_depth": loss_depth}
        self._mark("depth_unet", then="pose_head")
        if m.encoder_hand is not None:
            B = a["cam_pos"].shape[0]
            c_hand = self._call("encode_hand_inputs", a["inputs"])
            cam_info = torch.cat([a["cam_pos"].reshape(B, -1),
                                  a["cam_rot"].reshape(B, -1)], 1)
            loss_digit = torch.mean((c_hand["mano_param"] - cam_info) ** 2)
            loss = loss + loss_digit
            scalars["loss_digit"] = loss_digit
        scalars["loss"] = loss
        self._mark("pose_head")
        return loss, scalars

    def _compute_loss(self, a, draws=None, generator=None):
        """The t2d_img loss (without images: the t2d loss) at the model's
        train/eval mode: (loss, {name: scalar}, {"c", "c_img",
        "depth_for_contact"}); c_img is None without images."""
        m = self.model
        B = a["points"].shape[0]
        self._mark("start", then="t2d")
        t2d_needed = (not self.legacy_gt_depth) or (not self.pretrained_t2d)
        pred_depth = digit_param = None
        if t2d_needed or (m.training and not self.skip_unused_t2d):
            with torch.set_grad_enabled(t2d_needed and torch.is_grad_enabled()):
                pred_depth, c_hand_d = self._call("encode_t2d", a["inputs"], a["imgs"])
            digit_param = c_hand_d["mano_param"]
        self._mark("t2d", then="contact_labels")
        if self.legacy_gt_depth:
            depth_for_contact = a["depths"]
        else:
            depth_for_contact = pred_depth.float() * DEPTH_SCALE + DEPTH_NEAR
        sample, occ = self._labelled_sample(a, depth_for_contact, draws,
                                            generator or self.generator)
        self._mark("contact_labels", then="encoders")
        c = self._call("encode_inputs", a["inputs"])
        c_hand = self._call("encode_hand_inputs", a["inputs"])
        c_img = self._call("encode_img_inputs", a["imgs"]) if self.with_img else None
        self._mark("encoders", then="decode")
        logits = self._decode_sample(sample, c, c_img)
        loss_l1 = torch.mean(torch.abs(logits - occ))
        loss_mano = torch.mean((c_hand["mano_param"] - a["mano"]) ** 2)
        loss_pc = torch.mean((c_hand["mano_verts"] - a["pc_hand"]) ** 2)
        loss = loss_l1 + loss_mano + loss_pc
        scalars = {"loss_l1": loss_l1, "loss_mano": loss_mano, "loss_pc": loss_pc}
        if not self.pretrained_t2d:
            loss_depth = torch.mean(torch.abs(pred_depth - _minmax_norm(a["depths"],
                                                                        self._group)))
            cam_info = torch.cat([a["cam_pos"].reshape(B, -1),
                                  a["cam_rot"].reshape(B, -1)], 1)
            loss_digit = torch.mean((digit_param - cam_info) ** 2)
            loss = loss + loss_depth + loss_digit
            scalars.update(loss_depth=loss_depth, loss_digit=loss_digit)
        scalars["loss"] = loss
        self._mark("decode")
        return loss, scalars, {"c": c, "c_img": c_img,
                               "depth_for_contact": depth_for_contact}

    def _decode_sample(self, sample, c, c_img):
        """The decoder on a t2d contact sample: with images each point
        takes its finger's tactile feature (ones elsewhere), without them
        the plain head."""
        if c_img is None:
            return self._call("decode", sample.points, c)
        return self._call("decode_img", sample.points, c,
                          C.scatter_finger_features(c_img, sample, init="ones"))

    def _compute_loss_plain(self, a):
        """The plain loss (with ``with_contact``, the contact loss) at the
        model's train/eval mode, crop batches in the crop modules' dict
        forms: (loss, {name: scalar})."""
        m = self.model
        self._mark("start", then="encoders")
        enc_in, p_in = a["inputs"], a["points"]
        if "inputs_index" in a:
            enc_in = {"points": a["inputs"], "index": a["inputs_index"]}
        if "points_normalized" in a:
            p_in = {"p": a["points"], "p_n": a["points_normalized"]}
        c = self._call("encode_inputs", enc_in)
        c_hand = (self._call("encode_hand_inputs", a["inputs"])
                  if m.encoder_hand is not None else None)
        self._mark("encoders", then="decode")
        scalars = {}
        if self.with_contact:
            logits, pred_contact = self._call("decode_contact", p_in, c)
            loss_contact = F.binary_cross_entropy_with_logits(
                pred_contact.float(), a["contact"])
            scalars["loss_contact"] = loss_contact
        else:
            logits = self._call("decode", p_in, c)
            loss_contact = 0.0
        loss_l1 = torch.mean(torch.abs(logits - a["occ"]))
        if c_hand is not None:
            loss_mano = torch.mean((c_hand["mano_param"] - a["mano"]) ** 2)
            loss_pc = torch.mean((c_hand["mano_verts"] - a["pc_hand"]) ** 2)
        else:
            loss_mano = loss_pc = loss_l1.new_zeros(())
        loss = loss_l1 + loss_mano + loss_pc + loss_contact
        scalars.update(loss=loss, loss_l1=loss_l1, loss_mano=loss_mano, loss_pc=loss_pc)
        self._mark("decode")
        return loss, scalars

    def _compute_loss_img(self, a, draws=None, generator=None):
        """The img loss (VTacOH) at the model's train/eval mode: (loss,
        {name: scalar}, {"c", "c_img", "tips"})."""
        self._mark("start", then="encoders")
        c = self._call("encode_inputs", a["inputs"])
        c_hand = self._call("encode_hand_inputs", a["inputs"])
        c_img = self._call("encode_img_inputs", a["imgs"])
        self._mark("encoders", then="contact_labels")
        # the tips only choose the sample: no gradient reaches them
        tips = C.tips_in_object_frame(c_hand["mano_joints"].detach(), a["mano"][:, :3],
                                      a["wrist"], a["pc_ply"])
        sample, occ = C.fingertip_gated_sample(
            a["points"], a["occ"], tips, a["touch_success"], self.num_sample,
            self.tips_per_finger, generator or self.generator, draws, self._rows)
        self._mark("contact_labels", then="decode")
        logits = self._call("decode_img", sample.points, c,
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
        """{name: 0-d tensor} → {name: float}, in one read from the device
        (the span ``trainer.read``)."""
        with profiling.span("trainer.read"):
            vals = torch.stack([v.detach().float() for v in scalars.values()]).tolist()
        return dict(zip(scalars, vals))

    def _train_step(self, a, draws=None):
        """One optimization step on prepared tensors (prepare_batch's dict,
        or a device-resident batch's): {scalar: 0-d float32 tensor} on the
        device, read by nobody here, so that steps can follow each other
        without a host sync. On a rank's rows of a data-parallel batch
        (``a["rows"]``) ``draws`` are the global batch's."""
        self.model.train()
        rows = a.get("rows")
        group = data_group(self.mesh) if rows is not None and not rows.replicated else None
        if group is not None and draws is not None:
            draws = {k: rows.draw(v) for k, v in draws.items()}
        with matmul_precision(self.matmul_precision), cpu_reduced_precision_convs(
                self.compute_dtype is not None and self.device.type == "cpu"), \
                batch_stats_group(self.model, group):
            a = self._cast_batch(a)
            if self.compute_dtype is not None:
                self._params = self._module_params(
                    self._cast_params(dict(self.model.named_parameters())))
            if group is not None:
                self._rows, self._group = rows, group
            try:
                if self.train_tactile:
                    loss, scalars = self._compute_loss_tactile(a)
                elif self.encode_t2d:
                    loss, scalars, _ = self._compute_loss(a, draws)
                elif self.with_img:
                    loss, scalars, _ = self._compute_loss_img(a, draws)
                else:
                    loss, scalars = self._compute_loss_plain(a)
            finally:
                self._params = self._rows = self._group = None
                self._mark()    # a stage span that an exception left open
            try:
                self._mark(then="backward")
                self.optimizer.zero_grad(set_to_none=True)
                loss.float().backward()
                if group is not None:
                    self._all_reduce_grads(group)
                self._mark("backward", then="optimizer")
                self.optimizer.step()
                self._mark("optimizer")
            finally:
                self._mark()
        self.step += 1
        scalars = {k: v.detach().float() for k, v in scalars.items()}
        if group is not None:
            vals = torch.stack(list(scalars.values()))
            dist.all_reduce(vals, group=group)
            scalars = dict(zip(scalars, vals / dist.get_world_size(group)))
        return scalars

    def _all_reduce_grads(self, group):
        """The gradients averaged over the data group, in one all-reduce
        (and one multi-tensor copy back: a copy per parameter cost a
        launch each on a host-bound step)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))

    def train_step(self, batch, draws=None):
        """One optimization step in train mode. ``draws`` gives the decode
        sample's draws (train.contact.contact_draws' dict on the t2d path,
        tips_draws' on the img path) instead of the trainer's generator.
        The gradients stay in the parameters' .grad until the next step.
        Returns {scalar: float}."""
        return self._host(self._train_step(self.prepare_batch(batch), draws))

    @torch.no_grad()
    def _eval_step(self, a, draws=None, iou_draws=None, generator=None):
        """eval_step on prepared tensors: {scalar: 0-d tensor} on the
        device."""
        self.model.eval()
        with matmul_precision(self.matmul_precision):
            if self.train_tactile:
                return self._compute_loss_tactile(a)[1]
            if self.encode_t2d:
                _, scalars, enc = self._compute_loss(a, draws, generator)
                sample, occ = self._labelled_sample(a, enc["depth_for_contact"],
                                                    iou_draws, generator)
                c = enc["c"]
                logits = self._decode_sample(sample, c, enc["c_img"])
            elif not self.with_img:
                if "inputs_index" in a:
                    raise NotImplementedError(
                        "the eval step on a crop batch (pointcloud_crop): the JAX "
                        "package's IoU hands the crop encoder the bare cloud and "
                        "fails (F6 (a), ROADMAP.md §3)")
                _, scalars = self._compute_loss_plain(a)
                occ = a["occ_iou"]
                c = self._call("encode_inputs", a["inputs"])
                logits = self._call("decode", a["points_iou"], c)
            else:
                _, scalars, enc = self._compute_loss_img(a, draws, generator)
                occ, c = a["occ_iou"], enc["c"]
                logits = self._call(
                    "decode_img", a["points_iou"], c, C.assign_features_by_proximity(
                        a["points_iou"], enc["tips"], a["touch_success"], enc["c_img"]))
            out = dict(scalars)
            out["iou"] = metrics.compute_iou(occ, logits, self.threshold)[0]
            out["iou_fixed"] = metrics.compute_iou(
                occ, (logits >= self.threshold).float(), 0.5,
                legacy_mean_threshold=False)[0]
            if "voxels" in a and self.model.encoder is not None:
                out["iou_voxels"] = self._iou_voxels(a["voxels"], c)
        return out

    def _iou_voxels(self, vox, c):
        """The mean fixed-threshold IoU of the voxel grids (B, r, r, r)
        against sigmoid(logit) >= threshold at the grid's cell centres in
        the box [-0.5 + 1/64, 0.5 - 1/64]³."""
        B = vox.shape[0]
        pts = make_3d_grid((-0.5 + 1 / 64,) * 3, (0.5 - 1 / 64,) * 3, vox.shape[1:])
        pts = torch.as_tensor(pts, device=vox.device)[None].expand(B, -1, -1)
        logits = self._call("decode", pts, c)
        return torch.mean(metrics.compute_iou(
            (vox.reshape(B, -1) >= 0.5).float(),
            (torch.sigmoid(logits) >= self.threshold).float(), 0.5,
            legacy_mean_threshold=False))

    def eval_step(self, batch, draws=None, iou_draws=None, generator=None):
        """Loss scalars and an IoU in eval mode: on the t2d paths of the
        decode on a second winding-labelled contact sample (as the JAX
        package draws the loss's sample and the IoU's from different keys),
        on the img path of the decode on the whole ``points_iou`` set, each
        point's tactile feature assigned by fingertip proximity, on the
        plain and contact paths of the plain decode on ``points_iou``
        (a crop batch raises, F6 (a)). ``iou``
        with the reference's mean threshold, ``iou_fixed`` at the value
        threshold. The draws come from ``generator``, by default one seeded
        by the trainer's seed and step, so one validation sees the same
        samples for every batch; ``draws`` and (t2d) ``iou_draws`` give them
        explicitly. A batch with voxel grids (``data.voxels_file``) adds
        ``iou_voxels`` (_iou_voxels) on the object encoder's features. On
        the tactile path: the loss scalars only. Evaluation runs in float32
        whatever compute_dtype is, as in the JAX package."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                EVAL_SEED + 1_000_003 * self.step + self.seed)
        return self._host(self._eval_step(self.prepare_batch(batch, shard=False), draws,
                                          iou_draws, generator))

    def evaluate(self, val_loader):
        """Mean of eval_step's dicts over the loader."""
        eval_list = {}
        for batch in val_loader:
            for k, v in self.eval_step(batch).items():
                eval_list.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in eval_list.items()}

    # ------------------------------------------------------------------
    # device-resident data: K steps per call, whole-split validation
    def _device_batch_assembler(self, dds, n_points, n_cloud, for_eval=False):
        """(ids (B,) on the device, generator, draws) → the step's tensors:
        a DeviceDataset sample under the step's keys, the ground-truth
        meshes by a lookup on the device (the t2d path), and for eval the
        models' whole query sets as ``points_iou``. Under a mesh a train
        batch is this rank's rows (``rows``) of the global batch ``ids``;
        an eval batch is replicated."""
        bank_ids = None
        if self.encode_t2d and not self.train_tactile:
            if self.mesh_bank is None:
                raise ValueError("the t2d loss paths need ground-truth meshes "
                                 "(data.mesh_dir, a MeshBank)")
            bank_ids = torch.as_tensor(self.mesh_bank.ids_for(dds.names), device=self.device)

        def assemble(ids, generator, draws=None):
            rows = (batch_rows(len(ids), self.mesh)
                    if self.mesh is not None and not for_eval else None)
            batch = dds._sample(ids, n_points, n_cloud, generator, draws, rows)
            a = {k: batch[src] for k, src in DEVICE_KEYS.items()}
            if rows is not None:
                a["rows"], ids = rows, rows.take(ids)
            if for_eval:
                a["points_iou"], a["occ_iou"] = dds.data["points"][ids], dds.data["occ"][ids]
            if bank_ids is not None:
                a["mesh_verts"], a["mesh_faces"] = self.mesh_bank.gather(bank_ids[ids])
            return a

        return assemble

    def _upload_ids(self, ids):
        """Host ids → an int64 tensor on the trainer's device, copied without
        waiting for the card (pinned memory)."""
        ids = torch.as_tensor(np.asarray(ids, np.int64))
        if self.device.type == "cuda":
            return ids.pin_memory().to(self.device, non_blocking=True)
        return ids.to(self.device)

    @staticmethod
    def _stack(outs):
        """[{name: 0-d tensor}] → {name: (len(outs),) float32 tensor}, on the
        device."""
        return {k: torch.stack([o[k].float() for o in outs]) for k in outs[0]}

    @staticmethod
    def read_scalars(stacked):
        """A fused function's {name: (K,) tensor} → {name: (K,) numpy
        array}, in one read from the device."""
        names = list(stacked)
        vals = torch.stack([stacked[k] for k in names]).cpu().numpy()
        return {k: vals[i] for i, k in enumerate(names)}

    def make_fused_train_fn(self, device_dataset, n_points, n_cloud):
        """K optimization steps per call on a device-resident dataset
        (data.device_data.DeviceDataset). Returns ``fn(ids, generator=None,
        draws=None) -> {scalar: (K,) tensor}``: ``ids`` (K, B) model
        ids; step j gathers and augments its batch of ids[j] on the device
        (query and cloud subsampling, cloud and image noise, from
        ``generator``, default the trainer's) and runs the train step on
        it, its decode sample drawn from the trainer's generator. Nothing
        in the K steps reads the device from the host, and neither does
        the function: it returns the scalars stacked on the device, for the
        caller's one read_scalars after the block. Same losses as K
        train_step calls with the same batches and draws;
        ``draws`` (a list of K dicts {"sample": DeviceDataset._sample's
        draws, "step": train_step's}) gives them explicitly."""
        assemble = self._device_batch_assembler(device_dataset, n_points, n_cloud)

        def run(ids, generator=None, draws=None):
            ids = self._upload_ids(ids)
            gen = self.generator if generator is None else generator
            outs = []
            for j in range(ids.shape[0]):
                d = draws[j] if draws is not None else {}
                outs.append(self._train_step(assemble(ids[j], gen, d.get("sample")),
                                             d.get("step")))
            return self._stack(outs)

        return run

    def _eval_generator(self, model_id):
        """The eval draws of one model of a device-resident split: seeded
        from EVAL_SEED and the model's id alone, so every validation of the
        same weights sees the same samples."""
        return torch.Generator(device=self.device).manual_seed(
            EVAL_SEED + 1_000_003 * (int(model_id) + 1))

    def make_fused_eval_fn(self, device_dataset, n_points, n_cloud):
        """Whole-split validation on a device-resident split. Returns
        ``fn(ids (M, 1)) -> {metric: (M,) tensor}``: eval_step on each
        model alone (B = 1, as the host loader's validation), its batch
        assembled on the device and every draw from _eval_generator(id);
        the metrics stay on the device, for one read_scalars after the last
        model."""
        assemble = self._device_batch_assembler(device_dataset, n_points, n_cloud,
                                                for_eval=True)

        def run(ids):
            host = np.asarray(ids).reshape(-1)
            dev_ids = self._upload_ids(host)
            outs = []
            for j, i in enumerate(host):
                g = self._eval_generator(i)
                outs.append(self._eval_step(assemble(dev_ids[j:j + 1], g), generator=g))
            return self._stack(outs)

        return run

    def evaluate_device(self, eval_fn, n_models):
        """evaluate() over a device-resident split through a
        make_fused_eval_fn function: the mean of the per-model metrics."""
        out = self.read_scalars(eval_fn(np.arange(n_models)[:, None]))
        return {k: float(np.mean(v)) for k, v in out.items()}
