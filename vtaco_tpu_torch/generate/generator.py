"""Mesh generation: dense occupancy decode + marching cubes + metrics
(port of the per-object path of vtaco_tpu/generate/generator.py:
``from_config`` :249-314, ``_finalize_logits`` :476-490,
``_decode_dense_fast_impl`` :492-517, ``_trunk_fast`` :701-749,
``eval_points_dense`` :751, ``_prep_contact_gates`` :1597-1629,
``_build_gates`` :2175-2210 and ``generate_obj_mesh_wnf`` :2212-2293
through its full-volume branch).

The dense decode runs the decoder trunk as one CUDA kernel over all nx³
query points: K1 (``fused_trunk_gated_cn``) with contact gating, K2
(``fused_trunk_cn``) without. On CPU tensors the same wrappers run their
plain PyTorch versions.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.cuda.decode import fused_trunk_cn, fused_trunk_gated_cn
from vtaco_tpu_torch.ops.dense_decode import (
    dense_feature_volume_cn,
    dense_query_grid_cn,
)
from vtaco_tpu_torch.ops.geometry import norm_pc_1, pc_cam_to_world
from vtaco_tpu_torch.train.contact import (
    CAM_FOV,
    DEPTH_REST,
    backproject_depth,
    random_topk_select,
)

_TRANSFER = {"auto": torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16, "int8": "int8"}


class Generator3D:
    def __init__(self, model, resolution0=16, padding=0.1,
                 with_img=False, encode_t2d=False, contact_per_finger=128,
                 depth_origin=None, legacy_gt_depth=True, mc_level="midpoint",
                 transfer_dtype="auto", band_transfer="auto"):
        """``transfer_dtype``: the dtype the logits are rounded through on
        their way to the host, with the JAX package's contract ('int8' is
        scale-quantized by max|logit|/127). 'auto' resolves to float32.
        ``band_transfer``: the iso-band transfer (generate/band.py) is not
        ported; 'auto' resolves to off and true raises."""
        if isinstance(mc_level, bool) or not (
                mc_level in ("midpoint", "mean")
                or isinstance(mc_level, (int, float))):
            raise ValueError("generation.mc_level must be 'midpoint', 'mean', "
                             f"or a number; got {mc_level!r}")
        if transfer_dtype not in _TRANSFER:
            raise ValueError("generation.transfer_dtype must be one of "
                             f"{sorted(_TRANSFER)}; got {transfer_dtype!r}")
        if band_transfer not in ("auto", True, False):
            raise ValueError("generation.band_transfer must be 'auto', true, "
                             f"or false; got {band_transfer!r}")
        if band_transfer is True:
            raise NotImplementedError("band_transfer (generate/band.py) is not "
                                      "ported yet (ROADMAP.md)")
        if with_img and not encode_t2d:
            raise NotImplementedError("fingertip gating needs the hand encoder, "
                                      "which is not ported yet (ROADMAP.md)")
        if with_img and not legacy_gt_depth:
            raise NotImplementedError("legacy_gt_depth: false needs the "
                                      "tactile-to-depth model, which is not "
                                      "ported yet (ROADMAP.md)")
        self.model = model
        self.resolution0 = resolution0
        self.padding = padding
        self.with_img = with_img
        self.contact_per_finger = contact_per_finger
        self.depth_origin = depth_origin
        self.legacy_gt_depth = legacy_gt_depth
        self.mc_level = mc_level
        self.transfer_dtype = _TRANSFER[transfer_dtype]

    @classmethod
    def from_config(cls, model, cfg, **kw):
        gen = cfg["generation"]
        if cfg["data"].get("input_type") == "pointcloud_crop":
            raise NotImplementedError("crop volumes are not ported yet")
        depth_origin = None
        dpath = cfg["data"].get("depth_origin")
        if dpath and os.path.exists(dpath):
            depth_origin = np.loadtxt(dpath).astype(np.float32)
        return cls(
            model,
            resolution0=gen["resolution_0"],
            padding=cfg["data"]["padding"],
            with_img=cfg["model"]["with_img"],
            encode_t2d=bool(cfg["model"]["encoder_t2d"]),
            depth_origin=depth_origin,
            **{"mc_level": gen.get("mc_level", "midpoint"),
               "transfer_dtype": gen.get("transfer_dtype", "auto"),
               "band_transfer": gen.get("band_transfer", "auto"),
               "legacy_gt_depth": cfg["training"].get("legacy_gt_depth", True),
               **kw},
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _finalize_logits(logits, out_dtype):
        """Transfer rounding: None (f32), a torch dtype, or 'int8' →
        (int8 logits, f32 scale) with scale = max|logit|/127."""
        if out_dtype is None:
            return logits
        if out_dtype == "int8":
            scale = torch.clamp(torch.max(torch.abs(logits)), min=1e-6) / 127.0
            return torch.round(logits / scale).to(torch.int8), scale
        return logits.to(out_dtype)

    def _trunk_fast(self, tp, p_cn, feats, gate_pts, gate_feat, gate_valid,
                    gating, dtype, leaky):
        """(3, N) coords + (C, N) features → (N,) logits. K1 for contact
        gating, K2 without; the plain trunk only for leaky decoders (the
        kernels hardcode ReLU), as the JAX package routes them."""
        if gating == "tips":
            raise NotImplementedError("fingertip gating is not ported yet")
        store = dtype if dtype != torch.float32 else None
        if not leaky:
            if gating == "contact":
                return fused_trunk_gated_cn(tp, p_cn, feats, gate_pts,
                                            gate_feat, gate_valid,
                                            store_dtype=store)
            return fused_trunk_cn(tp, p_cn, feats, store_dtype=store)
        c_img = None
        if gating == "contact":
            c_img = FT.gate_contact_cn(p_cn, gate_pts, gate_feat, gate_valid)
        return FT.trunk_cn(tp, p_cn, feats, c_img, dtype=dtype, leaky=True)

    def _decode_dense_fast_impl(self, tp, c, gate_pts, gate_feat, gate_valid,
                                nx, gating, dtype, leaky, out_dtype=None):
        """Whole-grid decode; logits flattened x-slowest (the marching-cubes
        order), rounded through ``out_dtype``."""
        box_size = 1 + self.padding
        feats = dense_feature_volume_cn(c, nx, box_size, self.padding, dtype)
        p_cn = dense_query_grid_cn(nx, box_size, device=feats.device)
        logits = self._trunk_fast(tp, p_cn, feats, gate_pts, gate_feat,
                                  gate_valid, gating, dtype, leaky)
        logits = logits.reshape(nx, nx, nx).permute(2, 1, 0).reshape(-1)
        return self._finalize_logits(logits, out_dtype)

    def eval_points_dense(self, model, nx, c, gating="none", gate_pts=None,
                          gate_feat=None, gate_valid=None, dtype=torch.float32,
                          transfer_dtype=torch.bfloat16):
        """Dense nx³ decode. Returns host (nx³,) float32 logits flattened
        x-slowest, rounded through ``transfer_dtype``."""
        decoder = model.decoder
        tp = FT.extract_trunk_params(decoder, with_img=gating != "none")
        out = self._decode_dense_fast_impl(
            tp, c, gate_pts, gate_feat, gate_valid, nx, gating, dtype,
            decoder.leaky, out_dtype=transfer_dtype)
        if transfer_dtype == "int8":
            q, scale = out
            return q.cpu().numpy().astype(np.float32) * float(scale)
        return out.float().cpu().numpy()

    # ------------------------------------------------------------------
    def _prep_contact_gates(self, gt_depths, pred_depths, d_origin, touch,
                            cam_rot, cam_pos, pc_ply, H, W, seed=0,
                            contact_idx=None):
        """Per-finger contact clouds for gating: ((5, K, 3) normalized
        contact points, (5, K) validity).

        gt/pred depths (5, H*W); touch (5,); cam_rot/cam_pos (5, 3).
        ``seed`` drives the subsampling of fingers with more than K contact
        pixels (a torch.Generator; its draws differ from jax.random's);
        ``contact_idx`` (5, K) gives the chosen pixels explicitly instead."""
        dmaps = gt_depths if self.legacy_gt_depth else (
            pred_depths * 0.005 + 0.019)
        f = H / (2 * math.tan(math.radians(CAM_FOV / 2)))
        gen = torch.Generator(device=dmaps.device)
        gen.manual_seed(seed)
        rot_off = torch.tensor([-math.pi / 2, 0.0, math.pi / 2],
                               dtype=cam_rot.dtype, device=cam_rot.device)
        pts_f, val_f = [], []
        for f_idx in range(5):
            mask = (torch.abs(dmaps[f_idx] - d_origin) > 0.0001) & touch[f_idx]
            idx, valid = random_topk_select(
                mask, self.contact_per_finger, gen,
                idx=None if contact_idx is None else contact_idx[f_idx])
            cloud = backproject_depth(dmaps[f_idx].reshape(H, W), f, W, H)
            world = pc_cam_to_world(cloud[idx], cam_rot[f_idx] + rot_off,
                                    cam_pos[f_idx])
            pts_f.append(norm_pc_1(world, pc_ply))
            val_f.append(valid)
        return torch.stack(pts_f), torch.stack(val_f)

    def _build_gates(self, model, imgs, depths, touch, pc_ply, cam_pos,
                     cam_rot, seed=0):
        """Contact gates for a B=1 sample, or none without images. The
        tactile-to-depth forward is skipped: with legacy_gt_depth its
        prediction never reaches the gates."""
        if not self.with_img:
            return "none", None, None, None
        c_img = model.encode_img_inputs(imgs)                     # (1, 5, C)
        H, W = imgs.shape[2], imgs.shape[3]
        if self.depth_origin is not None and len(self.depth_origin) == H * W:
            d_origin = torch.as_tensor(self.depth_origin, device=depths.device)
        else:
            d_origin = torch.full((H * W,), DEPTH_REST, device=depths.device)
        gate_pts, gate_valid = self._prep_contact_gates(
            depths[0], None, d_origin, touch[0], cam_rot[0], cam_pos[0],
            pc_ply[0], H, W, seed=seed)
        return "contact", gate_pts, c_img[0], gate_valid

    @torch.inference_mode()
    def generate_obj_mesh_wnf(self, model, data, seed=0):
        """Dense-grid decode + marching cubes + metrics for a B=1 batch.

        ``data`` holds the JAX loader's keys and layouts (``inputs``,
        ``inputs.img`` (B, 5, H, W, 3), ``inputs.depth``,
        ``inputs.touch_success``, ``inputs.pc_ply``, ``points.*``). It runs
        on the device that holds ``model``'s parameters.
        Returns ((verts, faces), emd, chamfer)."""
        dev = next(model.parameters()).device

        def get(key, dtype=torch.float32):
            return torch.as_tensor(np.asarray(data[key]), dtype=dtype, device=dev)

        box_size = 1 + self.padding
        nx = self.resolution0 * 4
        inputs = get("inputs")
        imgs = get("inputs.img") if "inputs.img" in data else None
        depths = get("inputs.depth") if "inputs.depth" in data else None
        touch = (get("inputs.touch_success") > 0.5
                 if "inputs.touch_success" in data else None)
        points_obj = np.asarray(data["points.points_obj"])

        c = model.encode_inputs(inputs)
        gating, gate_pts, gate_feat, gate_valid = self._build_gates(
            model, imgs, depths, touch, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"), seed)
        values = self.eval_points_dense(
            model, nx, c, gating, gate_pts, gate_feat, gate_valid,
            transfer_dtype=self.transfer_dtype)
        value_grid = values.reshape(nx, nx, nx)

        level = None  # midpoint: marching_cubes' default
        if self.mc_level == "mean":
            level = float(value_grid.mean())
        elif isinstance(self.mc_level, (int, float)):
            level = float(self.mc_level)
        verts, faces = marching_cubes(value_grid, level=level, gradient="ascent")
        verts = verts - np.array([nx / 2, nx / 2, nx / 2], np.float32)
        verts = verts * box_size / nx

        vert_sample = verts.copy()
        np.random.shuffle(vert_sample)
        vert_sample = np.ascontiguousarray(vert_sample[:2048], np.float32)
        if len(vert_sample) == 0:
            # no iso-crossing (e.g. untrained weights): metrics undefined
            return (verts, faces), float("inf"), float("inf")

        cd = float(metrics.chamfer_distance(
            torch.as_tensor(points_obj, device=dev),
            torch.as_tensor(vert_sample[None], device=dev))[0])
        emd = metrics.earth_mover_distance(points_obj[0], vert_sample)
        return (verts, faces), emd, cd
