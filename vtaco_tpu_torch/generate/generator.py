"""Mesh generation and occupancy decode (port of
vtaco_tpu/generate/generator.py: ``from_config`` :249-314, the chunked
module decode ``_decode_chunk_impl`` :380 and ``_gate_chunk`` :415,
``_finalize_logits`` :476-490, ``_decode_dense_fast_impl`` :492-517,
``_decode_scatter_fast_impl`` :601-635, ``_decode_scatter_window_impl``
:637-699, ``_trunk_fast`` :701-749, ``eval_points_dense`` :751, query-set
detection :1003-1137, ``eval_points_fast`` :1139-1286, window planning
:1288-1478, ``eval_points`` :1480-1593, ``_prep_contact_gates``
:1597-1629, ``_build_gates`` :2175-2210, ``generate_obj_mesh_wnf``
:2212-2293 through its full-volume branch, the batched decodes
``decode_dense_batched`` :1704-1794 and ``decode_points_batched``
:1915-2120 through its fast path, the iso-band transfer
``_band_enabled`` :812-827, ``eval_points_dense_band`` :829-922,
``decode_dense_batched_band`` and ``finish_batched_band`` :1797-1912 and
``_obj_mesh_band`` :2123-2175, ``generate_obj_mesh_mise`` :2296-2371,
``generate_hand_mesh`` :2374-2405, ``generate_tactile_pc`` :2408-2450,
``LoopGenerator`` and ``make_loop_generator`` :2453-2512).

The tactile gates come in two kinds, as in the JAX package: contact
gating (VTacO: contact points back-projected from the ground-truth or the
predicted depth maps) and fingertip gating (VTacOH: the MANO fingertips
moved into the object frame; ``gate_tips_cn`` turns them into per-point
c_img rows in plain PyTorch, outside the kernels). The dense decode runs
the decoder trunk as one CUDA kernel over all nx³ query points: K1
(``fused_trunk_gated_cn``) with contact gating, K2 (``fused_trunk_cn``)
without, or with the fingertip rows. ``eval_points`` routes an arbitrary
query set as the JAX package does with its Pallas kernels on: a complete
cube to the dense decode, a lattice to the corner gather + K1/K2, any
other set to the sorted window route, whose kernel
(``fused_trunk_window_cn``: K3, with the fingertip rows or none, or K4
with contact gating) interpolates and decodes in one pass. On CPU tensors
the same wrappers run their plain PyTorch versions. Plane feature
fields take the same routes but the window route (as in the JAX package,
whose window kernel reads the grid only): their features are summed into
the (C, N) features that K1 and K2 read.

``eval_points(fast=False)`` is the JAX package's legacy decode: the
decoder module on chunks of ``points_batch_size`` points (the last one
padded), gated per chunk (``_gate_chunk``, the direct distances); above
one chunk every chunk is decoded on the device before one transfer. A
decoder the fast trunk cannot reproduce (anything but LocalDecoder)
takes it for every decode, and crop models (``pointcloud_crop``) always
do: their queries are normalized into the whole scene's input volume
(``vol_info``) per chunk and decoded by the crop decoder, ungated.

The batched decodes serve B objects at once, ungated, as the JAX package
runs K2 under ``vmap``: one ``fused_trunk_cn_batched`` launch covers every
object's points (the dense grid shared by all, or each object's own
points with its corner-gathered features). ``generate_obj_mesh_mise``
refines a coarse dense decode where the surface passes
(generate/mise.py).

With ``band_transfer`` true the dense decodes ship the iso-band instead of
the nx³ float32 volume (generate/band.py): the same decode and trunk, then
``band_extract`` on the device and one copy of its payload; the mesh equals
the full float32 transfer's bit for bit, and a band that overflows its
buffer takes the full transfer (``band_overflows`` counts it).

Over a device mesh (parallel.mesh.Mesh, one process per card) the
batched decodes split the object axis over the data ranks: each rank
decodes its objects (a batch that does not divide the data axis is
decoded whole by every rank) and the results are all-gathered, so that
every rank returns what one device would. ``eval_points_dense_sharded``
splits one object's dense grid into z-slabs instead, one per data rank.

Every model forward of the generator (the encoders, the gates, the
decodes, the hand mesh, the tactile clouds) runs under the TF32 flags
that ``generation.matmul_precision`` names ('highest' by default: IEEE
float32, as the reference computes), and ``generation.use_pallas`` false
routes the decodes to the plain trunk instead of the kernels. Marching
cubes and the lattice encode of query sets run in the native host engines
(native/mc.cpp, native/geom.cpp).

The hand mesh is the MANO prediction moved from the canonical wrist frame
into the object's normalized frame; the tactile clouds back-project the
depth U-Net's predicted maps through each sensor's camera. LoopGenerator
is the training loop's periodic visualization.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np
import torch

from vtaco_tpu_torch import native
from vtaco_tpu_torch.core.precision import TF32, matmul_precision as _precision
from vtaco_tpu_torch.generate.band import (
    band_extract,
    band_marching_cubes,
    band_payload,
    band_reconstruct,
    band_unpack,
    default_cap,
)
from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.cuda.decode import (
    fused_trunk_cn,
    fused_trunk_cn_batched,
    fused_trunk_gated_cn,
    fused_trunk_window_cn,
)
from vtaco_tpu_torch.models.decoder import LocalDecoder
from vtaco_tpu_torch.ops.dense_decode import (
    dense_feature_volume_cn,
    dense_query_grid_cn,
    device_scalar,
    scattered_feature_volume_cn,
    supercell_keys,
    window_blocks,
    window_overflow,
)
from vtaco_tpu_torch.ops.geometry import (
    R_from_PYR,
    axisang_to_euler_xyz,
    crop_levels,
    decide_total_volume_range,
    norm_pc_1,
    normalize_coord,
    pc_cam_to_world,
    update_reso,
)
from vtaco_tpu_torch.parallel.mesh import (
    all_gather_cat,
    batch_rows,
    data_group,
    gather_rows,
    shard_batch,
)
from vtaco_tpu_torch.train.contact import (
    CAM_FOV,
    DEPTH_REST,
    backproject_depth,
    random_topk_select,
    tips_in_object_frame,
)
from vtaco_tpu_torch.utils import meshio, profiling

_TRANSFER = {"auto": torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16, "int8": "int8"}


def _transfer(td):
    """A transfer dtype given as a torch dtype, 'int8', or a config name."""
    return _TRANSFER[td] if isinstance(td, str) else td


def _host(out):
    """Finalized (N,) or (B, N) logits → host float32 numpy (the span
    ``decode.copy``; the bytes shipped count in ``decode.bytes``)."""
    with profiling.span("decode.copy"):
        if isinstance(out, tuple):           # int8: (quantized, scale per row)
            q, scale = out[0].cpu(), out[1].cpu()
            profiling.count("decode.bytes", q.nbytes + scale.nbytes)
            return q.numpy().astype(np.float32) * scale.numpy()[..., None]
        out = out.float().cpu()
        profiling.count("decode.bytes", out.nbytes)
        return out.numpy()


def _gather_objects(out, mesh, rows):
    """Finalized logits of this rank's objects (a tensor, or int8's (q,
    scale)) → every rank's, on every rank."""
    if isinstance(out, tuple):
        return tuple(gather_rows(t, mesh, rows) for t in out)
    return gather_rows(out, mesh, rows)


def _legacy_transfer(td):
    """The transfer dtype of the legacy decodes: a plain cast, where the
    fast routes' int8 is scaled; int8 becomes bfloat16 there, as in the JAX
    package (a raw int8 cast would truncate the logits)."""
    td = _transfer(td)
    return torch.bfloat16 if td == "int8" else td


def _object(c, b):
    """Object b's fields of batched feature fields."""
    return {k: v[b] for k, v in c.items()}


def _object_fields(c, b):
    """Object b's fields of batched feature fields, as a batch of one."""
    return {k: v[b:b + 1] for k, v in c.items()}


def _at_precision(fn):
    """Run a Generator3D method under the TF32 flags its
    ``matmul_precision`` names, restoring the process's own after."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        with _precision(self.matmul_precision):
            return fn(self, *args, **kw)
    return run


class Generator3D:
    def __init__(self, model, points_batch_size=100000, threshold=0.5, resolution0=16,
                 upsampling_steps=3, padding=0.1, sample=False, refinement_step=0,
                 simplify_nfaces=None, input_type=None, vol_info=None, vol_bound=None,
                 alpha=0.2, with_img=False, encode_t2d=False, contact_per_finger=128,
                 depth_origin=None, legacy_gt_depth=True, matmul_precision="highest",
                 mc_level="midpoint", use_pallas="auto", transfer_dtype="auto",
                 coord_quant="auto", band_transfer="auto"):
        """The JAX package's constructor: the same arguments in the same
        order with the same defaults. ``threshold``, ``alpha`` and
        ``vol_bound`` are stored and read by nothing, as there;
        ``sample``, ``refinement_step`` and ``simplify_nfaces`` are taken
        and dropped, as there.
        ``transfer_dtype``: the dtype the logits are rounded through on
        their way to the host, with the JAX package's contract ('int8' is
        scale-quantized by max|logit|/127). 'auto' resolves to float32.
        ``band_transfer``: true ships the dense decodes' iso-band
        (generate/band.py) in place of the float32 volume, for a
        LocalDecoder; 'auto' resolves to off (the JAX package turns it on
        on a TPU only).
        ``matmul_precision``: the JAX precision name every model forward of
        the generator runs at: 'highest' (the default, as the JAX
        package's) turns cuBLAS's and cuDNN's TF32 off, as the reference
        computes in IEEE float32; 'default' allows TF32 on the card.
        ``use_pallas``: 'auto' and true decode through the CUDA kernels
        (K1-K4, K2 batched); false through the plain trunk, the port of
        the XLA trunk that the JAX package routes false to (no window
        route; the gather route takes those points). It is a user's
        choice, not a fallback: under 'auto' a kernel that does not build
        raises.
        ``coord_quant``: round non-lattice query coords of ``eval_points``
        to uint16 steps of the box (error ≤ box/2¹⁶/2) before decoding, as
        the JAX package does for its host link. 'auto' resolves to off,
        true turns it on.
        ``upsampling_steps``: MISE's refinement levels
        (``generate_obj_mesh_mise``'s default; 3 as in the JAX package).
        ``points_batch_size``: the chunk of the legacy decode
        (``eval_points(fast=False)``).
        ``input_type``, ``vol_info``: the crop volumes of a
        ``pointcloud_crop`` model (``from_config``): vol_info is
        decide_total_volume_range's (input volume, query volume,
        resolution), whose input volume normalizes the crop decode's
        queries. The crop decode covers the whole scene, with or without
        ``generation.sliding_window``, as the JAX package's does."""
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
        if coord_quant not in ("auto", True, False):
            raise ValueError("generation.coord_quant must be 'auto', true, or "
                             f"false; got {coord_quant!r}")
        if matmul_precision not in TF32:
            raise ValueError(f"generation.matmul_precision {matmul_precision!r} is "
                             f"none of {sorted(TF32)}")
        if use_pallas not in ("auto", True, False):
            raise ValueError("generation.use_pallas must be 'auto', true, or "
                             f"false; got {use_pallas!r}")
        self.model = model
        self.matmul_precision = matmul_precision
        self.use_pallas = use_pallas
        self.use_kernels = use_pallas is not False
        self.threshold = threshold
        self.alpha = alpha
        self.vol_bound = vol_bound
        self.resolution0 = resolution0
        self.padding = padding
        self.with_img = with_img
        self.encode_t2d = encode_t2d
        self.contact_per_finger = contact_per_finger
        self.depth_origin = depth_origin
        self.legacy_gt_depth = legacy_gt_depth
        self.mc_level = mc_level
        self.transfer_dtype = _TRANSFER[transfer_dtype]
        self.band_transfer = band_transfer
        self.band_overflows = 0
        self.coord_quant = coord_quant is True
        # eval_points slices its input above this many points, as the JAX
        # package does; the window route's tile and window sizes are the
        # JAX plan's, so that the port picks the same route and plan
        self.scatter_slice_points = 1 << 22
        self.window_tile = 1024
        self.window_S = 128
        self.upsampling_steps = upsampling_steps
        self.points_batch_size = points_batch_size
        self.input_type = input_type
        self.input_vol = vol_info[0] if vol_info is not None else None
        # decode_dense_batched: a flight of more points than this runs in
        # sub-batches under it (the JAX package's lax.map branch), which
        # caps the memory of one launch
        self.batched_vmap_limit = 1 << 25

    @classmethod
    def from_config(cls, model, cfg, **kw):
        gen = cfg["generation"]
        depth_origin = None
        dpath = cfg["data"].get("depth_origin")
        if dpath and os.path.exists(dpath):
            depth_origin = np.loadtxt(dpath).astype(np.float32)
        vol_info = vol_bound = None
        if cfg["data"].get("input_type") == "pointcloud_crop":
            unit_size = cfg["data"]["unit_size"]
            recep_field, depth = crop_levels(cfg["model"]["encoder_kwargs"])
            vol_info = decide_total_volume_range(cfg["data"]["padding"] + 1,
                                                 recep_field, unit_size, depth)
            if gen.get("sliding_window"):
                # the sliding window's crop sizes, as the JAX package keeps
                # them (no decode reads them there either)
                reso = update_reso(cfg["data"]["query_vol_size"] + recep_field - 1, depth)
                vol_bound = {"query_crop_size": cfg["data"]["query_vol_size"] * unit_size,
                             "input_crop_size": reso * unit_size,
                             "fea_type": cfg["model"]["encoder_kwargs"]["plane_type"],
                             "reso": reso}
        return cls(
            model,
            threshold=cfg["test"]["threshold"],
            resolution0=gen["resolution_0"],
            upsampling_steps=gen["upsampling_steps"],
            sample=gen["use_sampling"],
            refinement_step=gen["refinement_step"],
            simplify_nfaces=gen["simplify_nfaces"],
            alpha=gen.get("alpha", 0.2),
            padding=cfg["data"]["padding"],
            with_img=cfg["model"]["with_img"],
            encode_t2d=bool(cfg["model"]["encoder_t2d"]),
            depth_origin=depth_origin,
            points_batch_size=gen.get("batch_size", 100000),
            input_type=cfg["data"]["input_type"],
            vol_info=vol_info,
            vol_bound=vol_bound,
            **{"matmul_precision": gen.get("matmul_precision", "highest"),
               "use_pallas": gen.get("use_pallas", "auto"),
               "mc_level": gen.get("mc_level", "midpoint"),
               "transfer_dtype": gen.get("transfer_dtype", "auto"),
               "band_transfer": gen.get("band_transfer", "auto"),
               "coord_quant": gen.get("coord_quant", "auto"),
               "legacy_gt_depth": cfg["training"].get("legacy_gt_depth", True),
               **kw},
        )

    @staticmethod
    def _fast_capable(model):
        """The fast routes (the channels-first trunk, K1-K4, the batched
        decodes) reproduce LocalDecoder, and only it."""
        return isinstance(model.decoder, LocalDecoder)

    # ------------------------------------------------------------------
    # the legacy decode: the decoder module on chunks of points
    @staticmethod
    def _gate_chunk(pts, gating, gate_pts, gate_feat, gate_valid):
        """(n, C) tactile rows of (n, 3) points from the direct distances:
        'tips' (gate_pts (5, 3)): the nearest fingertip's feature within
        0.05, if that tip touches; 'contact' (gate_pts (5, K, 3)): the
        feature of the last finger with a valid contact within 0.015;
        zeros elsewhere."""
        if gating == "tips":
            d = torch.linalg.norm(pts[:, None, :] - gate_pts[None], dim=-1)
            dmin, assign = torch.min(d, dim=1)
            valid = gate_valid[assign] & (dmin < 0.05)
            return torch.where(valid[:, None], gate_feat[assign], 0.0)
        d = torch.linalg.norm(pts[:, None, None, :] - gate_pts[None], dim=-1)
        within = torch.any((d < 0.015) & gate_valid[None], dim=-1)      # (n, 5)
        last = 4 - torch.argmax(torch.flip(within, [1]).to(torch.uint8), dim=1)
        return torch.where(torch.any(within, dim=1)[:, None], gate_feat[last], 0.0)

    def _decode_chunk(self, model, pts, c, gating, gate_pts, gate_feat, gate_valid,
                      p_n=None):
        """(n, 3) device points → (n,) logits through the decoder module;
        a crop model's with ``p_n``, the points' {field: coords in the
        scene's input volume}, ungated."""
        if p_n is not None:
            return model.decode({"p": pts[None], "p_n": p_n}, c)[0]
        if gating == "none":
            return model.decode(pts[None], c)[0]
        c_img = self._gate_chunk(pts, gating, gate_pts, gate_feat, gate_valid)
        return model.decode_img(pts[None], c, c_img[None])[0]

    def _eval_points_chunked(self, model, pointsf, c, gating, gate_pts, gate_feat,
                             gate_valid, transfer_dtype):
        """The legacy decode of (N, 3) host points → host (N,) float32, in
        chunks of points_batch_size (above one chunk, the last one padded
        with zeros) and one transfer."""
        dev = next(model.parameters()).device
        n, bs = pointsf.shape[0], self.points_batch_size
        if n == 0:
            return np.zeros(0, np.float32)
        k = -(-n // bs)
        host = np.zeros((k * bs if k > 1 else n, 3), np.float32)
        host[:n] = np.asarray(pointsf, np.float32)
        pts = torch.as_tensor(host, device=dev)
        p_n = None
        if self.input_type == "pointcloud_crop":
            p_n = {key: torch.as_tensor(normalize_coord(host, self.input_vol, plane=key),
                                        device=dev) for key in c}
        out = torch.cat([
            self._decode_chunk(model, pts[i:i + bs], c, gating, gate_pts, gate_feat,
                               gate_valid,
                               p_n and {key: v[None, i:i + bs] for key, v in p_n.items()})
            for i in range(0, len(host), bs)])
        return out[:n].to(_legacy_transfer(transfer_dtype)).float().cpu().numpy()

    # ------------------------------------------------------------------
    @staticmethod
    def _finalize_logits(logits, out_dtype):
        """Transfer rounding of (N,) or (B, N) logits: None (f32), a torch
        dtype, or 'int8' → (int8 logits, f32 scale per row) with scale =
        max|logit|/127 over the row (each object's own)."""
        if out_dtype is None:
            return logits
        if out_dtype == "int8":
            scale = torch.clamp(torch.amax(torch.abs(logits), dim=-1), min=1e-6) / 127.0
            return torch.round(logits / scale[..., None]).to(torch.int8), scale
        return logits.to(out_dtype)

    def _trunk_fast(self, tp, p_cn, feats, gate_pts, gate_feat, gate_valid,
                    gating, dtype, leaky):
        """(3, N) coords + (C, N) features → (N,) logits. K1 for contact
        gating; K2 without, or with the (C, N) c_img rows of fingertip
        gating (``gate_tips_cn``, computed first); the plain trunk for leaky
        decoders (the kernels hardcode ReLU) and under ``use_pallas``
        false, as the JAX package routes them."""
        store = dtype if dtype != torch.float32 else None
        c_img = None
        if gating == "tips":
            c_img = FT.gate_tips_cn(p_cn, gate_pts, gate_feat, gate_valid)
        if self.use_kernels and not leaky:
            if gating == "contact":
                return fused_trunk_gated_cn(tp, p_cn, feats, gate_pts,
                                            gate_feat, gate_valid,
                                            store_dtype=store)
            return fused_trunk_cn(tp, p_cn, feats, c_img, store_dtype=store)
        if gating == "contact":
            c_img = FT.gate_contact_cn(p_cn, gate_pts, gate_feat, gate_valid)
        return FT.trunk_cn(tp, p_cn, feats, c_img, dtype=dtype, leaky=leaky)

    def _decode_dense_fast_impl(self, tp, c, gate_pts, gate_feat, gate_valid,
                                nx, gating, dtype, leaky, out_dtype=None,
                                out_xmajor=True):
        """Whole-grid decode, rounded through ``out_dtype``; logits
        flattened x-slowest (the marching-cubes order), or z-slowest, the
        decode's own order, with ``out_xmajor=False``."""
        box_size = 1 + self.padding
        with profiling.span("decode.trunk"):
            feats = dense_feature_volume_cn(c, nx, box_size, self.padding, dtype)
            p_cn = dense_query_grid_cn(nx, box_size, device=feats.device)
            logits = self._trunk_fast(tp, p_cn, feats, gate_pts, gate_feat,
                                      gate_valid, gating, dtype, leaky)
            if out_xmajor:
                logits = logits.reshape(nx, nx, nx).permute(2, 1, 0).reshape(-1)
            return self._finalize_logits(logits, out_dtype)

    @_at_precision
    def eval_points_dense(self, model, nx, c, gating="none", gate_pts=None,
                          gate_feat=None, gate_valid=None, dtype=torch.float32,
                          transfer_dtype=torch.bfloat16):
        """Dense nx³ decode. Returns host (nx³,) float32 logits flattened
        x-slowest, rounded through ``transfer_dtype``. A decoder the fast
        trunk cannot reproduce decodes the grid's points through
        ``eval_points(fast=False)``."""
        if not self._fast_capable(model):
            box = 1 + self.padding
            ax = np.linspace(-0.5, 0.5, nx, dtype=np.float32)
            gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
            pf = box * np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
            return self.eval_points(model, pf, c, gating, gate_pts, gate_feat,
                                    gate_valid, transfer_dtype=transfer_dtype, fast=False)
        return self._eval_points_dense_ordered(
            model, nx, True, c, gating, gate_pts, gate_feat, gate_valid,
            transfer_dtype, dtype)

    def _eval_points_dense_ordered(self, model, nx, xmajor, c, gating,
                                   gate_pts, gate_feat, gate_valid,
                                   transfer_dtype, dtype=torch.float32):
        """Dense nx³ decode to host f32 logits in the flattening that
        ``xmajor`` names (see _full_grid_order)."""
        decoder = model.decoder
        tp = FT.extract_trunk_params(decoder, with_img=gating != "none")
        return _host(self._decode_dense_fast_impl(
            tp, c, gate_pts, gate_feat, gate_valid, nx, gating, dtype,
            decoder.leaky, out_dtype=_transfer(transfer_dtype),
            out_xmajor=xmajor))

    # ------------------------------------------------------------------
    # the iso-band transfer (generate/band.py)
    def _band_enabled(self, model):
        """``band_transfer`` resolved for ``model``: true, and only for a
        decoder the fast routes reproduce; 'auto' is off (the JAX package
        turns it on on a TPU only)."""
        return self.band_transfer is True and self._fast_capable(model)

    def _band_level_args(self):
        """band_extract's (level_mode, level_const) for ``mc_level``."""
        if self.mc_level in ("midpoint", "mean"):
            return self.mc_level, 0.0
        return "const", float(self.mc_level)

    def _band_payload(self, logits, nx, cap):
        """(nx³,) x-slowest device logits → their band payload, one uint8
        device buffer (band_payload), at the level ``mc_level`` names."""
        mode, const = self._band_level_args()
        return band_payload(*band_extract(logits, nx, cap, mode, const))

    def _dense_band(self, model, nx, c, gating, gate_pts, gate_feat, gate_valid,
                    dtype, cap):
        """The dense decode of eval_points_dense (the same trunk, so the
        same logits), then its band: (the x-slowest device logits, the host
        payload (count, level, packed, vals)). The one copy of the payload
        is the only wait for the card."""
        tp = FT.extract_trunk_params(model.decoder, with_img=gating != "none")
        logits = self._decode_dense_fast_impl(tp, c, gate_pts, gate_feat, gate_valid, nx,
                                              gating, dtype, model.decoder.leaky)
        host = self._band_payload(logits, nx, cap).cpu().numpy()
        return logits, band_unpack(host, nx, cap)

    @torch.inference_mode()
    @_at_precision
    def eval_points_dense_band(self, model, nx, c=None, gating="none", gate_pts=None,
                               gate_feat=None, gate_valid=None, dtype=torch.float32,
                               cap=None, inputs=None, mesh=False):
        """Dense nx³ decode that ships only the iso-band (generate/band.py).

        Returns ``(value_grid, level)``: a host (nx, nx, nx) float32 grid
        whose marching cubes at ``level`` equal the full float32
        transfer's bit for bit, and the level resolved on the device from
        ``mc_level`` (the midpoint, the mean or the number). Vertices
        outside the band hold level ± 1: the grid is for the iso-surface,
        not for values. ``inputs`` (a B=1 object cloud) in place of ``c``
        encodes first. ``mesh=True`` returns ``(verts, faces, level)``
        from the band payload with no grid (native/mc.cpp). A band larger
        than ``cap`` (default ``default_cap(nx)``) takes the full float32
        transfer of the same logits, and ``band_overflows`` counts it."""
        if not self._fast_capable(model):
            raise NotImplementedError(
                "the channels-first fast trunk reproduces LocalDecoder only; got "
                f"{type(model.decoder).__name__} (use eval_points(fast=False))")
        cap = default_cap(nx) if cap is None else cap
        if inputs is not None:
            dev = next(model.parameters()).device
            c = model.encode_inputs(torch.as_tensor(np.asarray(inputs), dtype=torch.float32,
                                                    device=dev))
        logits, (count, level, packed, vals) = self._dense_band(
            model, nx, c, gating, gate_pts, gate_feat, gate_valid, dtype, cap)
        if count > cap:
            self.band_overflows += 1
            grid = _host(logits).reshape(nx, nx, nx)
            if mesh:
                return (*marching_cubes(grid, level=level, gradient="ascent"), level)
            return grid, level
        if mesh:
            return (*band_marching_cubes(nx, level, count, packed, vals), level)
        return band_reconstruct(nx, level, count, packed, vals), level

    def _obj_mesh_band(self, model, nx, c, gates, cap=None):
        """generate_obj_mesh_wnf's band route on an encoded sample: its
        gated dense decode (K1, K2, or K2 on fingertip rows), the band on
        the device, one payload copy, and the mesh from the payload in
        voxel units; None when the band overflows ``cap`` (the caller then
        takes the full transfer)."""
        cap = default_cap(nx) if cap is None else cap
        _, (count, level, packed, vals) = self._dense_band(model, nx, c, *gates,
                                                           torch.float32, cap)
        if count > cap:
            self.band_overflows += 1
            return None
        return band_marching_cubes(nx, level, count, packed, vals)

    @torch.inference_mode()
    @_at_precision
    def eval_points_dense_sharded(self, model, nx, c, device_mesh, dtype=torch.float32):
        """One object's dense nx³ decode with the query axis split over the
        mesh's data ranks (vtaco_tpu/generate/generator.py:1632-1700): each
        rank interpolates the features of its z-slab of the grid and
        decodes it, ungated, through K2 (the plain trunk where the
        generator routes there), and the slabs' logits, rounded to
        bfloat16 for the transfer, are all-gathered. Every rank returns
        host (nx³,) float32 logits flattened x-slowest; nx must divide over
        the data ranks."""
        n_dev = device_mesh.shape["data"]
        if nx % n_dev:
            raise ValueError(f"nx {nx} does not divide over {n_dev} data ranks")
        if not self._fast_capable(model):
            raise NotImplementedError(
                "eval_points_dense_sharded needs a LocalDecoder (the fast trunk "
                f"cannot reproduce {type(model.decoder).__name__})")
        d, dz = device_mesh.get_coordinate()[0], nx // n_dev
        box = 1 + self.padding
        tp = FT.extract_trunk_params(model.decoder, with_img=False)
        feats = dense_feature_volume_cn(c, nx, box, self.padding, dtype,
                                        z=slice(d * dz, (d + 1) * dz))
        p_cn = dense_query_grid_cn(nx, box, device=feats.device)
        p_cn = p_cn[:, d * dz * nx * nx:(d + 1) * dz * nx * nx]
        logits = self._trunk_fast(tp, p_cn, feats, None, None, None, "none", dtype,
                                  model.decoder.leaky).to(torch.bfloat16)
        logits = all_gather_cat(logits, data_group(device_mesh)).reshape(nx, nx, nx)
        return _host(logits.permute(2, 1, 0).reshape(-1))

    # ------------------------------------------------------------------
    # arbitrary query points: eval_points and its routes
    @staticmethod
    def _estimate_lattice_reso(p, box, max_reso=4096):
        """Sampled denominator estimate for grid-structured query sets: if
        every sampled coordinate looks like ``box·(i/R − 0.5)`` for one
        R ≤ max_reso, return R, else None. A sample can only
        under-estimate R; the encode's verify pass then rejects it."""
        from fractions import Fraction
        from math import gcd

        s = np.asarray(p, np.float64).reshape(-1, 3)
        if s.size == 0:
            return None
        # whole rows, so that every axis is sampled
        vals = (s[:: max(1, len(s) // 64)][:64] / box + 0.5).reshape(-1)
        # negated in-range form: NaN and inf fail it
        if not (vals.min() >= -1e-6 and vals.max() <= 1 + 1e-6):
            return None
        reso = 1
        for v in vals:
            f = Fraction(float(v)).limit_denominator(max_reso)
            if abs(float(f) - v) > 1e-5:
                return None
            reso = reso * f.denominator // gcd(reso, f.denominator)
            if reso > max_reso:
                return None
        return reso

    @staticmethod
    def _lattice_encode_host(p, box, reso, npad):
        """(N, 3) f32 world coords → ((3, npad) uint8/int16 lattice nodes,
        max residual in lattice units), in one native pass
        (native.geom.lattice_encode). A caller that accepts the residual
        snaps each point to its nearest node; NaN, inf or out-of-range
        coords force a rejection."""
        return native.geom.lattice_encode(p, box, reso, npad)

    @staticmethod
    def _lattice_encode_numpy(p, box, reso, npad):
        """The plain numpy form of _lattice_encode_host, the tests'
        reference: equal nodes on lattice inputs, residuals within float32
        rounding."""
        n = len(p)
        w = np.asarray(p, np.float32).T * (reso / box) + 0.5 * reso
        r = np.rint(w)
        ok = n == 0 or bool(np.isfinite(w).all())
        resid = float(np.abs(w - r).max()) if (n and ok) else 0.0
        if n and not (ok and r.min() >= 0 and r.max() <= reso):
            resid = 1e9
        out = np.zeros((3, npad), np.uint8 if reso <= 255 else np.int16)
        out[:, :n] = np.where(np.isfinite(r), r, 0)
        return out, resid

    @staticmethod
    def _full_grid_order(pts_cn, n, R1):
        """Is the (3, ≥n) integer lattice array exactly the complete R1³
        cube in a canonical flattening? ``True`` for x-slowest / z-fastest
        (the reference's make_3d_grid order), ``False`` for the dense
        decode's x-fastest order, ``None`` for anything else."""
        if n != R1 ** 3:
            return None
        x = pts_cn[0, :n]
        y = pts_cn[1, :n]
        z = pts_cn[2, :n]
        m = min(R1, n)
        head = np.arange(m, dtype=pts_cn.dtype)
        for fast_axis, xmajor in ((z, True), (x, False)):
            if not np.array_equal(fast_axis[:m], head):
                continue
            a, b = (x, z) if xmajor else (z, x)
            f = (a.astype(np.int64) * R1 + y) * R1 + b
            if np.array_equal(f, np.arange(n, dtype=np.int64)):
                return xmajor
        return None

    def _try_full_grid(self, model, pf, c, gating, gate_pts, gate_feat,
                       gate_valid, transfer_dtype, dtype):
        """A complete-cube f32 query set in a canonical order goes through
        the dense decode, whose coords are made on the device. Returns host
        (N,) f32 logits in the caller's order, or None."""
        n = len(pf)
        if n < 8 or not np.issubdtype(pf.dtype, np.floating):
            return None
        R1 = int(round(n ** (1 / 3)))
        if R1 ** 3 != n or not 2 <= R1 <= 4097:
            return None
        cand, resid = self._lattice_encode_host(pf, 1 + self.padding, R1 - 1, n)
        if resid > 1e-3:
            return None
        xmajor = self._full_grid_order(cand, n, R1)
        if xmajor is None:
            return None
        return self._eval_points_dense_ordered(
            model, R1, xmajor, c, gating, gate_pts, gate_feat, gate_valid,
            transfer_dtype, dtype)

    @staticmethod
    def _quantize(p, box, dev):
        """Host coords (any shape) → their uint16 steps of the box as an
        int32 device tensor (``coord_quant``'s upload)."""
        u = np.asarray(p, np.float32) / box + 0.5
        return torch.as_tensor(np.round(np.clip(u, 0.0, 1.0) * 65535.0).astype(np.int32),
                               device=dev)

    def _world_coords(self, pts, lattice_reso=None, coord_quant=False):
        """(3, N) device coords as encoded → f32 world coords: lattice
        nodes ``box·(i/R − 0.5)``, uint16 steps ``box·(q/65535 − 0.5)``, or
        the f32 coords themselves."""
        box = 1 + self.padding
        if lattice_reso is not None:
            return box * (pts.float() / device_scalar(lattice_reso, pts.device) - 0.5)
        if coord_quant:
            return box * (pts.float() / device_scalar(65535.0, pts.device) - 0.5)
        return pts

    def _decode_scatter_fast_impl(self, tp, p_cn, c, gate_pts, gate_feat,
                                  gate_valid, gating, dtype, leaky,
                                  out_dtype=None):
        """The gather route: corner-gather every field's features at the
        (3, N) world coords, then the trunk of the dense path (K1/K2)."""
        feats = scattered_feature_volume_cn(c, p_cn, self.padding, dtype)
        logits = self._trunk_fast(tp, p_cn, feats, gate_pts, gate_feat,
                                  gate_valid, gating, dtype, leaky)
        return self._finalize_logits(logits, out_dtype)

    def _window_plan(self, p_cn, reso):
        """The cheapest (L, tile) whose windows hold every tile of the
        points sorted by super-cell: L = 1 (plain cells) before L = 2,
        larger tiles first, as the JAX package plans. Returns
        ``(L, tile, order)`` with the points' stable sort order, or None
        when nothing fits."""
        S = self.window_S
        for L in (1, 2):
            keys, order = torch.sort(
                supercell_keys(p_cn, reso, self.padding, L), stable=True)
            n_blk = window_blocks(reso, L, S)
            for tile in (self.window_tile, self.window_tile // 2,
                         self.window_tile // 4):
                if int(window_overflow(keys, tile, S, n_blk)) == 0:
                    return L, tile, order
        return None

    def _decode_scatter_window_impl(self, tp, p_sorted, grid, gate_pts,
                                    gate_feat, gate_valid, gating, S, tile, L):
        """The window kernel over points in super-cell order: K4 with
        contact gating, K3 without, or with the c_img rows of fingertip
        gating (``gate_tips_cn`` on the sorted points). Returns (logits,
        n_overflow)."""
        kw = dict(reso=grid.shape[0], padding=self.padding, L=L, S=S,
                  tile=tile)
        if gating == "contact":
            return fused_trunk_window_cn(tp, grid, p_sorted, gate_pts=gate_pts,
                                         gate_feat=gate_feat,
                                         gate_valid=gate_valid, **kw)
        if gating == "tips":
            c_img = FT.gate_tips_cn(p_sorted, gate_pts, gate_feat, gate_valid)
            return fused_trunk_window_cn(tp, grid, p_sorted, c_img_cn=c_img, **kw)
        return fused_trunk_window_cn(tp, grid, p_sorted, **kw)

    def _try_window_scatter(self, tp, p_cn, c, gating, gate_pts, gate_feat,
                            gate_valid, out_dtype, leaky):
        """The sorted window route for (3, n) world coords on the device:
        sort by super-cell, decode, un-sort. Returns the finalized logits in
        the caller's order, or None where the JAX package takes the gather
        route: ``use_pallas`` false, a leaky decoder (the kernels hardcode
        ReLU), plane features,
        a non-cubic or tiny grid, NaN coords, no plan that fits, or a
        nonzero overflow count from the kernel's keys."""
        if not self.use_kernels or leaky or gating not in ("none", "tips", "contact"):
            return None
        if set(c) != {"grid"}:
            return None
        g = c["grid"]
        g = g[0] if g.ndim == 5 else g
        reso = g.shape[0]
        if not (g.shape[0] == g.shape[1] == g.shape[2]) or reso < 4:
            return None
        if bool(torch.isnan(p_cn).any()):
            return None
        plan = self._window_plan(p_cn, reso)
        if plan is None:
            return None
        L, tile, order = plan
        logits, n_overflow = self._decode_scatter_window_impl(
            tp, p_cn[:, order], g.float(), gate_pts, gate_feat, gate_valid,
            gating, self.window_S, tile, L)
        if int(n_overflow) != 0:
            return None
        out = torch.empty_like(logits)
        out[order] = logits
        return self._finalize_logits(out, out_dtype)

    @torch.inference_mode()
    @_at_precision
    def eval_points_fast(self, model, pointsf, c, gating="none", gate_pts=None,
                         gate_feat=None, gate_valid=None,
                         transfer_dtype=torch.bfloat16, dtype=torch.float32,
                         lattice_reso=None, coord_quant=None,
                         detect_lattice=True, detect_dense=True):
        """Decode (N, 3) host query points → host (N,) float32 logits,
        rounded through ``transfer_dtype``, routed as the JAX package
        routes them with its kernels on:

        - a complete cube in a canonical order (``detect_dense``): the
          dense decode;
        - a lattice (``lattice_reso=R`` for an integer (N, 3) input, or a
          detected one with ``detect_lattice``: points within 1e-3 lattice
          units of a node snap to it): the corner gather + K1/K2;
        - any other set: the sorted window route (K3/K4), or the gather
          route where the window route declines.

        ``coord_quant`` True rounds non-lattice coords to uint16 steps of
        the box first; None defers to the generator's setting, after the
        lattice encodings have been tried."""
        n = pointsf.shape[0]
        if n == 0:
            return np.zeros(0, np.float32)
        decoder = model.decoder
        tp = FT.extract_trunk_params(decoder, with_img=gating != "none")
        dev = next(model.parameters()).device
        td = _transfer(transfer_dtype)
        gates = (gate_pts, gate_feat, gate_valid)
        box = 1 + self.padding
        pf = np.asarray(pointsf)
        pts = None
        if coord_quant is None:
            coord_quant, quant_fallback = False, self.coord_quant
        else:
            quant_fallback = False
        if (lattice_reso is None and not coord_quant and detect_lattice
                and np.issubdtype(pf.dtype, np.floating)):
            if detect_dense:
                out = self._try_full_grid(model, pf, c, gating, *gates, td,
                                          dtype)
                if out is not None:
                    return out
            reso = self._estimate_lattice_reso(pf, box)
            if reso is not None:
                cand, resid = self._lattice_encode_host(pf, box, reso, n)
                if resid <= 1e-3:
                    pts, lattice_reso = cand, reso
        if pts is None and lattice_reso is None:
            if coord_quant or quant_fallback:
                p = self._world_coords(self._quantize(pf.T, box, dev), coord_quant=True)
            else:
                p = torch.as_tensor(
                    np.ascontiguousarray(pf.astype(np.float32, copy=False).T),
                    device=dev)
            out = self._try_window_scatter(tp, p, c, gating, *gates, td,
                                           decoder.leaky)
            if out is None:
                out = self._decode_scatter_fast_impl(
                    tp, p, c, *gates, gating, dtype, decoder.leaky, td)
            return _host(out)
        if pts is None:                       # an integer lattice input
            if (detect_dense and np.issubdtype(pf.dtype, np.integer)
                    and n == (lattice_reso + 1) ** 3):
                xm = self._full_grid_order(np.ascontiguousarray(pf.T), n,
                                           lattice_reso + 1)
                if xm is not None:
                    return self._eval_points_dense_ordered(
                        model, lattice_reso + 1, xm, c, gating, *gates, td,
                        dtype)
            u8 = (lattice_reso <= 255 and pf.size
                  and pf.min() >= 0 and pf.max() <= 255)
            pts = pf.astype(np.uint8 if u8 else np.int16).T
        p = self._world_coords(
            torch.as_tensor(np.ascontiguousarray(pts), device=dev), lattice_reso)
        return _host(self._decode_scatter_fast_impl(
            tp, p, c, *gates, gating, dtype, decoder.leaky, td))

    @torch.inference_mode()
    @_at_precision
    def eval_points(self, model, pointsf, c, gating="none", gate_pts=None,
                    gate_feat=None, gate_valid=None,
                    transfer_dtype=torch.bfloat16, fast=None):
        """Occupancy logits at (N, 3) host points → host (N,) float32 (the
        reference's public decode API, generation.py:338-383). ``fast``
        None takes :meth:`eval_points_fast` for a LocalDecoder outside
        crop mode: whole up to ``scatter_slice_points`` points; above that
        a complete cube goes to the dense decode whole and any other set in
        slices. ``fast=False``, crop models and other decoders take the
        legacy chunked decode (``_eval_points_chunked``)."""
        crop = self.input_type == "pointcloud_crop"
        if fast is None:
            fast = not crop and self._fast_capable(model)
        if not fast or crop:
            return self._eval_points_chunked(model, pointsf, c, gating, gate_pts,
                                             gate_feat, gate_valid, transfer_dtype)
        kw = dict(gating=gating, gate_pts=gate_pts, gate_feat=gate_feat,
                  gate_valid=gate_valid, transfer_dtype=transfer_dtype)
        n = pointsf.shape[0]
        lim = self.scatter_slice_points
        if n <= lim:
            return self.eval_points_fast(model, pointsf, c, **kw)
        pf = np.asarray(pointsf)
        if np.issubdtype(pf.dtype, np.floating):
            out = self._try_full_grid(model, pf, c, gating, gate_pts, gate_feat,
                                      gate_valid, _transfer(transfer_dtype),
                                      torch.float32)
            if out is not None:
                return out
        return np.concatenate([
            self.eval_points_fast(model, pointsf[i:i + lim], c, **kw)
            for i in range(0, n, lim)])

    # ------------------------------------------------------------------
    # batched serving: B objects per call, ungated
    def _trunk_batched(self, tp, p_cn, feats, dtype, leaky):
        """(3, N) shared or (B, 3, N) coords + (B, C, N) features → (B, N)
        logits: one batched K2 launch; the plain trunk per object for
        leaky decoders (the kernels hardcode ReLU) and under
        ``use_pallas`` false."""
        if self.use_kernels and not leaky:
            store = dtype if dtype != torch.float32 else None
            return fused_trunk_cn_batched(tp, p_cn, feats, store_dtype=store)
        return torch.stack([FT.trunk_cn(tp, p_cn if p_cn.dim() == 2 else p_cn[b],
                                        feats[b], dtype=dtype, leaky=leaky)
                            for b in range(len(feats))])

    @torch.inference_mode()
    @_at_precision
    def decode_dense_batched(self, model, nx, c_batched, device_mesh=None,
                             dtype=torch.float32, return_device=False,
                             transfer_dtype=torch.bfloat16):
        """Batched dense decode: (B, ...) feature fields → (B, nx³) logits,
        each object flattened x-slowest (the marching-cubes order) and
        rounded through ``transfer_dtype`` (its own default: bfloat16;
        'int8' quantizes each object by its own scale), returned as host
        float32 numpy. Ungated (the plain head): one batched K2 launch for
        the flight, or one per sub-batch when the flight holds
        ``batched_vmap_limit`` points or more. ``dtype`` bfloat16 stores
        the streamed operands as bfloat16; K2 computes in float32.
        ``return_device=True`` returns the finalized device tensor ((q,
        scale) for int8) without waiting for it. ``c_batched`` holds the
        grid and/or planes. With ``device_mesh`` each data rank decodes
        its objects and every rank returns all of them."""
        if not self._fast_capable(model):
            raise NotImplementedError(
                "decode_dense_batched needs a LocalDecoder (the fast trunk cannot "
                f"reproduce {type(model.decoder).__name__}); decode per object "
                "through generate_obj_mesh_wnf or eval_points")
        rows = None
        if device_mesh is not None:
            rows = batch_rows(len(next(iter(c_batched.values()))), device_mesh)
            c_batched = shard_batch(device_mesh, c_batched)
        decoder = model.decoder
        tp = FT.extract_trunk_params(decoder, with_img=False)
        first = next(iter(c_batched.values()))
        B, n, dev = first.shape[0], nx ** 3, first.device
        box = 1 + self.padding
        per = B if B * n < self.batched_vmap_limit else max(
            1, (self.batched_vmap_limit - 1) // n)
        p_cn = dense_query_grid_cn(nx, box, device=dev)
        logits = torch.empty((B, n), dtype=torch.float32, device=dev)
        for s in range(0, B, per):
            objs = range(s, min(s + per, B))
            feats = torch.stack([dense_feature_volume_cn(_object(c_batched, b), nx, box,
                                                         self.padding, dtype)
                                 for b in objs])
            logits[s:s + len(objs)] = self._trunk_batched(tp, p_cn, feats, dtype,
                                                          decoder.leaky)
            del feats
        logits = logits.reshape(B, nx, nx, nx).permute(0, 3, 2, 1).reshape(B, n)
        out = self._finalize_logits(logits, _transfer(transfer_dtype))
        if rows is not None:
            out = _gather_objects(out, device_mesh, rows)
        return out if return_device else _host(out)

    @torch.inference_mode()
    @_at_precision
    def decode_dense_batched_band(self, model, nx, c_batched, device_mesh=None,
                                  dtype=torch.float32, cap=None, return_device=False):
        """decode_dense_batched with each object's iso-band shipped in place
        of its volume (generate/band.py): the same batched K2 decode, then
        each object's band on the device, and one copy of the (B, bytes)
        payloads. Returns ``(grids, levels)``: B host (nx, nx, nx) grids
        whose meshes at their levels equal the full float32 transfer's,
        and the levels. ``return_device=True`` returns ``(payloads,
        fin_args)`` without waiting, for ``finish_batched_band``. With
        ``device_mesh`` each data rank decodes its objects and every rank
        holds every payload."""
        if not self._fast_capable(model):
            raise NotImplementedError(
                "decode_dense_batched_band needs a LocalDecoder (the fast trunk cannot "
                f"reproduce {type(model.decoder).__name__})")
        cap = default_cap(nx) if cap is None else cap
        rows, c_local = None, c_batched
        if device_mesh is not None:
            rows = batch_rows(len(next(iter(c_batched.values()))), device_mesh)
            c_local = shard_batch(device_mesh, c_batched)
        logits = self.decode_dense_batched(model, nx, c_local, dtype=dtype, return_device=True,
                                           transfer_dtype=torch.float32)
        raw = torch.stack([self._band_payload(row, nx, cap) for row in logits])
        if rows is not None:
            raw = gather_rows(raw, device_mesh, rows)

        def grid_of(b):
            """Object b's float32 grid: its row of this rank's logits (the
            float32 transfer of the same decode), or another rank's object
            decoded again alone."""
            if rows is None or rows.replicated or rows.start <= b < rows.stop:
                local = b if rows is None or rows.replicated else b - rows.start
                return _host(logits[local]).reshape(nx, nx, nx)
            return self.eval_points_dense(
                model, nx, _object_fields(c_batched, b - rows.host_start), dtype=dtype,
                transfer_dtype=torch.float32).reshape(nx, nx, nx)

        fin_args = (nx, cap, grid_of)
        if return_device:
            return raw, fin_args
        return self.finish_batched_band(model, raw, fin_args)

    @torch.inference_mode()
    @_at_precision
    def finish_batched_band(self, model, raw, fin_args, mesh=False):
        """The blocking half of ``decode_dense_batched_band(return_device=
        True)``: one copy of the payloads, then per object, on host_map's
        threads, its grid (``(grids, levels)``) or, with ``mesh=True``, its
        mesh in voxel units from the payload with no grid (``(meshes,
        levels)``). An object whose band overflowed takes the float32
        transfer of its logits (``fin_args``' grid of object b), and
        ``band_overflows`` counts it."""
        from vtaco_tpu_torch.generate.mise import host_map

        nx, cap, grid_of = fin_args
        payloads = [band_unpack(h, nx, cap) for h in raw.cpu().numpy()]
        full = {}
        for b, (count, _, _, _) in enumerate(payloads):
            if count > cap:
                self.band_overflows += 1
                full[b] = grid_of(b)

        def one(b):
            count, level, packed, vals = payloads[b]
            if b in full:
                return (marching_cubes(full[b], level=level, gradient="ascent") if mesh
                        else full[b])
            if mesh:
                return band_marching_cubes(nx, level, count, packed, vals)
            return band_reconstruct(nx, level, count, packed, vals)

        return host_map(one, range(len(payloads))), [p[1] for p in payloads]

    @torch.inference_mode()
    @_at_precision
    def decode_points_batched(self, model, pts_b, c_batched, device_mesh=None,
                              transfer_dtype=torch.bfloat16, fast=None,
                              lattice_reso=None, coord_quant=None, pts_cn=None,
                              n_real=None):
        """Batched decode at per-object points: (B, M, 3) host points
        against (B, ...) feature fields → host (B, M) float32 logits,
        ungated, rounded through ``transfer_dtype`` ('int8': per-object
        scales). Each object's features are corner-gathered at its points,
        then one batched K2 launch decodes all B objects.

        Encodings, as ``eval_points_fast``: ``lattice_reso=R`` takes
        integer lattice nodes (world coords ``box·(p/R − 0.5)``);
        ``coord_quant`` rounds float coords to uint16 steps of the box
        (None: the generator's setting, off the lattice). ``pts_cn`` (with
        ``n_real``) is a prepacked (B, 3, mpad) int16 lattice upload whose
        first ``n_real`` columns are decoded (MultiGridExtractorNative.
        query_cn fills the rest with each object's last point). Only the
        M real slots are decoded: the JAX package's size buckets pad with
        the last slot, so they change no value and no int8 scale.
        ``fast=False`` (the default for crop models) decodes each object's
        points through the decoder module in chunks of points_batch_size
        (zero-padded), ungated. With ``device_mesh`` each data rank decodes
        its objects and every rank returns all of them."""
        rows = None
        if device_mesh is not None:
            n_obj = len(pts_cn if pts_cn is not None else pts_b)
            rows = batch_rows(n_obj, device_mesh)
            c_batched = shard_batch(device_mesh, c_batched)
            if pts_cn is not None:
                pts_cn = rows.take(pts_cn)
            else:
                pts_b = rows.take(np.asarray(pts_b))
        out = self._decode_points_batched(model, pts_b, c_batched, transfer_dtype, fast,
                                          lattice_reso, coord_quant, pts_cn, n_real)
        if rows is not None:
            out = _gather_objects(out, device_mesh, rows)
        return _host(out)

    def _decode_points_batched(self, model, pts_b, c_batched, transfer_dtype, fast,
                               lattice_reso, coord_quant, pts_cn, n_real):
        """decode_points_batched on this rank's objects: the finalized
        device logits."""
        if fast is None:
            fast = self.input_type != "pointcloud_crop"
        if not fast:
            if lattice_reso is not None:
                raise ValueError("lattice_reso requires the fast path")
            if coord_quant:
                raise ValueError("coord_quant needs the fast non-lattice path")
            return self._decode_points_batched_chunked(model, pts_b, c_batched,
                                                       transfer_dtype)
        if not self._fast_capable(model):
            raise NotImplementedError(
                "decode_points_batched's fast path reproduces LocalDecoder only; "
                f"got {type(model.decoder).__name__} (pass fast=False for the "
                "module decode)")
        if pts_cn is not None:
            if lattice_reso is None or n_real is None:
                raise ValueError("pts_cn takes lattice_reso and n_real")
            pts = np.asarray(pts_cn)[:, :, :int(n_real)]
        else:
            pts = np.asarray(pts_b, np.int16 if lattice_reso else np.float32)
            pts = pts.transpose(0, 2, 1)
        if coord_quant is None:
            coord_quant = lattice_reso is None and self.coord_quant
        elif coord_quant and lattice_reso is not None:
            raise ValueError("coord_quant needs the non-lattice path")
        B, _, M = pts.shape
        dev = next(iter(c_batched.values())).device
        if M == 0:
            return torch.zeros((B, 0), device=dev)
        decoder = model.decoder
        tp = FT.extract_trunk_params(decoder, with_img=False)
        if coord_quant:
            p = self._world_coords(self._quantize(pts, 1 + self.padding, dev),
                                   coord_quant=True)
        else:
            p = self._world_coords(torch.as_tensor(np.ascontiguousarray(pts), device=dev),
                                   lattice_reso)
        feats = torch.stack([scattered_feature_volume_cn(_object(c_batched, b), p[b],
                                                         self.padding)
                             for b in range(B)])
        logits = self._trunk_batched(tp, p, feats, torch.float32, decoder.leaky)
        return self._finalize_logits(logits, _transfer(transfer_dtype))

    def _decode_points_batched_chunked(self, model, pts_b, c_batched, transfer_dtype):
        """decode_points_batched(fast=False): (B, M, 3) host points → (B,
        M) device logits in the transfer dtype, each object's chunks of
        points_batch_size through the decoder module (the last chunk
        zero-padded)."""
        if self.input_type == "pointcloud_crop":
            raise NotImplementedError(
                "decode_points_batched on a crop model (pointcloud_crop): the JAX "
                "package's chunk decode hands the crop decoder bare points and "
                "fails (F6 (c), ROADMAP.md §3)")
        pts_b = np.asarray(pts_b, np.float32)
        B, M = pts_b.shape[:2]
        bs = self.points_batch_size
        k = max(1, -(-M // bs))
        dev = next(model.parameters()).device
        pts = torch.zeros((B, k * bs, 3), dtype=torch.float32, device=dev)
        pts[:, :M] = torch.as_tensor(pts_b, device=dev)
        out = torch.stack([
            torch.cat([model.decode(pts[b:b + 1, i:i + bs],
                                    {f: v[b:b + 1] for f, v in c_batched.items()})[0]
                       for i in range(0, k * bs, bs)])
            for b in range(B)])
        return out[:, :M].to(_legacy_transfer(transfer_dtype))

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

    @_at_precision
    def _build_gates(self, model, imgs, depths, touch, pc_ply, cam_pos,
                     cam_rot, seed=0, *, inputs=None, mano_gt=None, wrist=None):
        """The tactile gates of a B=1 sample, as ``(gating, gate_pts,
        gate_feat, gate_valid)``: none without images; with a
        tactile-to-depth model, contact gates from the ground-truth depths
        (legacy_gt_depth: the t2d forward is skipped, its prediction would
        never reach the gates) or from the t2d model's predicted depths
        (its forward on the object cloud ``inputs`` and the images, in the
        model's mode); without one (VTacOH), fingertip gates: the hand
        encoder's MANO fingertips moved into the object frame by the
        ground-truth wrist position ``mano_gt[:, :3]`` and Euler angles
        ``wrist``, with the touch flags as their validity. The span
        ``gates`` holds ``gates.img``, then ``gates.hand`` or ``gates.t2d``
        (when it runs) and ``gates.contact``."""
        if not self.with_img:
            return "none", None, None, None
        with profiling.span("gates"):
            with profiling.span("gates.img"):
                c_img = model.encode_img_inputs(imgs)                 # (1, 5, C)
            if not self.encode_t2d:
                with profiling.span("gates.hand"):
                    c_hand = model.encode_hand_inputs(inputs)
                    tips = tips_in_object_frame(c_hand["mano_joints"], mano_gt[:, :3],
                                                wrist, pc_ply)[0]
                return "tips", tips, c_img[0], touch[0]
            H, W = imgs.shape[2], imgs.shape[3]
            if self.depth_origin is not None and len(self.depth_origin) == H * W:
                d_origin = torch.as_tensor(self.depth_origin, device=depths.device)
            else:
                d_origin = torch.full((H * W,), DEPTH_REST, device=depths.device)
            pred_depth = None
            if not self.legacy_gt_depth:
                with profiling.span("gates.t2d"):
                    pred_depth = model.encode_t2d(inputs, imgs)[0][0]  # (5, H*W)
            with profiling.span("gates.contact"):
                gate_pts, gate_valid = self._prep_contact_gates(
                    depths[0], pred_depth, d_origin, touch[0], cam_rot[0], cam_pos[0],
                    pc_ply[0], H, W, seed=seed)
            return "contact", gate_pts, c_img[0], gate_valid

    @_at_precision
    def _encode_sample(self, model, data, seed, gates=True):
        """A B=1 loader batch → (its encoded feature grid, its tactile gates
        from ``_build_gates``, or no gating when ``gates`` is false)."""
        dev = next(model.parameters()).device

        def get(key, dtype=torch.float32):
            return torch.as_tensor(np.asarray(data[key]), dtype=dtype, device=dev)

        inputs = get("inputs")
        c = model.encode_inputs(inputs)
        if not gates:
            return c, ("none", None, None, None)
        imgs = get("inputs.img") if "inputs.img" in data else None
        depths = get("inputs.depth") if "inputs.depth" in data else None
        touch = (get("inputs.touch_success") > 0.5
                 if "inputs.touch_success" in data else None)
        hand = {k: get(f"points.{k}") for k in ("mano", "wrist")
                if f"points.{k}" in data}
        return c, self._build_gates(
            model, imgs, depths, touch, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"), seed, inputs=inputs,
            mano_gt=hand.get("mano"), wrist=hand.get("wrist"))

    @torch.inference_mode()
    @_at_precision
    def generate_obj_mesh_wnf(self, model, data, seed=0):
        """Dense-grid decode + marching cubes + metrics for a B=1 batch.

        ``data`` holds the JAX loader's keys and layouts (``inputs``,
        ``inputs.img`` (B, 5, H, W, 3), ``inputs.depth``,
        ``inputs.touch_success``, ``inputs.pc_ply``, ``points.*``: fingertip
        gating reads ``points.mano`` and ``points.wrist``). It runs
        on the device that holds ``model``'s parameters.
        With ``band_transfer`` true the decode ships its iso-band (the
        same mesh; the full transfer after an overflow).
        Returns ((verts, faces), emd, chamfer). A crop batch
        (``pointcloud_crop``) raises: it holds no object scan, which the JAX
        package reads there and fails (F6 (b), ROADMAP.md §3), and so does a
        voxel batch (``input_type: voxels``, F8 (c))."""
        if "inputs.pc_ply" not in data and (
                self.input_type == "pointcloud_crop" or "pointcloud_crop" in data):
            raise NotImplementedError(
                "generate_obj_mesh_wnf on a crop batch (pointcloud_crop): it holds "
                "no object scan (inputs.pc_ply), which the JAX package reads and "
                "fails (F6 (b), ROADMAP.md §3)")
        if "inputs.pc_ply" not in data and self.input_type == "voxels":
            raise NotImplementedError(
                "generate_obj_mesh_wnf on a voxel batch (input_type voxels): it "
                "holds no object scan (inputs.pc_ply), which the JAX package reads "
                "at vtaco_tpu/generate/generator.py:2230 and fails (F8 (c), "
                "ROADMAP.md §3)")
        dev = next(model.parameters()).device
        box_size = 1 + self.padding
        nx = self.resolution0 * 4
        points_obj = np.asarray(data["points.points_obj"])
        c, gates = self._encode_sample(model, data, seed)
        mesh = self._obj_mesh_band(model, nx, c, gates) if self._band_enabled(model) else None
        if mesh is None:
            values = self.eval_points_dense(model, nx, c, *gates,
                                            transfer_dtype=self.transfer_dtype)
            value_grid = values.reshape(nx, nx, nx)
            level = None  # midpoint: marching_cubes' default
            if self.mc_level == "mean":
                level = float(value_grid.mean())
            elif isinstance(self.mc_level, (int, float)):
                level = float(self.mc_level)
            mesh = marching_cubes(value_grid, level=level, gradient="ascent")
        verts, faces = mesh
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

    @torch.inference_mode()
    @_at_precision
    def generate_obj_mesh_mise(self, model, data, resolution0=None,
                               upsampling_steps=None, seed=0, stats=None):
        """A B=1 batch's mesh by MISE refinement (generate/mise.py): a
        dense decode at (resolution0+1)³ (default ``resolution_0·4``), then
        ``upsampling_steps`` levels (default the config's) that decode
        only the points next to the surface, through the gather route with
        the same tactile gates as ``generate_obj_mesh_wnf`` (contact,
        fingertip or none), so the trained head drives the extraction.
        The level follows ``mc_level``: a number is a level in logit
        space; 'mean' and 'midpoint' take the coarse field's mean or
        (min+max)/2. Returns (verts, faces), vertices in the object's
        normalized frame. ``stats`` (a dict) receives multires_decode's
        split and ``marching_cubes_s``."""
        from vtaco_tpu_torch.generate.mise import multires_decode

        res0 = resolution0 or self.resolution0 * 4
        steps = self.upsampling_steps if upsampling_steps is None else upsampling_steps
        c, gates = self._encode_sample(model, data, seed,
                                       gates=self.with_img and "inputs.img" in data)
        if isinstance(self.mc_level, (int, float)):
            thr = float(self.mc_level)
        else:
            thr = None if self.mc_level == "mean" else "midpoint"
        st = stats if stats is not None else {}
        values, thr = multires_decode(self, model, c, res0, steps, thr, *gates,
                                      stats=st)
        reso = res0 * 2 ** steps
        t0 = time.perf_counter()
        verts, faces = marching_cubes(values, level=thr, gradient="ascent")
        st["marching_cubes_s"] = st.get("marching_cubes_s", 0.0) + time.perf_counter() - t0
        return (verts / reso - 0.5) * (1 + self.padding), faces

    # ------------------------------------------------------------------
    @torch.inference_mode()
    @_at_precision
    def generate_hand_mesh(self, model, data):
        """The hand encoder's MANO prediction for a B=1 batch as a mesh in
        the object's normalized frame: the canonical-frame vertices less
        the (0.11, 0.005, 0) offset, un-rotated by the canonical and then
        the predicted wrist rotation (its axis-angle as XYZ Euler angles
        through R_from_PYR), moved by the predicted wrist position, then
        normalized by the object scan (norm_pc_1). Returns host (verts
        (778, 3) float32, faces (1538, 3))."""
        dev = next(model.parameters()).device
        inputs = torch.as_tensor(np.asarray(data["inputs"]), dtype=torch.float32,
                                 device=dev)
        c_hand = model.encode_hand_inputs(inputs)
        mano_param = c_hand["mano_param"][0].float().cpu()
        verts = c_hand["mano_verts"][0].float().cpu()
        faces = c_hand["mano_faces"].cpu().numpy()
        pc_ply = torch.as_tensor(np.asarray(data["inputs.pc_ply"])[0],
                                 dtype=torch.float32)
        wrist_pos, wrist_rotvec = mano_param[:3], mano_param[3:6]
        offset = torch.tensor([0.11, 0.005, 0.0])
        R_canon_inv = torch.linalg.inv(R_from_PYR(torch.tensor(
            [-math.pi / 2, math.pi / 2, 0.0])))
        R_wrist_inv = torch.linalg.inv(R_from_PYR(axisang_to_euler_xyz(wrist_rotvec)))
        x = R_wrist_inv @ (R_canon_inv @ (verts - offset).T)
        return norm_pc_1(x.T + wrist_pos, pc_ply).numpy(), faces

    @torch.inference_mode()
    @_at_precision
    def generate_tactile_pc(self, model, data):
        """The depth U-Net's predicted maps (denormalized: × 0.005 + 0.019)
        back-projected through each sensor's camera into the world, then
        normalized by the object scan. Returns host (B, 5, H*W, 3)
        float32. Raises ValueError when ``encoder_img`` emits features,
        not depth maps."""
        dev = next(model.parameters()).device

        def get(key):
            return torch.as_tensor(np.asarray(data[key]), dtype=torch.float32,
                                   device=dev)

        imgs, pc_ply = get("inputs.img"), get("inputs.pc_ply")
        cam_pos = np.asarray(data["points.cam_pos"], np.float32)
        cam_rot = np.asarray(data["points.cam_rot"], np.float32)
        B, F5, H, W, _ = imgs.shape
        pred_depth = model.encode_img_inputs(imgs)                # (B, 5, H*W)
        if pred_depth.shape[-1] != H * W:
            raise ValueError(
                "generate_tactile_pc needs a depth-map image encoder (the "
                "tactile U-Net); this model's encoder_img emits "
                f"{pred_depth.shape[-1]}-d features, not {H}x{W} depth maps")
        f = H / (2 * math.tan(math.radians(CAM_FOV / 2)))
        rot_off = np.array([-np.pi / 2, 0, np.pi / 2])
        out = torch.empty((B, F5, H * W, 3), device=dev)
        for b in range(B):
            for t in range(F5):
                depth = pred_depth[b, t].float().reshape(H, W) * 0.005 + 0.019
                cloud = backproject_depth(depth, f, W, H)
                rot = torch.as_tensor((cam_rot[b, t] + rot_off).astype(np.float32),
                                      device=dev)
                world = pc_cam_to_world(cloud, rot, torch.as_tensor(cam_pos[b, t],
                                                                    device=dev))
                out[b, t] = norm_pc_1(world, pc_ply[b])
        return out.cpu().numpy()


class LoopGenerator:
    """The training loop's periodic visualization: for the validation
    split, every sample with ``vis_all`` (VTacO's setting), else every
    ``vis_split``-th, writes ``<out_dir>/vis/{it}_{name}_obj.off`` and
    ``_hand.off`` and prints the mean EMD and chamfer, or, for a tactile
    depth stack, ``{it}_{name}_tactile.ply``. The model runs in eval mode
    and gets its own mode back."""

    def __init__(self, generator, train_tactile=False, vis_all=True, vis_split=1):
        self.generator = generator
        self.train_tactile = train_tactile
        self.vis_all = vis_all
        self.vis_split = max(1, int(vis_split))

    def visualize(self, model, val_loader, out_dir, it):
        vis_dir = os.path.join(out_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        emd_total, cd_total = [], []
        was_training = model.training
        model.eval()
        try:
            for i, batch in enumerate(val_loader):
                if not self.vis_all and i % self.vis_split != 0:
                    continue
                name = batch["points.name"][0]
                if self.train_tactile:
                    pcs = self.generator.generate_tactile_pc(model, batch)
                    meshio.write_ply(os.path.join(vis_dir, f"{it}_{name}_tactile.ply"),
                                     pcs[0].reshape(-1, 3))
                    continue
                hand_verts, hand_faces = self.generator.generate_hand_mesh(model, batch)
                (verts, faces), emd, cd = self.generator.generate_obj_mesh_wnf(model, batch)
                emd_total.append(emd)
                cd_total.append(cd)
                meshio.write_off(os.path.join(vis_dir, f"{it}_{name}_hand.off"),
                                 hand_verts, hand_faces)
                meshio.write_off(os.path.join(vis_dir, f"{it}_{name}_obj.off"),
                                 verts, faces)
        finally:
            model.train(was_training)
        if emd_total:
            print("Metrics EMD: {}".format(np.mean(emd_total)))
            print("Metrics CD: {}".format(np.mean(cd_total)))


def make_loop_generator(model, cfg, bank=None):
    """The training loop's visualization hook for cfg (``bank``, the
    loop's MeshBank, is not used)."""
    g = cfg.get("generation", {})
    return LoopGenerator(Generator3D.from_config(model, cfg),
                         train_tactile=cfg["model"]["train_tactile"],
                         vis_all=g.get("vis_all", True), vis_split=g.get("vis_split", 1))
