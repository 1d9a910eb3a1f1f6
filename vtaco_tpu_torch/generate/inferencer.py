"""Batch inference: reconstruct a split (port of
vtaco_tpu/generate/inferencer.py, ``Inferencer``: :26-94, ``run_batched``
:96-227 through its full-volume branch, ``run`` :229-275).

For every sample of a B=1 loader the object mesh
(``Generator3D.generate_obj_mesh_wnf``, whose dense decode launches the
trunk kernel) and the hand mesh, with the EMD and chamfer of each object;
for a tactile depth stack (``train_tactile``) the predicted sensor point
clouds instead. Every sample is encoded anew (the reference reuses the
first sample's features, inferencing.py:155-160, an apparent caching
bug the JAX package does not keep either). Means are taken over the
meshes that have an iso-surface; an empty mesh reports inf and counts in
``n_empty``.

``run_batched`` serves B objects per flight, ungated (the plain head): one
batched encode and one batched dense decode (one K2 launch), the logits'
copy to pinned host memory started at once, then the next flight launched
before this one's host work (threaded marching cubes, mesh files, one
batched chamfer on the device), so that the host work overlaps the card's.
Over a device mesh every rank iterates the same loader and encodes and
decodes its objects of each flight; rank 0 gathers the logits and does
the host work alone. With ``generation.band_transfer`` true a flight
ships each object's iso-band instead of its logits
(``decode_dense_batched_band``) and the meshes come from the payloads
(``finish_batched_band(mesh=True)``): the meshes of the float32 transfer.

Every model forward runs at the generator's ``matmul_precision``
(``generation.matmul_precision``, 'highest' by default: no TF32).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vtaco_tpu_torch.core.precision import matmul_precision
from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
from vtaco_tpu_torch.generate.mise import host_map
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.parallel.mesh import batch_rows, gather_rows
from vtaco_tpu_torch.utils import meshio


def _finite_mean(xs):
    f = [x for x in xs if np.isfinite(x)]
    return (float(np.mean(f)) if f else None), len(xs) - len(f)


class Inferencer:
    def __init__(self, model, generator: Generator3D, *, threshold=0.5,
                 num_sample=2048, with_img=False, with_contact=False,
                 train_tactile=False, encode_t2d=False, input_type="pointcloud",
                 vis_dir=None):
        """The JAX package's constructor and attributes: ``threshold``,
        ``num_sample``, ``with_img``, ``with_contact``, ``encode_t2d`` and
        ``input_type`` are stored and read by nothing, as there;
        ``resolution0`` and ``padding`` are the generator's."""
        self.model = model
        self.generator = generator
        self.threshold = threshold
        self.num_sample = num_sample
        self.with_img = with_img
        self.with_contact = with_contact
        self.train_tactile = train_tactile
        self.encode_t2d = encode_t2d
        self.input_type = input_type
        self.vis_dir = vis_dir
        self.resolution0 = generator.resolution0
        self.padding = generator.padding
        if vis_dir is not None:
            os.makedirs(vis_dir, exist_ok=True)

    @classmethod
    def from_config(cls, model, generator, cfg, **kw):
        return cls(
            model, generator,
            threshold=cfg["test"]["threshold"],
            num_sample=cfg["data"]["num_sample"],
            with_img=cfg["model"]["with_img"],
            with_contact=cfg["model"]["with_contact"],
            train_tactile=cfg["model"]["train_tactile"],
            encode_t2d=bool(cfg["model"]["encoder_t2d"]),
            input_type=cfg["data"]["input_type"],
            vis_dir=os.path.join(cfg["training"]["out_dir"], "vis"), **kw)

    def inference_step(self, model, data_vis_list):
        """Reconstruct staged samples, each ``{'data': <B=1 batch>, 'name':
        str}`` or a bare batch: (object meshes, hand meshes, stats), the
        meshes as ``((verts, faces), name)``, the stats ``emd_mean``,
        ``cd_mean`` (NaN when no mesh has an iso-surface), ``n`` and
        ``n_empty``."""
        mesh_list_obj, mesh_list_hand = [], []
        emds, cds = [], []
        for entry in data_vis_list:
            data = entry["data"] if "data" in entry else entry
            name = entry.get("name", data.get("points.name", ["sample"])[0])
            (verts, faces), emd, cd = self.generator.generate_obj_mesh_wnf(model, data)
            hand = self.generator.generate_hand_mesh(model, data)
            mesh_list_obj.append(((verts, faces), name))
            mesh_list_hand.append((hand, name))
            emds.append(emd)
            cds.append(cd)
        emd_mean, _ = _finite_mean(emds)
        cd_mean, n_empty = _finite_mean(cds)
        stats = {"emd_mean": float("nan") if emd_mean is None else emd_mean,
                 "cd_mean": float("nan") if cd_mean is None else cd_mean,
                 "n": len(emds), "n_empty": n_empty}
        return mesh_list_obj, mesh_list_hand, stats

    def run_batched(self, model, loader, batch_size=8, device_mesh=None,
                    out_dir=None, max_samples: Optional[int] = None, dtype=None):
        """Reconstruct a split ``batch_size`` objects at a time, ungated,
        writing ``{name}_obj.off`` to ``out_dir`` (default: the config's
        vis directory). Per flight: one batched encode and
        ``decode_dense_batched`` (bfloat16 transfer, ``return_device``),
        or with ``band_transfer`` ``decode_dense_batched_band`` (the band
        payloads; meshes from ``finish_batched_band(mesh=True)``), the
        copy of its logits to pinned host memory started at once;
        flight k+1 is launched before flight k's host work: marching
        cubes per object on ``host_map``'s threads at the midpoint level,
        the mesh files, and one batched chamfer on the device against
        2048 vertices per object drawn by one ``default_rng(0)`` over the
        run (inf for an empty mesh). ``dtype``: the decode's (None:
        float32, K2's own; bfloat16 stores its operands as bfloat16).
        Returns ``{names, cd, cd_mean, n_empty}``, the mean over the
        meshes that are not empty (None when all are). With
        ``device_mesh`` each data rank encodes and decodes its objects of
        every flight (parallel.mesh.batch_rows) and the logits are
        all-gathered; rank 0 alone runs the host work and writes, and every
        rank returns its result."""
        lead = device_mesh is None or dist.get_rank() == 0   # runs the host work
        out_dir = out_dir or self.vis_dir
        if out_dir and lead:
            os.makedirs(out_dir, exist_ok=True)
        gen = self.generator
        nx = gen.resolution0 * 4
        box = 1 + gen.padding
        dev = next(model.parameters()).device
        dtype = torch.float32 if dtype is None else dtype
        names, cds = [], []
        rng = np.random.default_rng(0)
        use_band = gen._band_enabled(model)

        def dispatch(inputs_list, names_b, objs):
            with torch.inference_mode(), matmul_precision(gen.matmul_precision):
                inputs = np.stack(inputs_list)
                fin_args = None
                if device_mesh is not None:
                    rows = batch_rows(len(inputs), device_mesh)
                    local = rows.take(inputs)
                else:
                    local = inputs
                c = model.encode_inputs(torch.as_tensor(local, device=dev))
                if use_band:
                    logits, fin_args = gen.decode_dense_batched_band(
                        model, nx, c, dtype=dtype, return_device=True)
                    if device_mesh is not None:
                        fin_args = fin_args[:2] + (functools.partial(
                            grid_of, fin_args[2], rows, inputs),)
                else:
                    logits = gen.decode_dense_batched(model, nx, c, dtype=dtype,
                                                      return_device=True)
                if device_mesh is not None:
                    logits = gather_rows(logits, device_mesh, rows)
                done = None
                if logits.is_cuda and lead:
                    # start the copy now: a .cpu() after the next flight's
                    # launch would wait for that flight's kernels too
                    host = torch.empty(logits.shape, dtype=logits.dtype,
                                       pin_memory=True)
                    host.copy_(logits, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    logits = host
            return logits, fin_args, done, names_b, objs

        def grid_of(local_grid, rows, inputs, b):
            """Object b's float32 grid after its band overflowed: from this
            rank's logits, or, for another rank's object, encoded and
            decoded again alone by the rank that runs the host work."""
            if rows.replicated or rows.start <= b < rows.stop:
                return local_grid(b - (0 if rows.replicated else rows.start))
            with torch.inference_mode(), matmul_precision(gen.matmul_precision):
                x = inputs[b - rows.host_start][None]
                c1 = model.encode_inputs(torch.as_tensor(x, device=dev))
                return gen.eval_points_dense(model, nx, c1, dtype=dtype,
                                             transfer_dtype=torch.float32).reshape(nx, nx, nx)

        def mc_one(v):
            return marching_cubes(v.reshape(nx, nx, nx), gradient="ascent")

        def consume(flight):
            logits, fin_args, done, names_b, objs = flight
            if done is not None:
                done.synchronize()
            if use_band:
                meshes, _ = gen.finish_batched_band(model, logits, fin_args, mesh=True)
            else:
                meshes = host_map(mc_one, list(logits.float().numpy()))
            meshes = [((verts - nx / 2) * box / nx, faces) for verts, faces in meshes]
            samples, empty = [], []
            for (verts, faces), name in zip(meshes, names_b):
                if out_dir:
                    meshio.write_off(os.path.join(out_dir, f"{name}_obj.off"), verts,
                                     faces)
                n = len(verts)
                empty.append(n == 0)
                if n == 0:       # no iso-surface: a filler, reported as inf
                    samples.append(np.zeros((2048, 3), np.float32))
                else:
                    idx = (rng.permutation(n)[:2048] if n >= 2048
                           else rng.integers(0, n, 2048))
                    samples.append(np.ascontiguousarray(verts[idx], np.float32))
                names.append(name)
            with torch.inference_mode():
                cd = metrics.chamfer_distance(
                    torch.as_tensor(np.stack(objs), device=dev),
                    torch.as_tensor(np.stack(samples), device=dev)).cpu().numpy()
            cds.extend(float("inf") if e else float(x) for x, e in zip(cd, empty))

        def consume_on_host(flight):
            if flight is not None and lead:
                consume(flight)

        in_flight = None
        inputs, names_b, objs = [], [], []
        for i, batch in enumerate(loader):
            if max_samples is not None and i >= max_samples:
                break
            inputs.append(np.asarray(batch["inputs"])[0])
            names_b.append(batch["points.name"][0])
            objs.append(np.asarray(batch["points.points_obj"])[0])
            if len(inputs) == batch_size:
                flight = dispatch(inputs, names_b, objs)
                inputs, names_b, objs = [], [], []
                consume_on_host(in_flight)    # host work overlaps the new flight
                in_flight = flight
        if inputs:
            flight = dispatch(inputs, names_b, objs)
            consume_on_host(in_flight)
            in_flight = flight
        consume_on_host(in_flight)
        cd_mean, n_empty = _finite_mean(cds)
        out = [{"names": names, "cd": cds, "cd_mean": cd_mean, "n_empty": n_empty}]
        if device_mesh is not None:
            dist.broadcast_object_list(out, src=0)
        return out[0]

    def run(self, model, loader, out_dir=None, max_samples: Optional[int] = None):
        """Reconstruct a whole split, writing ``{name}_obj.off`` and
        ``{name}_hand.off`` (or ``{name}_tactile.ply``) to ``out_dir``
        (default: the config's vis directory). Returns the names, the
        per-object ``emd`` and ``cd`` (inf for an empty mesh), their means
        over the other meshes (None when there are none) and ``n_empty``."""
        out_dir = out_dir or self.vis_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        emds, cds, names = [], [], []
        for i, batch in enumerate(loader):
            if max_samples is not None and i >= max_samples:
                break
            name = batch["points.name"][0]
            names.append(name)
            if self.train_tactile:
                pcs = self.generator.generate_tactile_pc(model, batch)
                if out_dir:
                    meshio.write_ply(os.path.join(out_dir, f"{name}_tactile.ply"),
                                     pcs[0].reshape(-1, 3))
                continue
            (verts, faces), emd, cd = self.generator.generate_obj_mesh_wnf(model, batch)
            hand_verts, hand_faces = self.generator.generate_hand_mesh(model, batch)
            if out_dir:
                meshio.write_off(os.path.join(out_dir, f"{name}_obj.off"), verts, faces)
                meshio.write_off(os.path.join(out_dir, f"{name}_hand.off"),
                                 hand_verts, hand_faces)
            emds.append(emd)
            cds.append(cd)
        emd_mean, _ = _finite_mean(emds)
        cd_mean, n_empty = _finite_mean(cds)
        return {"names": names, "emd": emds, "cd": cds, "emd_mean": emd_mean,
                "cd_mean": cd_mean, "n_empty": n_empty}
