"""Batch inference: reconstruct a split (port of
vtaco_tpu/generate/inferencer.py:26-94 and :229-275, ``Inferencer``).

For every sample of a B=1 loader the object mesh
(``Generator3D.generate_obj_mesh_wnf``, whose dense decode launches the
trunk kernel) and the hand mesh, with the EMD and chamfer of each object;
for a tactile depth stack (``train_tactile``) the predicted sensor point
clouds instead. Every sample is encoded anew (the reference reuses the
first sample's features, inferencing.py:155-160, an apparent caching
bug the JAX package does not keep either). Means are taken over the
meshes that have an iso-surface; an empty mesh reports inf and counts in
``n_empty``. The batched, pipelined ``run_batched`` is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.utils import meshio


def _finite_mean(xs):
    f = [x for x in xs if np.isfinite(x)]
    return (float(np.mean(f)) if f else None), len(xs) - len(f)


class Inferencer:
    def __init__(self, model, generator: Generator3D, *, train_tactile=False,
                 vis_dir=None):
        self.model = model
        self.generator = generator
        self.train_tactile = train_tactile
        self.vis_dir = vis_dir
        if vis_dir is not None:
            os.makedirs(vis_dir, exist_ok=True)

    @classmethod
    def from_config(cls, model, generator, cfg, **kw):
        return cls(model, generator, train_tactile=cfg["model"]["train_tactile"],
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

    def run_batched(self, *args, **kw):
        raise NotImplementedError("Inferencer.run_batched (the CLI's --batched) "
                                  "is not ported yet (ROADMAP.md, item 9)")

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
