"""The check of the grasp cells: what the timed path produced for a seeded
sample of grasps, against the plain reference on the same drawn weights
and the same host inputs.

Numbers compared, each against the cell's limit (port_bench/checks/):

- ``grid``: the object encoder's feature grid, max |program - reference|
  over max |reference|.
- ``gates``: contact gating, the contact points (max abs difference where
  both sides hold a valid contact; infinite where the validity differs);
  fingertip gating, the fingertips (max abs difference).
- ``c_img``: the fingers' tactile features, as ``grid``.
- ``logits``: the shipped logits of the whole nx³ grid against the
  reference's plain decoder (in blocks), over max |reference|, on the
  points whose gate decision is settled (reference/gates.py).
- ``mesh_count``: |ΔV| + |ΔF| between the program's mesh and the plain
  marching cubes run by the reference on the program's own logits (the
  extraction, exactly).
- ``mesh_verts``: the Hausdorff distance between those two vertex sets,
  in the object frame.
- ``mesh_chamfer``: the mean distance from each vertex of the program's
  mesh to the nearest of the reference's own mesh (the plain marching
  cubes of the reference's logits) and back, halved.
- ``mesh_volume``: the relative difference of the signed volumes of the
  program's mesh and the reference's own mesh (a face turned or moved
  changes it).

The reference runs with TF32 off (the configuration's IEEE float32).
The control (port_bench/control.py) puts ``reference_serve`` with TF32
on in the program's place.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from port_bench.harness import weights
from port_bench.harness.work import model_flops
from port_bench.reference import gates as ref_gates
from port_bench.reference import model as ref_model
from port_bench.reference.mesh import marching_cubes_plain

NAMES = ("grid", "gates", "c_img", "logits", "mesh_count", "mesh_verts", "mesh_chamfer",
         "mesh_volume")


def limits(cell: str) -> dict:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checks", cell + ".json")
    with open(path) as f:
        return json.load(f)["limits"]


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _rel(a, b):
    den = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a.float() - b.float()))) / max(den, 1e-30)


def signed_volume(verts, faces):
    if len(faces) == 0:
        return 0.0
    v = verts.astype(np.float64)[faces]
    return float(np.einsum("ij,ij->i", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum() / 6)


def _nearest(a, b):
    """Distances from each point of a to the nearest of b, both ways."""
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a)[0], cKDTree(a).query(b)[0]


def hausdorff(a, b):
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")
    ab, ba = _nearest(a, b)
    return float(max(ab.max(), ba.max()))


def chamfer(a, b):
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")
    ab, ba = _nearest(a, b)
    return float(ab.mean() + ba.mean()) / 2


def plain_mesh(values, nx, box):
    """The plain marching cubes of host logits at the midpoint level, in
    the object frame, faces turned as the program turns them."""
    grid = values.reshape(nx, nx, nx)
    level = (float(grid.min()) + float(grid.max())) / 2.0
    verts, faces = marching_cubes_plain(grid, level)
    return (verts - np.float32(nx / 2)) * np.float32(box / nx), faces[:, ::-1]


def mesh_numbers(values, verts, faces, ref_values, nx, box):
    """The program's mesh against the plain extraction of its own logits
    and against the reference's own mesh."""
    rv, rf = plain_mesh(values, nx, box)
    count = abs(len(rv) - len(verts)) + abs(len(rf) - len(faces))
    sv, sf = plain_mesh(ref_values, nx, box)
    vol, rvol = signed_volume(verts, faces), signed_volume(sv, sf)
    return {"mesh_count": float(count), "mesh_verts": hausdorff(verts, rv),
            "mesh_chamfer": chamfer(verts, sv),
            "mesh_volume": abs(vol - rvol) / max(abs(rvol), 1e-30)}


def gate_numbers(prog, ref):
    gating, pts, feat, valid = prog
    r_gating, r_pts, r_feat, r_valid = ref
    if gating != r_gating:
        return {"gates": float("inf"), "c_img": float("inf")}
    if gating == "contact":
        both = valid & r_valid
        diff = torch.abs(pts - r_pts).amax(-1)[both]
        g = float(diff.max()) if diff.numel() else 0.0
        if not torch.equal(valid, r_valid):
            g = float("inf")
    else:
        g = float(torch.max(torch.abs(pts - r_pts)))
        if not torch.equal(valid.bool(), r_valid.bool()):
            g = float("inf")
    return {"gates": g, "c_img": _rel(feat, r_feat)}


def reference(ctx, drawn):
    """The reference model of the cell's configuration on the drawn
    weights, on the card."""
    ref = ref_model.build(ctx.model_cfg)
    weights.load(ref, drawn, strict_names=False)
    return ref.to(ctx.device)


def reference_serve(ref, g, gid, nx, box, contact, dev):
    """The reference in the program's place: (feature grid, gates, host
    logits, mesh) of grasp ``g`` at the precision the TF32 flags hold."""
    with torch.no_grad():
        c = ref.encode_inputs(torch.as_tensor(g["inputs"], device=dev))
        gt = ref_gates.grasp_gates(ref, g, gid, dev, contact)
        logits, _ = ref_gates.dense_logits(ref, c, gt, nx, box)
    values = logits.cpu().numpy()
    verts, faces = plain_mesh(values, nx, box)
    return c, gt, values, verts, faces


def judge(ctx, kept, pool, drawn, nx, contact, profiled=()):
    """{"checks": {name: [worst value, limit]}, "record": what the traced
    run's readers need (the work of the profiled requests, the FLOPs of
    one request)}. ``kept``: {grasp id: the loop's Served}."""
    dev = ctx.device
    lim = limits(ctx.cell)
    ref = reference(ctx, drawn)
    box = 1 + ctx.model_cfg["data"]["padding"]
    worst = {n: 0.0 for n in NAMES}
    flops = None
    set_tf32(False)
    try:
        with torch.no_grad():
            for gid in sorted(kept):
                out, g = kept[gid], pool[gid]

                def forward():
                    c = ref.encode_inputs(torch.as_tensor(g["inputs"], device=dev))
                    gt = ref_gates.grasp_gates(ref, g, gid, dev, contact)
                    logits, settled = ref_gates.dense_logits(ref, c, gt, nx, box)
                    return c, gt, logits, settled

                if flops is None:
                    (c, gt, logits, settled), flops = model_flops(forward)
                else:
                    c, gt, logits, settled = forward()
                nums = {"grid": max(_rel(out.c[k], c[k]) for k in c)}
                nums.update(gate_numbers(out.gates, gt))
                got = torch.as_tensor(out.values, device=dev)
                nums["logits"] = _rel(got[settled], logits[settled])
                nums.update(mesh_numbers(out.values, out.verts, out.faces,
                                         logits.cpu().numpy(), nx, box))
                for n, v in nums.items():
                    worst[n] = max(worst[n], v) if np.isfinite(v) else float("inf")
            rows = _gated_rows(ref, pool, profiled, nx, box, dev, contact)
    finally:
        set_tf32(False)
    checks = {n: [worst[n], lim[n]] for n in NAMES}
    if not kept:
        checks["served_checked"] = [float("inf"), 0.0]   # no sampled grasp was served
    return {"checks": checks,
            "record": {"flops_per_request": flops, "nx": nx, "gated_rows": rows,
                       "checked": len(kept)}}


def _gated_rows(ref, pool, ids, nx, box, dev, contact, block=1 << 16):
    """{grasp id: grid points whose tactile row is not zero} for the
    profiled requests' grasps, from the reference's gates."""
    out = {}
    if contact:
        return out
    pts_all = ref_gates.dense_points(nx, box, dev)
    for gid in sorted(set(ids)):
        gt = ref_gates.grasp_gates(ref, pool[gid], gid, dev, contact)
        n = 0
        for i in range(0, len(pts_all), block):
            rows, _ = ref_gates.gate_rows(pts_all[i:i + block], *gt)
            n += int(torch.count_nonzero(rows.abs().sum(1)))
        out[gid] = n
    return out
