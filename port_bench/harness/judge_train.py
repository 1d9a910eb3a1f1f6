"""The check of the training cells: the program's first three steps
against the plain reference following the same three steps from the same
drawn weights, on the same batches and the same sample draws (a
torch.Generator on the card seeded as the trainer's, drawn in the same
order), with Adam of the same settings.

Numbers compared, each against the cell's limit (port_bench/checks/):

- ``loss``, ``loss_l1``, ``loss_mano``, ``loss_pc``: each loss term's
  relative gap at the first step, where both sides start from the same
  parameters. (The gaps of steps 2 and 3, printed beside them, swing from
  seed to seed: Adam turns the rounding of near-zero gradients into whole
  steps of the learning rate, so the parameters of the two sides part
  after the first step.)
- ``grad1``: the first gradient as Adam holds it, by the worst leaf: the
  gap between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf.
- ``change3``: the parameters' change after three steps, by the worst leaf
  as ``grad1``, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move under Adam by
  round-off alone).

The reference computes in the precision the configuration states for
training (``training.matmul_precision``; 'default' allows TF32, as the
port does for users); ``autocast`` runs its networks in bfloat16 instead
(the control).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

from port_bench.harness import weights
from port_bench.harness.judge_grasp import set_tf32
from port_bench.harness.work import model_flops
from port_bench.reference import contact as ref_contact
from port_bench.reference import model as ref_model

IEEE = ("highest", "float32")    # the precision names that keep TF32 off
NAMES = ("loss", "loss_l1", "loss_mano", "loss_pc", "grad1", "change3")
TERMS = ("loss", "loss_l1", "loss_mano", "loss_pc")


def limits(cell: str) -> dict:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checks", cell + ".json")
    with open(path) as f:
        return json.load(f)["limits"]


def tensors(batch, dev):
    """The img path's tensors of a loader batch, as the trainer prepares
    them."""
    def put(key):
        return torch.as_tensor(np.asarray(batch[key]), dtype=torch.float32, device=dev)

    return {"points": put("points"), "occ": put("points.occ"), "inputs": put("inputs"),
            "mano": put("points.mano"), "pc_hand": put("points.pc_hand"),
            "wrist": put("points.wrist"), "pc_ply": put("inputs.pc_ply"),
            "imgs": put("inputs.img"), "touch_success": put("inputs.touch_success") > 0.5}


def loss_img(ref, a, gen, num_sample, tips_per_finger, amp=contextlib.nullcontext):
    """The img path's loss terms (VTacOH): the fingertip-gated sample's
    L1 occupancy loss, the MANO parameters' and the hand vertices' squared
    errors. The networks run under ``amp()`` (the control's bfloat16), the
    geometry of the sample and the losses in float32."""
    with amp():
        c = ref.encode_inputs(a["inputs"])
        c_hand = ref.encode_hand_inputs(a["inputs"])
        c_img = ref.encode_img_inputs(a["imgs"])
    c = {k: v.float() for k, v in c.items()}
    c_hand = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
              for k, v in c_hand.items()}
    tips = ref_contact.tips_in_object_frame(c_hand["mano_joints"].detach().float(),
                                            a["mano"][:, :3], a["wrist"], a["pc_ply"])
    sample, occ = ref_contact.fingertip_gated_sample(
        a["points"], a["occ"], tips, a["touch_success"], num_sample, tips_per_finger, gen)
    feats = ref_contact.scatter_finger_features(c_img.float(), sample, init="zeros")
    with amp():
        logits = ref.decode_img(sample.points, c, feats)
    terms = {"loss_l1": torch.mean(torch.abs(logits.float() - occ)),
             "loss_mano": torch.mean((c_hand["mano_param"].float() - a["mano"]) ** 2),
             "loss_pc": torch.mean((c_hand["mano_verts"].float() - a["pc_hand"]) ** 2)}
    terms["loss"] = terms["loss_l1"] + terms["loss_mano"] + terms["loss_pc"]
    return terms


def reference_steps(ctx, cfg, drawn, batches, autocast=False, count_flops=False):
    """The reference's scalars per step, its first gradient, its
    parameters after the steps and (``count_flops``) the FLOPs of one
    forward."""
    dev = ctx.device
    ref = ref_model.build(cfg)
    weights.load(ref, drawn, strict_names=False)
    ref = ref.to(dev).train()
    t = cfg["training"]
    opt = torch.optim.Adam(ref.parameters(), lr=t["lr"], betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (1 << 63))
    num_sample = cfg["data"]["num_sample"]
    tips_per_finger = ctx.traffic["tips_per_finger"]
    scalars, grad1, flops = [], None, None
    amp = (lambda: torch.autocast("cuda", dtype=torch.bfloat16)) if autocast \
        else contextlib.nullcontext
    set_tf32(t.get("matmul_precision", "default") not in IEEE)
    try:
        for i, batch in enumerate(batches):
            a = tensors(batch, dev)
            if count_flops and i == 0:
                terms, flops = model_flops(loss_img, ref, a, gen, num_sample,
                                           tips_per_finger, amp)
            else:
                terms = loss_img(ref, a, gen, num_sample, tips_per_finger, amp)
            opt.zero_grad(set_to_none=True)
            terms["loss"].float().backward()
            if i == 0:
                grad1 = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                         for k, p in ref.named_parameters()}
            opt.step()
            scalars.append({k: float(v.detach()) for k, v in terms.items()})
    finally:
        set_tf32(False)
    params = {k: v.detach().clone() for k, v in ref.named_parameters()}
    return scalars, grad1, params, flops


def leaf_gap(prog, ref, keep=None):
    """(the worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref leaf‖, median
    ‖ref leaf‖), that leaf's name), over the leaves in ``keep`` (all by
    default)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    med = float(np.median(list(norms.values()))) if norms else 0.0
    worst, leaf = 0.0, None
    for k in names:
        gap = abs(float(torch.linalg.vector_norm(prog[k].float())) - norms[k])
        gap /= max(norms[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def numbers(prog_scalars, grad1, params3, ref_scalars, ref_grad1, ref_params3, drawn):
    out, steps = {}, {}
    for term in TERMS:
        gaps = [abs(p[term] - r[term]) / max(abs(r[term]), 1e-30)
                for p, r in zip(prog_scalars, ref_scalars)]
        out[term], steps[term] = gaps[0], gaps
    shared = [k for k in ref_grad1 if k in grad1]
    out["grad1"], worst = leaf_gap({k: grad1[k] for k in shared},
                                   {k: ref_grad1[k] for k in shared})
    gnorm = {k: float(torch.linalg.vector_norm(ref_grad1[k].float())) for k in shared}
    med = float(np.median(list(gnorm.values())))
    moving = {k for k in shared if gnorm[k] >= 1e-3 * med}
    change = {k: params3[k] - drawn[k] for k in shared}
    ref_change = {k: ref_params3[k] - drawn[k] for k in shared}
    out["change3"], worst_change = leaf_gap(change, ref_change, moving)
    return out, {"leaves_moving": len(moving), "leaves": len(shared),
                 "worst_grad1_leaf": worst, "worst_change3_leaf": worst_change,
                 "loss_gaps_by_step": steps}


def judge(ctx, cfg, drawn, batches, scalars, grad1, params3):
    lim = limits(ctx.cell)
    ref_scalars, ref_grad1, ref_params3, flops = reference_steps(ctx, cfg, drawn, batches,
                                                                 count_flops=True)
    nums, leaves = numbers(scalars, grad1, params3, ref_scalars, ref_grad1, ref_params3,
                           drawn)
    print("train check: " + json.dumps(leaves), file=sys.stderr)
    checks = {n: [nums[n], lim[n]] for n in NAMES}
    return {"checks": checks, "record": dict(leaves, forward_flops=flops)}
